// Dequant GEMMs for RaanA-quantized linears (Hopper), two C entries:
//
//   rht_qmatmul: Y = practical_rht(X) @ (r * (codes - c_b))
//                  = (X_rot @ codes - c_b * rowsum(X_rot)) * r
//   qmatmul:     Y = (X_rot @ codes - c_b * rowsum(X_rot)) * r, X_rot given
//
// Both take `groups` experts of n rows each (groups = 1: one linear).  The
// grouped form replaces the reference's jax.vmap over experts of the same
// Pallas kernels (repro/kernels/qmatmul/ops.py:121,
// grouped_rht_quantized_matmul): the experts share the signs, so the
// rotation runs once over all groups*n rows, and the GEMM folds the expert
// index into blockIdx.y beside the row blocks; expert e reads
// packed + e*prow*c, x_rot rows [e*n, e*n + n) and rescale[e*c, e*c + c).
//
// rht_qmatmul replaces repro/kernels/qmatmul/qmatmul.py:
// rht_quantized_matmul_pallas (_fused_kernel, _rht_rows, _unpack_tile);
// qmatmul replaces quantized_matmul_pallas (_kernel), the second half of the
// reference's unfused A/B pair.  The Pallas fused kernel rotates once at
// grid step (j=0, k=0) and keeps the rotated row tile in VMEM across the
// sequential grid; CTAs on the H100 run concurrently and the rotated tile
// (351 KB at n=8, d=10974) does not fit a block's shared memory, so
// rht_qmatmul launches, on one stream:
//
//   1. fwht::rotate_kernel (fwht.cuh): one CTA per row under the host's
//      plan (threads, values per thread; hadamard/ops.py:rotate_plan), the
//      sign flip on load and the Alg. 5 butterflies in registers, warp
//      shuffles and one shared-memory transpose per block; writes x_rot f32
//      with its rows padded with zeros to a multiple of 64 (16-byte aligned
//      rows for cp.async; the zeros cancel the pad codes, since code 0 - c_b
//      is not 0), and rowsum in f32, in a fixed order.  qmatmul launches
//      rowsum_kernel instead, which writes the padded copy of its given
//      x_rot.
//   2. dequant_gemm_kernel computes Y^T = codes^T X_rot^T on mma.sync.m16n8k16
//      (bf16 in, f32 accumulate): M = 256 code columns per CTA (32 per warp
//      of 8), N = every row of the group up to 64 (8 per instruction; a
//      decode step's 8 slots are one n-tile, a prefill chunk's 64 rows
//      eight, Mixtral's C = 20 three, zero-padded), K = d in 64-value
//      chunks, split across CTAs where the columns alone leave SMs idle.
//      Code and x chunks go through a 3-stage cp.async ring in shared
//      memory; each x chunk is then cut once per CTA into three bf16 planes,
//      hi + mid + lo = x exactly (split3), and the codes are unpacked in
//      registers straight into A fragments.  Codes are integers 0-255, exact
//      in bf16, and a bf16 x bf16 product is exact in f32, so the three
//      products per code fragment (one per plane) give the f32 product; only
//      the f32 summation order differs from the plain version.  Each code
//      byte is read from HBM and unpacked once per CTA, and x is read from
//      L2 as f32 once per 256 columns.  The K slots of an m16n8k16 step are
//      permuted so that a thread's four K values are four consecutive d
//      indices (a 64-bit load of a plane row; one byte of 2-bit codes), and
//      the M slots so that a thread's columns are four adjacent ones (one
//      32-bit load per packed row, one float4 store per output row).
//   3. splitk_epilogue: sums the splits in a fixed order (deterministic, so
//      greedy tokens do not vary run to run) and applies
//      (acc - c_b * rowsum) * float(rescale_f16).
//
// What bounds it on this card: at decode (n <= 8) the packed-code bytes
// (4 bits, d 4083, c 4096: 8.4 MB, 2.5 us); at a 64-row prefill chunk the
// three bf16 products (6.4 GFLOP at 989 TFLOP/s, 6.5 us); at Mixtral's
// C = 20 the two are of one order.  Code rows are read in 16-byte chunks,
// so c must be a multiple of 16 (every model linear's is).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fwht.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kSumThreads = 256;

__global__ void splitk_epilogue_kernel(const float* __restrict__ partial,
                                       const float* __restrict__ rowsum,
                                       const __half* __restrict__ rescale,
                                       float* __restrict__ out, int n,
                                       int groups, int c, int splits,
                                       float c_b) {
  // rows are groups x n; row i belongs to expert i / n
  const size_t total = (size_t)groups * n * c;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * total + idx];
    const int i = (int)(idx / c), j = (int)(idx % c);
    out[idx] = (acc - c_b * rowsum[i]) *
               __half2float(rescale[(size_t)(i / n) * c + j]);
  }
}

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32 * kWarps;         // code columns per CTA
constexpr int kChunk = 64;                 // d values per staged chunk
constexpr int kStages = 3;                 // cp.async ring depth
constexpr int kCodeStride = kCols + 16;    // bytes per staged packed row
constexpr int kXStride = kChunk + 4;       // floats per staged x row
constexpr int kPlaneStride = kChunk + 16;  // bf16 per plane row

// x = hi + mid + lo exactly (normal f32 values), each part returned as bf16
// bits: hi keeps x's top 8 significant bits (truncation), mid the next 8 of
// the remainder, lo the rest (at most 8 significant bits, so exact in bf16).
// kernels/qmatmul/ref.py:split_planes is its plain twin.
__device__ inline void split3(float x, uint32_t& hi, uint32_t& mid,
                              uint32_t& lo) {
  const uint32_t h = __float_as_uint(x) & 0xFFFF0000u;
  const float r = x - __uint_as_float(h);          // exact
  const uint32_t m = __float_as_uint(r) & 0xFFFF0000u;
  hi = h >> 16;
  mid = m >> 16;
  lo = __float_as_uint(r - __uint_as_float(m)) >> 16;   // exact
}

// bf16x2 bits of codes at bits 0-6 and 16-22 of v (the rest zero): bf16
// bits 0x4300 | c are 128 + c exactly, less 128.
__device__ inline uint32_t small_pair(uint32_t v) {
  const uint32_t biased = v | 0x43004300u;
  const __nv_bfloat162 h =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
              __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<const uint32_t*>(&h);
}
// bf16x2 bits of byte q of w0 (low half) and of w1: codes 0-255, exact
// through f32 (0x4B0000cc is 2^23 + c).
__device__ inline uint32_t byte_pair(uint32_t w0, uint32_t w1, int q) {
  const float f0 = __uint_as_float(__byte_perm(w0, 0x4B000000u, 0x7540 | q));
  const float f1 = __uint_as_float(__byte_perm(w1, 0x4B000000u, 0x7540 | q));
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(f0 - 8388608.f, f1 - 8388608.f);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// byte q of x at bits 0-7 and byte q of y at bits 16-23
__device__ inline uint32_t spread(uint32_t x, uint32_t y, int q) {
  return __byte_perm(x, y, q | (q + 4) << 8);
}

// A fragments of the warp's two m-tiles for k16 step ks of a staged chunk.
// Thread (g = lane/4, t = lane%4) owns code columns 4g..4g+3 of the warp
// (m-tile mt's rows g and g+8 are columns 4g+2mt and 4g+2mt+1) and d
// offsets 16ks + 4t + i, i = 0..3 (K slots 2t+e and 2t+8+e are offsets
// 4t+e and 4t+2+e), so register 0/1 of an m-tile holds offsets (0, 1) and
// register 2/3 offsets (2, 3) of one column.  A codes word holds one byte
// per column; spread() puts column q's byte of two words side by side, and
// for packed widths the second word is the first shifted by one field, so
// one mask cuts out two adjacent codes of the column.  BITS 7 stands for
// every width stored one code per byte below 8 (3, 5, 6, 7): codes < 128.
template <int BITS>
__device__ inline void load_codes(const uint8_t* cs, int ks, int t,
                                  uint32_t (&a)[2][4]) {
  auto row = [&](int r) {
    return *reinterpret_cast<const uint32_t*>(cs + r * kCodeStride);
  };
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t p01, p23;               // offsets (0, 1) and (2, 3) of column q
    if constexpr (BITS >= 7) {       // rows 16ks + 4t + i
      const uint32_t w0 = row(16 * ks + 4 * t), w1 = row(16 * ks + 4 * t + 1);
      const uint32_t w2 = row(16 * ks + 4 * t + 2), w3 = row(16 * ks + 4 * t + 3);
      if constexpr (BITS == 8) {
        p01 = byte_pair(w0, w1, q);
        p23 = byte_pair(w2, w3, q);
      } else {
        p01 = small_pair(spread(w0, w1, q) & 0x007F007Fu);
        p23 = small_pair(spread(w2, w3, q) & 0x007F007Fu);
      }
    } else if constexpr (BITS == 4) {  // rows 8ks + 2t + i/2, nibble i%2
      const uint32_t w0 = row(8 * ks + 2 * t), w1 = row(8 * ks + 2 * t + 1);
      p01 = small_pair(spread(w0, w0 >> 4, q) & 0x000F000Fu);
      p23 = small_pair(spread(w1, w1 >> 4, q) & 0x000F000Fu);
    } else if constexpr (BITS == 2) {  // row 4ks + t, field i
      const uint32_t w = row(4 * ks + t);
      const uint32_t v = spread(w, w >> 2, q);
      p01 = small_pair(v & 0x00030003u);
      p23 = small_pair((v >> 4) & 0x00030003u);
    } else {                           // row 2ks + t/2, bit 4(t%2) + i
      const uint32_t w = row(2 * ks + (t >> 1)) >> (4 * (t & 1));
      const uint32_t v = spread(w, w >> 1, q);
      p01 = small_pair(v & 0x00010001u);
      p23 = small_pair((v >> 2) & 0x00010001u);
    }
    a[q >> 1][q & 1] = p01;            // m-tile q/2, row g (q even) or g+8
    a[q >> 1][2 + (q & 1)] = p23;
  }
}

// Shared memory: kStages x (codes, x) chunks, then one chunk of planes.
template <int BITS, int NT>
struct GemmSmem {
  static constexpr int PER = BITS <= 2 ? 8 / BITS : BITS == 4 ? 2 : 1;
  static constexpr int kCodeBytes = (kChunk / PER) * kCodeStride;
  static constexpr int kXBytes = 8 * NT * kXStride * 4;
  static constexpr int kStageBytes = kCodeBytes + kXBytes;
  static constexpr int kPlaneElems = 8 * NT * kPlaneStride;   // per plane
  static constexpr int kBytes = kStages * kStageBytes + 3 * kPlaneElems * 2;
};

// One CTA: 256 code columns of one expert x every row of one 8*NT-row block
// (the whole group when n <= 64) x one split of the 64-value d chunks.
// xrot (groups*n, x_ld) f32, zero past d; partial (splits, groups*n, c).
template <int BITS, int NT>
__global__ void __launch_bounds__(kThreads)
dequant_gemm_kernel(const float* __restrict__ xrot,
               const uint8_t* __restrict__ packed, float* __restrict__ partial,
               int n, int d, int c, int x_ld, int chunks_per_split,
               int row_blocks) {
  using L = GemmSmem<BITS, NT>;
  constexpr int PER = L::PER;                    // codes per byte
  constexpr int NP = 8 * NT;                     // rows of the block
  constexpr int kCodeRows = kChunk / PER;          // packed rows per chunk
  extern __shared__ __align__(16) uint8_t gemm_smem[];
  uint16_t* planes =
      reinterpret_cast<uint16_t*>(gemm_smem + kStages * L::kStageBytes);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kCols;
  const int group = blockIdx.y / row_blocks;
  const int r0 = (blockIdx.y % row_blocks) * NP;
  const int groups = gridDim.y / row_blocks;
  const int prow = (d + PER - 1) / PER;
  const int ch0 = blockIdx.z * chunks_per_split;
  const int nch = min(chunks_per_split, x_ld / kChunk - ch0);
  const uint8_t* codes = packed + (size_t)group * prow * c;
  const float* xg = xrot + (size_t)group * n * x_ld;

  auto load_stage = [&](int stage, int ch) {
    uint8_t* cs = gemm_smem + stage * L::kStageBytes;
    float* xs = reinterpret_cast<float*>(cs + L::kCodeBytes);
    for (int idx = threadIdx.x; idx < kCodeRows * (kCols / 16);
         idx += kThreads) {
      const int r = idx / (kCols / 16), q = idx % (kCols / 16);
      const int pr = ch * kCodeRows + r, col = j0 + 16 * q;
      const bool ok = pr < prow && col < c;   // c % 16 == 0 (wrapper)
      tc::cp_async16(cs + r * kCodeStride + 16 * q,
                 ok ? codes + (size_t)pr * c + col : packed, ok);
    }
    for (int idx = threadIdx.x; idx < NP * (kChunk / 4); idx += kThreads) {
      const int row = idx / (kChunk / 4), q = idx % (kChunk / 4);
      const bool ok = r0 + row < n;
      tc::cp_async16(xs + row * kXStride + 4 * q,
                 ok ? xg + (size_t)(r0 + row) * x_ld + ch * kChunk + 4 * q
                    : xrot,
                 ok);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nch) load_stage(s, ch0 + s);
    tc::cp_async_commit();
  }
  for (int it = 0; it < nch; ++it) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();    // chunk it landed; stage it-1 and the planes are free
    if (it + kStages - 1 < nch)
      load_stage((it + kStages - 1) % kStages, ch0 + it + kStages - 1);
    tc::cp_async_commit();
    const uint8_t* cs = gemm_smem + (it % kStages) * L::kStageBytes;
    // cut the x chunk into the planes, 4 values per step
    const float* xs = reinterpret_cast<const float*>(cs + L::kCodeBytes);
    for (int idx = threadIdx.x; idx < NP * (kChunk / 4); idx += kThreads) {
      const int row = idx / (kChunk / 4), q = idx % (kChunk / 4);
      const float4 v =
          *reinterpret_cast<const float4*>(xs + row * kXStride + 4 * q);
      uint32_t h[4], m[4], l[4];
      split3(v.x, h[0], m[0], l[0]);
      split3(v.y, h[1], m[1], l[1]);
      split3(v.z, h[2], m[2], l[2]);
      split3(v.w, h[3], m[3], l[3]);
      uint16_t* dst = planes + row * kPlaneStride + 4 * q;
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
      *reinterpret_cast<uint2*>(dst + L::kPlaneElems) =
          make_uint2(m[0] | m[1] << 16, m[2] | m[3] << 16);
      *reinterpret_cast<uint2*>(dst + 2 * L::kPlaneElems) =
          make_uint2(l[0] | l[1] << 16, l[2] | l[3] << 16);
    }
    __syncthreads();
    cs += 32 * warp + 4 * g;
    const uint16_t* ps = planes + g * kPlaneStride + 4 * t;
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      uint32_t a[2][4];
      load_codes<BITS>(cs, ks, t, a);
#pragma unroll
      for (int pl = 0; pl < 3; ++pl)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 b = *reinterpret_cast<const uint2*>(
              ps + pl * L::kPlaneElems + nt * 8 * kPlaneStride + 16 * ks);
          tc::mma_bf16(acc[0][nt], a[0], b.x, b.y);
          tc::mma_bf16(acc[1][nt], a[1], b.x, b.y);
        }
    }
  }
  tc::cp_async_wait<0>();

  // accumulator (mt, nt): e = 0/1 -> column 4g + 2mt, rows 2t / 2t+1 of the
  // n-tile; e = 2/3 -> column 4g + 2mt + 1
  const int col = j0 + 32 * warp + 4 * g;
  if (col >= c) return;
  float* dst = partial + ((size_t)blockIdx.z * groups + group) * n * c + col;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * nt + 2 * t + r;
      if (row < n)
        *reinterpret_cast<float4*>(dst + (size_t)row * c) =
            make_float4(acc[0][nt][r], acc[0][nt][2 + r], acc[1][nt][r],
                        acc[1][nt][2 + r]);
    }
}

template <int BITS, int NT>
cudaError_t launch_gemm(dim3 grid, const float* xrot, const uint8_t* packed,
                      float* partial, int n, int d, int c, int x_ld, int cps,
                      int row_blocks, cudaStream_t st) {
  constexpr int bytes = GemmSmem<BITS, NT>::kBytes;
  // opt in every time: past 48 KB a launch without the attribute is refused
  cudaError_t e = cudaFuncSetAttribute(
      dequant_gemm_kernel<BITS, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  dequant_gemm_kernel<BITS, NT><<<grid, kThreads, bytes, st>>>(
      xrot, packed, partial, n, d, c, x_ld, cps, row_blocks);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_gemm_nt(int nt, dim3 grid, const float* xrot,
                         const uint8_t* packed, float* partial, int n, int d,
                         int c, int x_ld, int cps, int rb, cudaStream_t st) {
  switch (nt) {
    case 1: return launch_gemm<BITS, 1>(grid, xrot, packed, partial, n, d, c, x_ld, cps, rb, st);
    case 2: return launch_gemm<BITS, 2>(grid, xrot, packed, partial, n, d, c, x_ld, cps, rb, st);
    case 3: return launch_gemm<BITS, 3>(grid, xrot, packed, partial, n, d, c, x_ld, cps, rb, st);
    case 4: return launch_gemm<BITS, 4>(grid, xrot, packed, partial, n, d, c, x_ld, cps, rb, st);
    case 8: return launch_gemm<BITS, 8>(grid, xrot, packed, partial, n, d, c, x_ld, cps, rb, st);
    default: return cudaErrorInvalidValue;
  }
}

// rowsum[row] = sum(x[row]) for the unfused entry, whose x is already
// rotated: one CTA per row, summed in a fixed order (deterministic); the
// row is also copied into xpad, row stride x_ld, zeros past d.
__global__ void __launch_bounds__(kSumThreads)
rowsum_kernel(const float* __restrict__ x, float* __restrict__ rowsum,
              float* __restrict__ xpad, int d, int x_ld) {
  __shared__ float warp_sums[kSumThreads / 32];
  const float* src = x + (size_t)blockIdx.x * d;
  float part = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) part += __ldg(src + i);
  for (int i = threadIdx.x; i < x_ld; i += blockDim.x)
    xpad[(size_t)blockIdx.x * x_ld + i] = i < d ? __ldg(src + i) : 0.f;
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kSumThreads / 32; ++w) s += warp_sums[w];
    rowsum[blockIdx.x] = s;
  }
}

// The GEMM over groups x n rows of xrot (row stride x_ld, a multiple of 64,
// zeros past d), then the fixed-order reduction of the splits and the
// Alg. 3 epilogue.  n_tiles: 8-row n-tiles per CTA; chunks_per_split:
// 64-value d chunks per split.
cudaError_t launch_gemm_epilogue(const float* xrot, const float* rowsum,
                                 const uint8_t* packed, const __half* rescale,
                                 float* partial, float* out, int n,
                                 int groups, int d, int c, int bits,
                                 int n_tiles, int chunks_per_split,
                                 int splits, int x_ld, cudaStream_t st) {
  const int row_blocks = (n + 8 * n_tiles - 1) / (8 * n_tiles);
  if (bits < 1 || bits > 8 || splits < 1 || splits > 65535 || c % 16 ||
      x_ld % kChunk || x_ld < d || (long long)groups * row_blocks > 65535)
    return cudaErrorInvalidValue;
  dim3 grid((c + kCols - 1) / kCols, groups * row_blocks, splits);
  const int cps = chunks_per_split;
  cudaError_t e;
  switch (bits) {   // 3, 5, 6 and 7 bits share the one-code-per-byte layout
    case 1: e = launch_gemm_nt<1>(n_tiles, grid, xrot, packed, partial, n, d, c, x_ld, cps, row_blocks, st); break;
    case 2: e = launch_gemm_nt<2>(n_tiles, grid, xrot, packed, partial, n, d, c, x_ld, cps, row_blocks, st); break;
    case 4: e = launch_gemm_nt<4>(n_tiles, grid, xrot, packed, partial, n, d, c, x_ld, cps, row_blocks, st); break;
    case 8: e = launch_gemm_nt<8>(n_tiles, grid, xrot, packed, partial, n, d, c, x_ld, cps, row_blocks, st); break;
    default: e = launch_gemm_nt<7>(n_tiles, grid, xrot, packed, partial, n, d, c, x_ld, cps, row_blocks, st); break;
  }
  if (e != cudaSuccess) return e;

  const float c_b = (float)((1 << bits) - 1) / 2.0f;
  const size_t total = (size_t)groups * n * c;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  splitk_epilogue_kernel<<<blocks, 256, 0, st>>>(partial, rowsum, rescale, out,
                                                 n, groups, c, splits, c_b);
  return cudaGetLastError();
}

}  // namespace

// Fused: Y = practical_rht(x) @ (r * (codes - c_b)) for groups experts of n
// rows each (x: groups*n rows; packed: groups slabs of prow x c; rescale:
// groups x c).  xrot (groups*n rows of x_ld), rowsum and partial are
// scratch; (rot_threads, rot_per_thread) is the rotation's plan.
extern "C" int rht_qmatmul(const float* x, const float* signs1,
                           const float* signs2, const uint8_t* packed,
                           const __half* rescale, float* xrot, float* rowsum,
                           float* partial, float* out, int n, int groups,
                           int d, int d_hat, int c, int bits, int n_tiles,
                           int chunks_per_split, int splits, int x_ld,
                           int rot_threads, int rot_per_thread,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = fwht::launch_rotate(x, signs1, signs2, xrot, rowsum,
                                      groups * n, d, d_hat, x_ld, rot_threads,
                                      rot_per_thread, st);
  if (e != cudaSuccess) return e;
  return launch_gemm_epilogue(xrot, rowsum, packed, rescale, partial, out, n,
                              groups, d, c, bits, n_tiles, chunks_per_split,
                              splits, x_ld, st);
}

// Unfused second half: Y = (xrot @ codes - c_b * rowsum(xrot)) * r on an
// already-rotated xrot (rows of d).  Replaces repro/kernels/qmatmul/
// qmatmul.py:quantized_matmul_pallas (_kernel).  xpad (the padded copy of
// xrot, rows of x_ld), rowsum and partial are scratch.
extern "C" int qmatmul(const float* xrot, const uint8_t* packed,
                       const __half* rescale, float* xpad, float* rowsum,
                       float* partial, float* out, int n, int groups, int d,
                       int c, int bits, int n_tiles, int chunks_per_split,
                       int splits, int x_ld, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rowsum_kernel<<<groups * n, kSumThreads, 0, st>>>(xrot, rowsum, xpad, d,
                                                    x_ld);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_gemm_epilogue(xpad, rowsum, packed, rescale, partial, out, n,
                              groups, d, c, bits, n_tiles, chunks_per_split,
                              splits, x_ld, st);
}
