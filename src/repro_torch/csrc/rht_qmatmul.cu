// Fused practical RHT + dequant GEMM for RaanA-quantized linears (Hopper).
//
//   Y = practical_rht(X) @ (r * (codes - c_b))
//     = (X_rot @ codes - c_b * rowsum(X_rot)) * r
//
// Replaces repro/kernels/qmatmul/qmatmul.py:rht_quantized_matmul_pallas
// (_fused_kernel, _rht_rows, _unpack_tile).  The Pallas kernel rotates once at
// grid step (j=0, k=0) and keeps the rotated row tile in VMEM across the
// sequential grid; CTAs on the H100 run concurrently and the rotated tile
// (351 KB at n=8, d=10974) does not fit a block's shared memory, so this
// file launches, on one stream:
//
//   1. rht_rotate: one CTA per row.  Sign flip with signs1, in-shared-memory
//      butterfly FWHT over [0, d_hat), scale 1/sqrt(d_hat); for d not a
//      power of 2 (Alg. 5) the same with signs2 over [d - d_hat, d).  The
//      butterfly computes the Sylvester H_{d_hat} = H_{d1} (x) H_{d2}, equal
//      to the reference's Kronecker matmuls up to rounding.  Writes x_rot
//      (n, d) f32 and rowsum (n,) to scratch.
//   2. dequant_gemm: CTA tile = BN rows x 128 columns x one split of the
//      packed rows; its 8 warps share the columns and take interleaved
//      packed rows, and sum their partials through shared memory in a fixed
//      order.  Each thread owns 4 adjacent columns, reads their packed bytes
//      as one 32-bit word (coalesced along c), 8 rows in flight at once,
//      unpacks 8/b codes per byte in registers (one code per byte for b in
//      {3,5,6,7}) and runs f32 FMAs against x_rot staged in shared memory.
//      The k loop stops at k < d, never at rows * per: the last packed byte
//      may hold pad codes, and code 0 - c_b is not 0.
//   3. splitk_epilogue: sums the splits in a fixed order (deterministic) and
//      applies (acc - c_b * rowsum) * float(rescale_f16).
//
// What bounds it: packed-code bytes and f32 FMAs are of one order at decode
// (n <= 8); f32 FMAs at prefill (n = 64).  The x_rot round trip is n*d*8
// bytes, about 3% of the 4-bit codes of the same layer.  Tensor cores
// (wgmma), TMA and a fused rotation are later work.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kGemmThreads = 32 * kWarps;
constexpr int kCols = 4;            // columns per thread (one 4-byte load)
constexpr int kColsPerCta = 32 * kCols;
constexpr int kKChunk = 512;        // d values of x_rot staged per pass
constexpr int kBatch = 8;           // packed rows a thread loads at once
constexpr int kRotThreads = 512;

// Global loads issued kRotBatch at a time per thread, so a row costs a few
// memory latencies rather than one per element a thread touches.
constexpr int kRotBatch = 8;

__device__ void load_row(float* dst, const float* __restrict__ src, int n) {
  for (int base = 0; base < n; base += kRotBatch * blockDim.x) {
    float tmp[kRotBatch];
#pragma unroll
    for (int u = 0; u < kRotBatch; ++u) {
      const int i = base + u * blockDim.x + threadIdx.x;
      tmp[u] = i < n ? __ldg(src + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kRotBatch; ++u) {
      const int i = base + u * blockDim.x + threadIdx.x;
      if (i < n) dst[i] = tmp[u];
    }
  }
}

// In-place sign flip, unnormalized butterfly H_n and 1/sqrt(n) scale of v[0, n)
// (n a power of 2); signs_s already sits in shared memory.
__device__ void fwht_block(float* v, const float* signs_s, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] *= signs_s[i];
  __syncthreads();
  int lg = 0;
  for (int h = 1; h < n; h <<= 1, ++lg) {
    for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
      const int i = ((p >> lg) << (lg + 1)) | (p & (h - 1));
      const float a = v[i], b = v[i + h];
      v[i] = a + b;
      v[i + h] = a - b;
    }
    __syncthreads();
  }
  const float scale = 1.0f / sqrtf((float)n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] *= scale;
  __syncthreads();
}

__global__ void rht_rotate_kernel(const float* __restrict__ x,
                                  const float* __restrict__ signs1,
                                  const float* __restrict__ signs2,
                                  float* __restrict__ xrot,
                                  float* __restrict__ rowsum, int d,
                                  int d_hat) {
  extern __shared__ float smem[];
  float* sx = smem;                   // d
  float* s1 = sx + d;                 // d_hat
  float* s2 = s1 + d_hat;             // d_hat when d is not a power of 2
  __shared__ float warp_sums[kRotThreads / 32];
  const size_t row = blockIdx.x;
  load_row(sx, x + row * d, d);
  load_row(s1, signs1, d_hat);
  if (d_hat != d) load_row(s2, signs2, d_hat);
  __syncthreads();
  fwht_block(sx, s1, d_hat);
  if (d_hat != d) fwht_block(sx + (d - d_hat), s2, d_hat);
  float part = 0.f;
  float* out = xrot + row * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    out[i] = sx[i];
    part += sx[i];
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += warp_sums[w];
    rowsum[row] = s;
  }
}

template <int BITS, int BN>
__global__ void __launch_bounds__(kGemmThreads)
dequant_gemm_kernel(const float* __restrict__ xrot,
                    const uint8_t* __restrict__ packed,
                    float* __restrict__ partial, int n, int d, int c,
                    int rows_per_split) {
  constexpr int kPer = (BITS == 1 || BITS == 2 || BITS == 4 || BITS == 8)
                           ? 8 / BITS : 1;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  __shared__ __align__(16) float xs[kKChunk][BN];
  __shared__ float red[kWarps - 1][BN * kCols][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kColsPerCta + lane * kCols;
  const int row0 = blockIdx.y * BN;
  const int prow = (d + kPer - 1) / kPer;
  const int pr0 = blockIdx.z * rows_per_split;
  const int pr1 = min(pr0 + rows_per_split, prow);
  const int k0 = pr0 * kPer;
  const int k1 = min(pr1 * kPer, d);
  const bool vec = (c & 3) == 0 && col0 + kCols <= c;
  float acc[BN][kCols];
#pragma unroll
  for (int i = 0; i < BN; ++i)
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[i][q] = 0.f;

  for (int kc = k0; kc < k1; kc += kKChunk) {
    const int klen = min(kKChunk, k1 - kc);
    for (int t = threadIdx.x; t < kKChunk * BN; t += kGemmThreads) {
      const int i = t / kKChunk, kk = t % kKChunk;
      xs[kk][i] = (row0 + i < n && kk < klen)
                      ? xrot[(size_t)(row0 + i) * d + kc + kk] : 0.f;
    }
    __syncthreads();
    if (col0 < c) {
      const int r_begin = kc / kPer;              // kc is a multiple of kPer
      const int r_end = (kc + klen + kPer - 1) / kPer;
      // warp w takes packed rows r = r_begin + w (mod kWarps); each thread
      // issues kBatch independent 4-byte loads before using any of them
      for (int rb = r_begin + warp; rb < r_end; rb += kWarps * kBatch) {
        uint32_t words[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int r = rb + b * kWarps;
          words[b] = 0;
          if (r < r_end) {
            const uint8_t* src = packed + (size_t)r * c + col0;
            if (vec) {
              words[b] = __ldg(reinterpret_cast<const uint32_t*>(src));
            } else {
              for (int q = 0; q < kCols; ++q)
                if (col0 + q < c) words[b] |= (uint32_t)__ldg(src + q) << (8 * q);
            }
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int r = rb + b * kWarps;
#pragma unroll
          for (int s = 0; s < kPer; ++s) {
            // stop at k < d: the last packed byte may hold pad codes
            const int kk = (r - r_begin) * kPer + s;
            if (r < r_end && kk < klen) {
              float xv[BN];
#pragma unroll
              for (int i = 0; i < BN; ++i) xv[i] = xs[kk][i];
#pragma unroll
              for (int q = 0; q < kCols; ++q) {
                const float code =
                    (float)((words[b] >> (8 * q + s * BITS)) & kMask);
#pragma unroll
                for (int i = 0; i < BN; ++i)
                  acc[i][q] = fmaf(xv[i], code, acc[i][q]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }
  // reduce the warps' partial sums in a fixed order (deterministic)
  if (warp > 0) {
#pragma unroll
    for (int i = 0; i < BN; ++i)
#pragma unroll
      for (int q = 0; q < kCols; ++q) red[warp - 1][i * kCols + q][lane] = acc[i][q];
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 0; w < kWarps - 1; ++w)
#pragma unroll
    for (int i = 0; i < BN; ++i)
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[i][q] += red[w][i * kCols + q][lane];
  float* dst = partial + (size_t)blockIdx.z * n * c;
#pragma unroll
  for (int i = 0; i < BN; ++i) {
    if (row0 + i >= n) break;
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      if (col0 + q < c) dst[(size_t)(row0 + i) * c + col0 + q] = acc[i][q];
  }
}

__global__ void splitk_epilogue_kernel(const float* __restrict__ partial,
                                       const float* __restrict__ rowsum,
                                       const __half* __restrict__ rescale,
                                       float* __restrict__ out, int n, int c,
                                       int splits, float c_b) {
  const size_t total = (size_t)n * c;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * total + idx];
    const int i = (int)(idx / c), j = (int)(idx % c);
    out[idx] = (acc - c_b * rowsum[i]) * __half2float(rescale[j]);
  }
}

template <int BITS>
cudaError_t launch_gemm_bits(int bn, dim3 grid, const float* xrot,
                             const uint8_t* packed, float* partial, int n,
                             int d, int c, int rps, cudaStream_t st) {
  switch (bn) {
    case 1: dequant_gemm_kernel<BITS, 1><<<grid, kGemmThreads, 0, st>>>(xrot, packed, partial, n, d, c, rps); break;
    case 2: dequant_gemm_kernel<BITS, 2><<<grid, kGemmThreads, 0, st>>>(xrot, packed, partial, n, d, c, rps); break;
    case 4: dequant_gemm_kernel<BITS, 4><<<grid, kGemmThreads, 0, st>>>(xrot, packed, partial, n, d, c, rps); break;
    case 8: dequant_gemm_kernel<BITS, 8><<<grid, kGemmThreads, 0, st>>>(xrot, packed, partial, n, d, c, rps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int rht_qmatmul(const float* x, const float* signs1,
                           const float* signs2, const uint8_t* packed,
                           const __half* rescale, float* xrot, float* rowsum,
                           float* partial, float* out, int n, int d, int d_hat,
                           int c, int bits, int bn, int rows_per_split,
                           int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      (size_t)(d + (d_hat != d ? 2 : 1) * d_hat) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rht_rotate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  rht_rotate_kernel<<<n, kRotThreads, smem, st>>>(x, signs1, signs2, xrot,
                                                  rowsum, d, d_hat);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int col_tiles = (c + kColsPerCta - 1) / kColsPerCta;
  dim3 grid(col_tiles, (n + bn - 1) / bn, splits);
  switch (bits) {
    case 1: e = launch_gemm_bits<1>(bn, grid, xrot, packed, partial, n, d, c, rows_per_split, st); break;
    case 2: e = launch_gemm_bits<2>(bn, grid, xrot, packed, partial, n, d, c, rows_per_split, st); break;
    case 3: e = launch_gemm_bits<3>(bn, grid, xrot, packed, partial, n, d, c, rows_per_split, st); break;
    case 4: e = launch_gemm_bits<4>(bn, grid, xrot, packed, partial, n, d, c, rows_per_split, st); break;
    case 5: e = launch_gemm_bits<5>(bn, grid, xrot, packed, partial, n, d, c, rows_per_split, st); break;
    case 6: e = launch_gemm_bits<6>(bn, grid, xrot, packed, partial, n, d, c, rows_per_split, st); break;
    case 7: e = launch_gemm_bits<7>(bn, grid, xrot, packed, partial, n, d, c, rows_per_split, st); break;
    case 8: e = launch_gemm_bits<8>(bn, grid, xrot, packed, partial, n, d, c, rows_per_split, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;

  const float c_b = (float)((1 << bits) - 1) / 2.0f;
  const size_t total = (size_t)n * c;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  splitk_epilogue_kernel<<<blocks, 256, 0, st>>>(partial, rowsum, rescale, out,
                                                 n, c, splits, c_b);
  return cudaGetLastError();
}
