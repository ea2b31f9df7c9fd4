// Dequant GEMMs for RaanA-quantized linears (Hopper), two C entries:
//
//   rht_qmatmul: Y = practical_rht(X) @ (r * (codes - c_b))
//                  = (X_rot @ codes - c_b * rowsum(X_rot)) * r
//   qmatmul:     Y = (X_rot @ codes - c_b * rowsum(X_rot)) * r, X_rot given
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
//   1. fwht::rotate_kernel (fwht.cuh): one CTA per row, sign flip and
//      in-shared-memory butterfly FWHT (Alg. 5); writes x_rot (n, d) f32
//      and rowsum (n,) to scratch.  qmatmul launches rowsum_kernel instead.
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

#include "fwht.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kGemmThreads = 32 * kWarps;
constexpr int kCols = 4;            // columns per thread (one 4-byte load)
constexpr int kColsPerCta = 32 * kCols;
constexpr int kKChunk = 512;        // d values of x_rot staged per pass
constexpr int kBatch = 8;           // packed rows a thread loads at once
constexpr int kSumThreads = 256;

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

// rowsum[row] = sum(x[row]) for the unfused entry, whose x is already
// rotated: one CTA per row, summed in a fixed order (deterministic).
__global__ void __launch_bounds__(kSumThreads)
rowsum_kernel(const float* __restrict__ x, float* __restrict__ rowsum, int d) {
  __shared__ float warp_sums[kSumThreads / 32];
  const float* src = x + (size_t)blockIdx.x * d;
  float part = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) part += __ldg(src + i);
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

// Split-K dequant GEMM over an already-rotated x, then the fixed-order
// reduction of the splits and the Alg. 3 epilogue.
cudaError_t launch_gemm_epilogue(const float* xrot, const float* rowsum,
                                 const uint8_t* packed, const __half* rescale,
                                 float* partial, float* out, int n, int d,
                                 int c, int bits, int bn, int rows_per_split,
                                 int splits, cudaStream_t st) {
  const int col_tiles = (c + kColsPerCta - 1) / kColsPerCta;
  dim3 grid(col_tiles, (n + bn - 1) / bn, splits);
  cudaError_t e;
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

}  // namespace

// Fused: Y = practical_rht(x) @ (r * (codes - c_b)).  xrot, rowsum and
// partial are scratch.
extern "C" int rht_qmatmul(const float* x, const float* signs1,
                           const float* signs2, const uint8_t* packed,
                           const __half* rescale, float* xrot, float* rowsum,
                           float* partial, float* out, int n, int d, int d_hat,
                           int c, int bits, int bn, int rows_per_split,
                           int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = fwht::launch_rotate(x, signs1, signs2, xrot, rowsum, n, d,
                                      d_hat, st);
  if (e != cudaSuccess) return e;
  return launch_gemm_epilogue(xrot, rowsum, packed, rescale, partial, out, n,
                              d, c, bits, bn, rows_per_split, splits, st);
}

// Unfused second half: Y = (xrot @ codes - c_b * rowsum(xrot)) * r on an
// already-rotated xrot.  Replaces repro/kernels/qmatmul/qmatmul.py:
// quantized_matmul_pallas (_kernel).  rowsum and partial are scratch.
extern "C" int qmatmul(const float* xrot, const uint8_t* packed,
                       const __half* rescale, float* rowsum, float* partial,
                       float* out, int n, int d, int c, int bits, int bn,
                       int rows_per_split, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rowsum_kernel<<<n, kSumThreads, 0, st>>>(xrot, rowsum, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_gemm_epilogue(xrot, rowsum, packed, rescale, partial, out, n,
                              d, c, bits, bn, rows_per_split, splits, st);
}
