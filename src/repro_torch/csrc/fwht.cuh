// Practical randomized Hadamard transform (paper Alg. 5) over rows, shared by
// the fused RHT + dequant GEMM (rht_qmatmul.cu) and the stand-alone RHT
// (hadamard.cu), so the port has one FWHT.
//
// One CTA per row.  The row and its sign vectors sit in shared memory; the
// butterfly computes the Sylvester H_{d_hat} = H_{d1} (x) H_{d2}, equal to the
// reference's Kronecker matmuls up to rounding.  For d not a power of 2 the
// second block acts on [d - d_hat, d) after the first block wrote [0, d_hat),
// the reference's overlap semantics (repro/kernels/hadamard/ops.py:35-37).
#pragma once

#include <cuda_runtime.h>

namespace fwht {

constexpr int kRotThreads = 512;

// Global loads issued kRotBatch at a time per thread, so a row costs a few
// memory latencies rather than one per element a thread touches.
constexpr int kRotBatch = 8;

__device__ inline void load_row(float* dst, const float* __restrict__ src,
                                int n) {
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
__device__ inline void fwht_block(float* v, const float* signs_s, int n) {
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

// out[row * out_ld + i] = practical_rht(x[row])[i], zero for d <= i < out_ld
// (the tensor-core GEMM's padded rows); rowsum[row] = sum(rotated row) when
// rowsum is not null (the dequant GEMM's c_b correction).  The row sum is
// taken in a fixed order (warp shuffles, then warps in index order), so it
// does not vary run to run.
__global__ void __launch_bounds__(kRotThreads)
rotate_kernel(const float* __restrict__ x, const float* __restrict__ signs1,
              const float* __restrict__ signs2, float* __restrict__ out,
              float* __restrict__ rowsum, int d, int d_hat, int out_ld) {
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
  float* dst = out + row * out_ld;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    dst[i] = sx[i];
    part += sx[i];
  }
  for (int i = d + threadIdx.x; i < out_ld; i += blockDim.x) dst[i] = 0.f;
  if (rowsum == nullptr) return;
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

// Shared memory the rotation needs for one row of width d.
inline size_t rotate_smem_bytes(int d, int d_hat) {
  return (size_t)(d + (d_hat != d ? 2 : 1) * d_hat) * sizeof(float);
}

inline cudaError_t launch_rotate(const float* x, const float* signs1,
                                 const float* signs2, float* out,
                                 float* rowsum, int n, int d, int d_hat,
                                 int out_ld, cudaStream_t st) {
  // opt in every time: past 48 KB of static + dynamic shared memory a
  // launch without the attribute is refused
  const size_t smem = rotate_smem_bytes(d, d_hat);
  cudaError_t e = cudaFuncSetAttribute(
      rotate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  rotate_kernel<<<n, kRotThreads, smem, st>>>(x, signs1, signs2, out, rowsum,
                                              d, d_hat, out_ld);
  return cudaGetLastError();
}

}  // namespace fwht
