// Practical randomized Hadamard transform (paper Alg. 5) over rows, shared by
// the fused RHT + dequant GEMM (rht_qmatmul.cu) and the stand-alone RHT
// (hadamard.cu), so the port has one FWHT.
//
// One CTA of T threads per row; each thread holds E = d_hat / T values of a
// block in registers (T = 32, E = 1 below d_hat = 32, lanes past d_hat idle).
// A block index j in [0, d_hat) splits into bits as it is loaded:
//
//   j = e * T + warp * 32 + lane        (e: the thread's register slot)
//
// and H_{d_hat} = (x) of H_2 over every bit, in three groups of stages:
//   1. the log2 E slot bits, in registers (butterflies between slots);
//   2. the 5 lane bits, through __shfl_xor_sync (one fma per value: the
//      partner plus or minus the own value, so no select);
//   3. the log2 W warp bits (W = T / 32) after one transpose through shared
//      memory, in registers again: the thread then holds the W values that
//      differ in the warp bits (phase2_index), which needs E >= W.
// So a block costs one barrier; the 1/sqrt(d_hat) scale is one multiply
// on the last stage.
// The sum is the Sylvester H_{d_hat}, equal to the reference's Kronecker
// matmuls up to rounding; the stage order is fixed, so two calls give the
// same bits (ref.rotate_walk walks the same stages on the host).
//
// For d not a power of 2 (Alg. 5) block 2 acts on [d - d_hat, d) after
// block 1 wrote [0, d_hat), the reference's overlap semantics
// (repro/kernels/hadamard/ops.py:35-37).  The row's tail [d_hat, d) is
// copied to shared memory by cp.async when the CTA starts, under block 1's
// work; block 1 leaves its overlap there, so block 2 reads only shared
// memory (barriers per row: 1 for a power of 2, 3 otherwise).  Every global
// load of a thread is issued before any value is used.
//
// Shared memory: d_hat floats for the transpose (none at T = 32) and d for
// the row when d is not a power of 2; the opt-in attribute is set once per
// instantiation and device (allow_smem), not per launch.
// Plans (T, E) by d_hat, from kernels/hadamard/ops.py:rotate_plan:
//   d_hat <= 32: (32, 1)   64: (32, 2)    128: (64, 2)    256: (64, 4)
//   512: (128, 4)          1024: (128, 8) 2048: (256, 8)  4096: (256, 16)
//   8192: (512, 16)        16384: (512, 32)
#pragma once

#include <cuda_runtime.h>

// Each library that includes this header (hadamard.cu, rht_qmatmul.cu) gets
// its own copy: the unnamed namespace gives every kernel and the static in
// allow_smem internal linkage.  With external linkage the compiler makes
// that static one object across every loaded library, so one library's
// opt-in would stand for another's kernel and its launch would be refused.
namespace fwht {
namespace {

constexpr int kMaxDHat = 16384;
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v >> 1);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Block index of register slot e of thread (wp, ln) after the transpose:
// the slot's low log2 W bits are the warp bits of j.
template <int T, int E>
__device__ __forceinline__ int phase2_index(int wp, int ln, int e) {
  constexpr int LW = ilog2(T / 32), LE = ilog2(E);
  return (((e >> LW) | (wp << (LE - LW))) * T) + (e & (T / 32 - 1)) * 32 + ln;
}

// Butterflies between register slots over slot bits [LO, HI).
template <int E, int LO, int HI>
__device__ __forceinline__ void slot_stages(float (&v)[E]) {
#pragma unroll
  for (int b = LO; b < HI; ++b) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e & (1 << b)) continue;
      const float a = v[e], c = v[e | (1 << b)];
      v[e] = a + c;
      v[e | (1 << b)] = a - c;
    }
  }
}

// Unnormalized H_{d_hat} of one block, then the scale.  On entry v holds the
// sign-flipped block in the load layout (j = e * T + threadIdx.x); on return
// the transformed block in the phase2_index layout.  buf: d_hat floats of
// shared memory no thread still reads (unused at T = 32).
template <int T, int E>
__device__ __forceinline__ void transform(float (&v)[E], float* buf,
                                          int d_hat, float scale) {
  constexpr int LE = ilog2(E);
  const int t = threadIdx.x, ln = t & 31, wp = t >> 5;
  slot_stages<E, 0, LE>(v);
#pragma unroll
  for (int h = 1; h < 32; h <<= 1) {
    if (h >= d_hat) break;          // d_hat < 32: lanes past d_hat idle
    const float sgn = (ln & h) ? -1.f : 1.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float p = __shfl_xor_sync(0xffffffffu, v[e], h);
      v[e] = __fmaf_rn(sgn, v[e], p);   // lower: v + p; upper: p - v
    }
  }
  if constexpr (T > 32) {
#pragma unroll
    for (int e = 0; e < E; ++e) buf[e * T + t] = v[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = buf[phase2_index<T, E>(wp, ln, e)];
    slot_stages<E, 0, ilog2(T / 32)>(v);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = __fmul_rn(v[e], scale);
}

// out[row * out_ld + i] = practical_rht(x[row])[i], zero for d <= i < out_ld
// (the tensor-core GEMM's padded rows); rowsum[row] = sum(rotated row) when
// rowsum is not null (the dequant GEMM's c_b correction), taken in a fixed
// order: each thread's slots in order, block 1 before block 2, then warp
// shuffles, then warps in index order.
template <int T, int E>
__global__ void __launch_bounds__(T, E >= 32 ? 1 : 2)
rotate_kernel(const float* __restrict__ x, const float* __restrict__ signs1,
              const float* __restrict__ signs2, float* __restrict__ out,
              float* __restrict__ rowsum, int d, int d_hat, int out_ld) {
  static_assert(T >= 32 && T <= 512 && E >= T / 32, "plan out of range");
  extern __shared__ float smem[];
  __shared__ float warp_sums[T / 32];
  float* buf = smem;                            // d_hat, when T > 32
  float* row = smem + (T > 32 ? d_hat : 0);     // d, when d != d_hat
  const int t = threadIdx.x, ln = t & 31, wp = t >> 5;
  const size_t r = blockIdx.x;
  const float* xr = x + r * d;
  float* dst = out + r * out_ld;
  const int o = d - d_hat;                      // block 2's first index
  const float scale = 1.0f / sqrtf((float)d_hat);

  for (int i = d_hat + t; i < d; i += T) cp_async4(row + i, xr + i);
  float v[E], s[E], s2[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = e * T + t;
    v[e] = j < d_hat ? __ldg(xr + j) : 0.f;
    s[e] = j < d_hat ? __ldg(signs1 + j) : 0.f;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = e * T + t;
    s2[e] = (o > 0 && j < d_hat) ? __ldg(signs2 + j) : 0.f;
    v[e] = __fmul_rn(v[e], s[e]);
  }
  transform<T, E>(v, buf, d_hat, scale);

  float part = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = phase2_index<T, E>(wp, ln, e);
    if (j >= d_hat) continue;
    if (j < o || o == 0) {
      dst[j] = v[e];
      part += v[e];
    } else {
      row[j] = v[e];                            // the overlap, for block 2
    }
  }
  if (o > 0) {
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = e * T + t;
      v[e] = j < d_hat ? __fmul_rn(row[o + j], s2[e]) : 0.f;
    }
    transform<T, E>(v, buf, d_hat, scale);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = phase2_index<T, E>(wp, ln, e);
      if (j >= d_hat) continue;
      dst[o + j] = v[e];
      part += v[e];
    }
  }
  for (int i = d + t; i < out_ld; i += T) dst[i] = 0.f;
  if (rowsum == nullptr) return;
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if (ln == 0) warp_sums[wp] = part;
  __syncthreads();
  if (t == 0) {
    float sum = 0.f;
    for (int w = 0; w < T / 32; ++w) sum += warp_sums[w];
    rowsum[r] = sum;
  }
}

// Dynamic shared memory of one row of width d under plan (T, .).
inline size_t rotate_smem_bytes(int threads, int d, int d_hat) {
  return (size_t)((threads > 32 ? d_hat : 0) + (d != d_hat ? d : 0)) *
         sizeof(float);
}

// Opt in to the most dynamic shared memory this instantiation can use
// (d_hat for the transpose and a row shorter than 2 d_hat), once per device.
// Always, not only past 48 KB: that default limit counts the static
// warp_sums too, so a row just under it (d = 8191 under (256, 16)) would
// otherwise be refused.
template <int T, int E>
inline cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && done[dev])) return e;
  e = cudaFuncSetAttribute(rotate_kernel<T, E>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           3 * T * E * (int)sizeof(float));
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

template <int T, int E>
inline cudaError_t launch_plan(const float* x, const float* signs1,
                               const float* signs2, float* out, float* rowsum,
                               int n, int d, int d_hat, int out_ld,
                               cudaStream_t st) {
  const size_t smem = rotate_smem_bytes(T, d, d_hat);
  const cudaError_t e = allow_smem<T, E>();
  if (e != cudaSuccess) {
    cudaGetLastError();   // leave no error behind for a later launch check
    return e;
  }
  rotate_kernel<T, E><<<n, T, smem, st>>>(x, signs1, signs2, out, rowsum, d,
                                          d_hat, out_ld);
  return cudaGetLastError();
}

// The rotation of n rows under the plan (threads, per_thread) that
// kernels/hadamard/ops.py:rotate_plan gives for d.
inline cudaError_t launch_rotate(const float* x, const float* signs1,
                                 const float* signs2, float* out,
                                 float* rowsum, int n, int d, int d_hat,
                                 int out_ld, int threads, int per_thread,
                                 cudaStream_t st) {
  if (d_hat < 1 || d_hat > kMaxDHat || (d_hat & (d_hat - 1)) || d < d_hat ||
      d >= 2 * d_hat || out_ld < d || n < 0 ||
      threads * per_thread != (d_hat < 32 ? 32 : d_hat))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
#define FWHT_PLAN(T, E)                                                      \
  if (threads == T && per_thread == E)                                       \
    return launch_plan<T, E>(x, signs1, signs2, out, rowsum, n, d, d_hat,    \
                             out_ld, st);
  FWHT_PLAN(32, 1) FWHT_PLAN(32, 2) FWHT_PLAN(64, 2) FWHT_PLAN(64, 4)
  FWHT_PLAN(128, 4) FWHT_PLAN(128, 8) FWHT_PLAN(256, 8) FWHT_PLAN(256, 16)
  FWHT_PLAN(512, 16) FWHT_PLAN(512, 32)
#undef FWHT_PLAN
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fwht
