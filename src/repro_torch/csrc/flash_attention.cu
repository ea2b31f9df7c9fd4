// Fused flash-attention forward (Hopper): causal / sliding-window /
// key-padding masks and GQA by index map, f32 compute on f32 or bf16 inputs.
//
//   q (B, Sq, H, hd), k/v (B, Sk, KV, hd), H = KV * G -> o (B, Sq, H, hd)
//   o = softmax(q k^T * hd^-0.5 + mask) v, query head h reading KV head h / G
//
// Replaces repro/kernels/flash_attention/flash.py:flash_attention_pallas
// (_kernel).  The Pallas kernel carries the running max m, denominator l and
// the (bq, hd) accumulator in VMEM across a sequential KV grid axis; CTAs on
// the H100 run in no order, so here that axis is a loop inside the CTA, and
// m and l live in shared memory and the accumulator in registers.  One CTA
// owns one (batch, head, 64-query tile) and walks 32-key tiles:
//
//   1. K and V tiles into shared memory (K transposed), read once per CTA
//      from device memory; K/V are never expanded to H heads;
//   2. S = Q K^T: each of 256 threads computes a 2 x 4 block of the 64 x 32
//      tile from float2 / float4 shared-memory reads;
//   3. online softmax, one warp per 8 rows, one key per lane: masked scores
//      are the reference's finite NEG_INF = -1e30, not -inf.  A window's
//      early tiles can be fully masked for a row before its first valid key;
//      with -inf, exp(s - m) would be exp(-inf + inf) = NaN, with -1e30 it is
//      1 and the first valid tile wipes it (alpha = exp(-1e30 - m) = 0), as
//      in the reference;
//   4. acc = alpha * acc + P V, each thread owning 4 columns of 64*hd/1024
//      rows.
//
// The epilogue is the reference's acc / max(l, 1e-30).  Key tiles wholly
// outside the causal or window band are skipped, which gives the same
// result (a skipped tile would add p = 0 with alpha = 1, or be wiped).
// Shared memory at hd = 128: Q^T 33.8 KB + K^T 18.4 KB + V 16.4 KB + P
// 8.4 KB, about 78 KB, so two CTAs fit an SM (not 128 x 128 f32 tiles: three
// of those are 192 KB).
//
// What bounds it on this card: f32 operations on the CUDA cores, 4*hd per
// unmasked (query, key) pair and head (67 TFLOP/s), against q, k, v and o
// read and written once.  Tensor cores (wgmma in bf16/TF32) are later work.
//
// No module on the model path calls it, as in the reference: the models use
// the plain sequence attention (models/attention.py:flash_attention).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                   // queries per CTA
constexpr int kBK = 32;                   // keys per tile (one per lane)
constexpr int kThreads = 256;
constexpr int kQStride = kBQ + 2;         // Q^T row stride (float2 reads)
constexpr int kKStride = kBK + 4;         // K^T row stride (float4 reads)
constexpr int kPStride = kBK + 1;
constexpr float kNegInf = -1e30f;

__device__ inline float load(const float* p) { return __ldg(p); }
__device__ inline float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)HD * kQStride + (size_t)HD * kKStride + (size_t)kBK * HD +
         (size_t)kBQ * kPStride + 3 * kBQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
             int h, int kv, int causal, int window, float scale) {
  constexpr int kTpr = HD / 4;                 // threads across a row of o
  constexpr int kRowGroups = kThreads / kTpr;
  constexpr int kRpt = kBQ / kRowGroups;       // rows of o per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                            // [HD][kQStride], scaled
  float* kt = qt + HD * kQStride;              // [HD][kKStride]
  float* vs = kt + HD * kKStride;              // [kBK][HD]
  float* ps = vs + kBK * HD;                   // [kBQ][kPStride]
  float* m_s = ps + kBQ * kPStride;            // running max
  float* l_s = m_s + kBQ;                      // running denominator
  float* a_s = l_s + kBQ;                      // this tile's rescale alpha

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / kv);             // GQA: no K/V expansion
  const size_t q_row = (size_t)h * HD;         // elements per query position
  const size_t k_row = (size_t)kv * HD;
  const T* qb = q + (size_t)b * sq * q_row + (size_t)head * HD;
  const T* kb = k + (size_t)b * sk * k_row + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * sk * k_row + (size_t)kvh * HD;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, c = idx % HD;
    qt[c * kQStride + r] =
        q0 + r < sq ? load(qb + (size_t)(q0 + r) * q_row + c) * scale : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kRpt][4];
#pragma unroll
  for (int i = 0; i < kRpt; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // the key range any row of this tile can see
  const int q_last = min(q0 + kBQ, sq) - 1;
  int k_begin = 0, k_end = sk;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  if (causal) k_end = min(sk, q_last + 1);
  const int ty = tid >> 3, tx = tid & 7;       // S tile: rows 2ty.., cols 4tx..
  const int cg = tid % kTpr, rg = tid / kTpr;  // o: cols 4cg.., rows rg*kRpt..

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();                           // previous tile fully used
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int r = idx / HD, c = idx % HD;
      const bool in = k0 + r < sk;
      const size_t off = (size_t)(k0 + r) * k_row + c;
      kt[c * kKStride + r] = in ? load(kb + off) : 0.f;
      vs[r * HD + c] = in ? load(vb + off) : 0.f;
    }
    __syncthreads();

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 8
    for (int c = 0; c < HD; ++c) {
      const float2 qa = *reinterpret_cast<const float2*>(qt + c * kQStride + 2 * ty);
      const float4 kc = *reinterpret_cast<const float4*>(kt + c * kKStride + 4 * tx);
      s[0][0] = fmaf(qa.x, kc.x, s[0][0]);
      s[0][1] = fmaf(qa.x, kc.y, s[0][1]);
      s[0][2] = fmaf(qa.x, kc.z, s[0][2]);
      s[0][3] = fmaf(qa.x, kc.w, s[0][3]);
      s[1][0] = fmaf(qa.y, kc.x, s[1][0]);
      s[1][1] = fmaf(qa.y, kc.y, s[1][1]);
      s[1][2] = fmaf(qa.y, kc.z, s[1][2]);
      s[1][3] = fmaf(qa.y, kc.w, s[1][3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(2 * ty + i) * kPStride + 4 * tx + j] = s[i][j];
    __syncthreads();

    // online softmax: warp w owns rows 8w..8w+7, lane = key
    const int kpos = k0 + lane;
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const int qpos = q0 + r;
      bool valid = kpos < sk;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && qpos - kpos < window;
      const float sv = valid ? ps[r * kPStride + lane] : kNegInf;
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(sv - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[r * kPStride + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const float alpha = a_s[rg * kRpt + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 vv = *reinterpret_cast<const float4*>(vs + kk * HD + 4 * cg);
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const float p = ps[(rg * kRpt + i) * kPStride + kk];
        acc[i][0] = fmaf(p, vv.x, acc[i][0]);
        acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        acc[i][2] = fmaf(p, vv.z, acc[i][2]);
        acc[i][3] = fmaf(p, vv.w, acc[i][3]);
      }
    }
  }
  __syncthreads();

  T* ob = o + (size_t)b * sq * q_row + (size_t)head * HD;
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int r = rg * kRpt + i;
    if (q0 + r >= sq) continue;
    const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store(ob + (size_t)(q0 + r) * q_row + 4 * cg + j, acc[i][j] * inv_l);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int sk, int h, int kv, int causal,
                   int window, float scale, cudaStream_t st) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  // opt in every time: past 48 KB a launch without the attribute is refused
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_kernel<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, kv, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, int b, int sq, int sk, int h, int kv,
                      int causal, int window, float scale, cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, b, sq, sk, h, kv, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, b, sq, sk, h, kv, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike).  window <= 0: none.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int sq, int sk, int h, int kv,
                               int hd, int dtype, int causal, int window,
                               float scale, void* stream) {
  if (b < 1 || h < 1 || kv < 1 || h % kv || sq < 1 || sk < 1 ||
      h > 65535 || b > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, b, sq, sk, h, kv, causal, window,
                            scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, b, sq, sk, h, kv, causal,
                                    window, scale, st);
  return cudaErrorInvalidValue;
}
