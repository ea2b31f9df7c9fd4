// Paged flash-decode attention over the serving engine's KV block arena
// (Hopper).
//
// Replaces repro/kernels/paged_attention/paged.py:paged_attention_pallas
// (_kernel).  Two launches on one stream:
//
//   1. paged_attention_split: one CTA per (request b, KV head h, split s)
//      serves the W*G query rows that share that KV head (GQA; rows ordered
//      w-major, row r is query position cnt - W + r / G).  The CTA reads its
//      own block_table[b, j], pos and ring_cap, computes
//      nblk = clip(ceil(min(cnt, cap) / bs), 1, MB), and walks its share
//      [s * ceil(nblk / S), ...) of the logical blocks j < nblk, loading each
//      (bs, hd) K/V slab in place from the arena (never a dense gathered
//      copy).  Per block: scores in f32 (one warp per (row, key) pair, lanes
//      split hd), the stored-position mask
//      stored = last - floormod(last - idx, cap) (a floor-mod: C's %
//      truncates toward zero and last - idx is negative past the frontier),
//      online softmax with the explicit re-mask of p after the exp.  Writes
//      the split's running max m, denominator l and unnormalized acc.
//   2. paged_attention_combine: merges the S splits of each row in a fixed
//      order (deterministic): M = max m_s, L = sum l_s e^(m_s - M),
//      out = sum acc_s e^(m_s - M) / max(L, 1e-30).  With S = 1 this is the
//      single-pass epilogue acc / max(l, 1e-30).
//
// What bounds it: arena bytes (a decode step reads each live K/V byte once;
// scores and softmax are a few FLOPs per byte).  The KV splits (flash-
// decoding) give 8 requests x 32 heads enough CTAs to keep loads in flight
// on 132 SMs; cp.async/TMA double buffering is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int floor_mod(int a, int m) {
  return ((a % m) + m) % m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const float* __restrict__ q,
                             const T* __restrict__ k_arena,
                             const T* __restrict__ v_arena,
                             const int* __restrict__ block_table,
                             const int* __restrict__ pos,
                             const int* __restrict__ ring_cap,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out,
                             float* __restrict__ acc_out, int W, int H,
                             int KV, int hd, int bs, int MB, int window,
                             float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int R = W * G;
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int B = gridDim.y, S = gridDim.z;
  float* q_s = smem;                  // R x hd
  float* acc_s = q_s + R * hd;        // R x hd
  float* k_s = acc_s + R * hd;        // bs x hd
  float* v_s = k_s + bs * hd;         // bs x hd
  float* p_s = v_s + bs * hd;         // R x bs (scores, then probabilities)
  float* m_s = p_s + R * bs;          // R
  float* l_s = m_s + R;               // R
  float* alpha_s = l_s + R;           // R
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(alpha_s + R);

  const int cnt = max(pos[b], 1);
  const int cap = max(ring_cap[b], 1);
  const int nblk = min(max((min(cnt, cap) + bs - 1) / bs, 1), MB);
  const int last = cnt - 1;
  const int per_split = (nblk + S - 1) / S;
  const int j0 = split * per_split;
  const int j1 = min(j0 + per_split, nblk);

  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, dd = i % hd;
    const int w = r / G, g = r % G;
    q_s[i] = q[(((size_t)b * W + w) * H + h * G + g) * hd + dd] * scale;
    acc_s[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int j = j0; j < j1; ++j) {
    const size_t blk = (size_t)block_table[(size_t)b * MB + j];
    for (int i = threadIdx.x; i < bs * hd; i += blockDim.x) {
      const int t = i / hd, dd = i % hd;
      const size_t src = ((blk * bs + t) * KV + h) * hd + dd;
      k_s[i] = to_f32(k_arena[src]);
      v_s[i] = to_f32(v_arena[src]);
    }
    __syncthreads();
    for (int pair = warp; pair < R * bs; pair += nwarps) {
      const int r = pair / bs, t = pair % bs;
      float s = 0.f;
      for (int dd = lane; dd < hd; dd += 32) s += q_s[r * hd + dd] * k_s[t * hd + dd];
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) {
        const int idx = j * bs + t;
        const int stored = last - floor_mod(last - idx, cap);
        const int qpos = cnt - W + r / G;
        bool valid = idx < cap && stored >= 0 && stored <= qpos;
        if (window > 0) valid = valid && (qpos - stored) < window;
        p_s[pair] = valid ? s : kNegInf;
        mask_s[pair] = valid;
      }
    }
    __syncthreads();
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      const float m_prev = m_s[r];
      float m_new = m_prev;
      for (int t = 0; t < bs; ++t) m_new = fmaxf(m_new, p_s[r * bs + t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        // re-mask: a fully masked block has s == m_new == NEG_INF, where
        // exp(s - m_new) = 1 would resurrect dead keys
        const float p = mask_s[r * bs + t] ? expf(p_s[r * bs + t] - m_new) : 0.f;
        p_s[r * bs + t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      alpha_s[r] = alpha;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
      const int r = i / hd, dd = i % hd;
      float a = 0.f;
      for (int t = 0; t < bs; ++t) a += p_s[r * bs + t] * v_s[t * hd + dd];
      acc_s[i] = acc_s[i] * alpha_s[r] + a;
    }
    __syncthreads();
  }
  const size_t row0 = (((size_t)split * B + b) * KV + h) * R;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m_out[row0 + r] = m_s[r];
    l_out[row0 + r] = l_s[r];
  }
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x)
    acc_out[row0 * hd + i] = acc_s[i];
}

__global__ void paged_attention_combine_kernel(const float* __restrict__ m_in,
                                               const float* __restrict__ l_in,
                                               const float* __restrict__ acc_in,
                                               float* __restrict__ out, int W,
                                               int H, int KV, int hd, int S) {
  const int G = H / KV, R = W * G;
  const size_t rows = (size_t)gridDim.x;      // B * KV * R
  const size_t row = blockIdx.x;
  const int b = (int)(row / ((size_t)KV * R));
  const int h = (int)((row / R) % KV);
  const int r = (int)(row % R);
  float m_max = kNegInf;
  for (int s = 0; s < S; ++s) m_max = fmaxf(m_max, m_in[s * rows + row]);
  float l_sum = 0.f;
  for (int s = 0; s < S; ++s)
    l_sum += l_in[s * rows + row] * expf(m_in[s * rows + row] - m_max);
  const int w = r / G, g = r % G;
  float* dst = out + (((size_t)b * W + w) * H + h * G + g) * hd;
  for (int dd = threadIdx.x; dd < hd; dd += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < S; ++s)
      o += acc_in[(s * rows + row) * hd + dd] * expf(m_in[s * rows + row] - m_max);
    dst[dd] = o / fmaxf(l_sum, 1e-30f);
  }
}

template <typename T>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const int* bt, const int* pos, const int* ring, float* m,
                   float* l, float* acc, float* out, int B, int W, int H,
                   int KV, int hd, int bs, int MB, int window, float scale,
                   int splits, cudaStream_t st) {
  const int R = W * (H / KV);
  const size_t smem = sizeof(float) * ((size_t)2 * R * hd + 2 * bs * hd +
                                       R * bs + 3 * R) + (size_t)R * bs;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_split_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(KV, B, splits);
  paged_attention_split_kernel<T><<<grid, kThreads, smem, st>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), bt, pos, ring,
      m, l, acc, W, H, KV, hd, bs, MB, window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_attention_combine_kernel<<<B * KV * R, kThreads, 0, st>>>(
      m, l, acc, out, W, H, KV, hd, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention(const float* q, const void* k_arena,
                               const void* v_arena, const int* block_table,
                               const int* pos, const int* ring_cap, float* m,
                               float* l, float* acc, float* out, int B, int W,
                               int H, int KV, int hd, int bs, int MB,
                               int window, float scale, int splits,
                               int kv_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return launch<__nv_bfloat16>(q, k_arena, v_arena, block_table, pos,
                                 ring_cap, m, l, acc, out, B, W, H, KV, hd, bs,
                                 MB, window, scale, splits, st);
  return launch<float>(q, k_arena, v_arena, block_table, pos, ring_cap, m, l,
                       acc, out, B, W, H, KV, hd, bs, MB, window, scale,
                       splits, st);
}
