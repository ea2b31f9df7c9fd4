// Fused flash-attention forward (Hopper) on the tensor cores: causal /
// sliding-window / key-padding masks and GQA by index map, f32 or bf16
// inputs, output in the input type.
//
//   q (B, Sq, H, hd), k/v (B, Sk, KV, hd), H = KV * G -> o (B, Sq, H, hd)
//   o = softmax(q k^T * hd^-0.5 + mask) v, query head h reading KV head h / G
//
// Replaces repro/kernels/flash_attention/flash.py:flash_attention_pallas
// (_kernel).  The Pallas kernel carries the running max m, denominator l and
// the (bq, hd) accumulator in VMEM across a sequential KV grid axis; CTAs on
// the H100 run in no order, so here that axis is a loop inside the CTA, in
// the FlashAttention-2 layout:
//
//   * a CTA owns 128 queries of one (batch, head); each of its 8 warps owns
//     16 query rows, and keeps S (16 x 64), m, l and its (16, hd) share of
//     the accumulator in registers (m and l reduced over the 4 threads of a
//     quad with shuffles);
//   * K and V tiles of 64 keys go through a two-stage cp.async ring in
//     shared memory, so the next tile is in flight while this one is
//     computed; Q is staged once; K/V are never expanded to H heads;
//   * S = Q K^T and O += P V on mma.sync.  bf16 inputs: m16n8k16 in bf16
//     with f32 accumulation (exact products); the hd^-0.5 scale is applied
//     to S in f32 (folding it into bf16 q would round q, which the reference
//     does not do); P is rounded to bf16 for P V, as FlashAttention does,
//     since the output is bf16.  f32 inputs: m16n8k8 in TF32 on operands
//     split as x = hi + lo (cvt.rna.tf32), three products hi*hi + hi*lo +
//     lo*hi per product (about 2^-21 relative), P split the same way;
//   * P becomes the A fragment of P V in registers, with no shared-memory
//     round trip: in bf16 the S accumulators of two 8-key n-tiles are the
//     A fragment of one k16 step; in TF32 the 8 key slots of a k8 step are
//     permuted (slot t <-> key 2t, slot t+4 <-> key 2t+1) so that the S
//     accumulator is the A fragment, and V's B fragment reads the same
//     permuted keys.  V is read with ldmatrix.trans (bf16) or 32-bit loads
//     (f32; 132-float rows keep them free of bank conflicts);
//   * masked scores are the reference's finite NEG_INF = -1e30, not -inf.
//     A window's early tiles can be fully masked for a row before its first
//     valid key; with -inf, exp(s - m) would be exp(-inf + inf) = NaN, with
//     -1e30 it is 1 and the first valid tile wipes it (alpha =
//     exp(-1e30 - m) = 0), as in the reference.  Softmax runs in base 2
//     (scores times hd^-0.5 * log2 e), which keeps those semantics;
//   * key tiles wholly outside the causal or window band of the CTA are not
//     loaded, and a warp skips the products of a tile wholly outside its
//     rows' band (a skipped tile would add p = 0 with alpha = 1, or be
//     wiped);
//   * the grid runs the last (longest, for causal masks) query tiles first,
//     so the uneven work balances across the SMs.
//
// The epilogue is the reference's acc / max(l, 1e-30).
//
// What bounds it on this card: tensor-core operations, 4*hd per unmasked
// (query, key) pair and head: at 989 TFLOP/s in bf16, at 495 / 3 = 165
// TFLOP/s for the three TF32 products of f32; q, k, v and o are read and
// written once (a few MB).  Shared memory: Q plus two stages of K and V,
// 104 KB at hd = 128 in bf16 (two CTAs per SM), 203 KB in f32 (one).
//
// No module on the model path calls it, as in the reference: the models use
// the plain sequence attention (models/attention.py:flash_attention).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::mma_bf16;
using tc::smem_addr;

constexpr int kBQ = 128;                  // queries per CTA
constexpr int kBK = 64;                   // keys per tile
constexpr int kWarps = kBQ / 16;          // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int HD>
struct Smem {
  static constexpr int kStride = HD + 16 / (int)sizeof(T);  // row + 16 B
  static constexpr int kQ = kBQ * kStride;                  // elements
  static constexpr int kKV = kBK * kStride;
  static constexpr size_t kBytes = (size_t)(kQ + 4 * kKV) * sizeof(T);
};

__device__ inline void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ inline void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ inline uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo to about 2^-22 relative, each part a TF32 value.
__device__ inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// d += a b with a and b split into TF32 hi + lo: lo*hi + hi*lo + hi*hi.
__device__ inline void mma_3xtf32(float (&d)[4], const float (&a)[4],
                                  float b0, float b1) {
  uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}
__device__ inline uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// S (16 x 64) = Q K^T for the warp's 16 rows.  qs: the warp's first Q row;
// ks: the K tile.  s[j][e]: row g (e < 2) or g + 8, key 8j + 2t + (e & 1).
template <int HD>
__device__ inline void qk(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                          float (&s)[8][4], int lane) {
  constexpr int ST = Smem<__nv_bfloat16, HD>::kStride;
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, qs + (lane & 15) * ST + 16 * kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, ks + (16 * np + (mi >> 1) * 8 + r) * ST + 16 * kk +
                     (mi & 1) * 8);
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}
template <int HD>
__device__ inline void qk(const float* qs, const float* ks, float (&s)[8][4],
                          int lane) {
  constexpr int ST = Smem<float, HD>::kStride;
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll 2
  for (int kk = 0; kk < HD / 8; ++kk) {
    // ldmatrix on f32 rows: thread (g, t) gets float t of row g of each
    // 8 x 4 block, the TF32 fragment layout
    uint32_t qa[4];
    ldsm_x4(qa, qs + ((mi & 1) * 8 + r) * ST + 8 * kk + (mi >> 1) * 4);
    const float a[4] = {__uint_as_float(qa[0]), __uint_as_float(qa[1]),
                        __uint_as_float(qa[2]), __uint_as_float(qa[3])};
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, ks + (16 * np + (mi >> 1) * 8 + r) * ST + 8 * kk +
                     (mi & 1) * 4);
      mma_3xtf32(s[2 * np], a, __uint_as_float(b[0]), __uint_as_float(b[1]));
      mma_3xtf32(s[2 * np + 1], a, __uint_as_float(b[2]),
                 __uint_as_float(b[3]));
    }
  }
}

// O (16 x hd) += P V, P = s in registers; vs: the V tile.
// o[j][e]: row g (e < 2) or g + 8, column 8j + 2t + (e & 1).
template <int HD>
__device__ inline void pv(const float (&s)[8][4], const __nv_bfloat16* vs,
                          float (&o)[HD / 8][4], int lane) {
  constexpr int ST = Smem<__nv_bfloat16, HD>::kStride;
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, vs + (16 * kk + (mi & 1) * 8 + r) * ST + 16 * np +
                           (mi >> 1) * 8);
      mma_bf16(o[2 * np], a, b[0], b[1]);
      mma_bf16(o[2 * np + 1], a, b[2], b[3]);
    }
  }
}
template <int HD>
__device__ inline void pv(const float (&s)[8][4], const float* vs,
                          float (&o)[HD / 8][4], int lane) {
  constexpr int ST = Smem<float, HD>::kStride;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    // key slots permuted: slot t is key 2t, slot t + 4 is key 2t + 1
    const float a[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
    const float* v0 = vs + (8 * j + 2 * t) * ST + g;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      mma_3xtf32(o[nt], a, v0[8 * nt], v0[ST + 8 * nt]);
  }
}

__device__ inline void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ inline void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
             int h, int kv, int causal, int window, float scale_log2) {
  using L = Smem<T, HD>;
  constexpr int ST = L::kStride;
  constexpr int kChunks = HD * (int)sizeof(T) / 16;   // 16 B per row
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* kvs = qs + L::kQ;                  // stage s: K at 2s, V at 2s + 1

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int head = blockIdx.x % h, b = blockIdx.x / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // longest first
  const int kvh = head / (h / kv);                     // GQA: no expansion
  const size_t q_row = (size_t)h * HD, k_row = (size_t)kv * HD;
  const T* qb = q + (size_t)b * sq * q_row + (size_t)head * HD;
  const T* kb = k + (size_t)b * sk * k_row + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * sk * k_row + (size_t)kvh * HD;

  // the key range any row of this CTA can see, in whole tiles
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int tile0 = k_begin / kBK;
  const int n_tiles = (k_end + kBK - 1) / kBK - tile0;

  auto load_kv = [&](int stage, int tile) {
    const int k0 = tile * kBK;
    T* ks = kvs + 2 * stage * L::kKV;
    T* vs = ks + L::kKV;
    for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreads) {
      const int r = idx / kChunks, cch = idx % kChunks;
      const bool in = k0 + r < sk;
      const size_t off = (size_t)(k0 + r) * k_row + cch * (16 / sizeof(T));
      cp_async16(ks + r * ST + cch * (16 / sizeof(T)), in ? kb + off : k, in);
      cp_async16(vs + r * ST + cch * (16 / sizeof(T)), in ? vb + off : v, in);
    }
  };

  for (int idx = threadIdx.x; idx < kBQ * kChunks; idx += kThreads) {
    const int r = idx / kChunks, cch = idx % kChunks;
    const bool in = q0 + r < sq;
    cp_async16(qs + r * ST + cch * (16 / sizeof(T)),
               in ? qb + (size_t)(q0 + r) * q_row + cch * (16 / sizeof(T))
                  : q,
               in);
  }
  if (n_tiles > 0) load_kv(0, tile0);
  cp_async_commit();

  // this thread's rows g and g + 8 of the warp's 16
  const int qw0 = q0 + 16 * warp;            // the warp's first row
  const int qpos[2] = {qw0 + g, qw0 + g + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv((it + 1) & 1, tile0 + it + 1);
    cp_async_commit();
    cp_async_wait<1>();                      // tile it (and Q) landed
    __syncthreads();
    const int k0 = (tile0 + it) * kBK;
    const bool skip = k0 >= sk || (causal && k0 > qw0 + 15) ||
                      (window > 0 && qw0 - (k0 + kBK - 1) >= window);
    if (!skip) {
      const bool full = k0 + kBK <= sk && (!causal || k0 + kBK - 1 <= qw0) &&
                        (window <= 0 || qw0 + 15 - k0 < window);
      const T* ks = kvs + 2 * (it & 1) * L::kKV;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      qk<HD>(qs + 16 * warp * ST, ks, s, lane);

      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (!full) {
            const int key = k0 + 8 * j + 2 * t + (e & 1), qp = qpos[e >> 1];
            const bool valid = key < sk && (!causal || key <= qp) &&
                               (window <= 0 || qp - key < window);
            if (!valid) x = kNegInf;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - m[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
      pv<HD>(s, ks + L::kKV, acc, lane);
    }
    __syncthreads();                         // stage it & 1 free again
  }
  cp_async_wait<0>();

  T* ob = o + (size_t)b * sq * q_row + (size_t)head * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // l is this thread's share of the row sum: add the quad's
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    if (qpos[r] >= sq) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    T* dst = ob + (size_t)qpos[r] * q_row + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store2(dst + 8 * j, acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int sk, int h, int kv, int causal,
                   int window, float scale, cudaStream_t st) {
  const size_t smem = Smem<T, HD>::kBytes;
  // opt in every time: past 48 KB a launch without the attribute is refused
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(h * b, (sq + kBQ - 1) / kBQ);
  flash_kernel<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, kv, causal,
      window, scale * kLog2e);
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
      (long long)h * b > 0x7fffffff || (sq + kBQ - 1) / kBQ > 65535)
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
