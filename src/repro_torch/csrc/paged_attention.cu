// Paged flash-decode attention over the serving engine's KV block arena
// (Hopper).
//
// Replaces repro/kernels/paged_attention/paged.py:paged_attention_pallas
// (_kernel): for each request b and KV head h, the W*G query rows that
// share the head (GQA; rows ordered w-major, row r is query position
// cnt - W + r / G) attend over the logical blocks j < nblk of the request's
// block table, nblk = clip(ceil(min(cnt, cap) / bs), 1, MB), with the
// stored-position mask stored = last - floormod(last - idx, cap) (a floor-
// mod: C's % truncates toward zero and last - idx is negative past the
// frontier), idx < cap, causal and window masks, and the explicit re-mask
// of p after the exp.
//
// What bounds it: arena bytes.  A decode step reads each live K/V byte
// once and does about one FMA per byte, so the card's 3.35 TB/s is the
// limit and the design's job is to keep enough bytes in flight: at about
// 1 us of latency, 3.35 TB/s / 132 SMs needs some 25-35 KB in flight per
// SM.  What the design does about it:
//
//   * Grid: one CTA of 4 warps per (request b, KV head h, split s).  A CTA
//     walks its split's keys in tiles of kTileKeys = 32 keys (two blocks
//     of the pool's 16); every key's block id comes from the request's
//     block-table row, which the CTA copies to shared memory once.
//   * K/V ring: each tile's K and V rows arrive by 16-byte cp.async.cg
//     (L1 bypassed; a bf16 arena is copied as raw bytes and converted when
//     read) into a ring of kStages = 3 slots; the copies of tile i+2 are
//     issued before tile i is computed.  An f32 slot is 32 KB (16 KB of K,
//     16 KB of V at hd 128), so a CTA keeps 64 KB in flight, and two CTAs
//     fit on an SM (96 KB of ring each): 128 KB in flight per SM.  The one
//     barrier per tile hands the oldest slot back to the copier.
//   * Warp-split keys: warp w owns keys [8w, 8w + 8) of every tile and
//     keeps its own online softmax (m, l) and accumulator per row.  q lives
//     in registers (lane holds hd/32 values of each row, pre-scaled by
//     scale * log2 e, so scores are in the exp2 domain); K rows are read
//     as 16-byte (f32) or 8-byte (bf16) vectors, neighbouring lanes on
//     neighbouring bytes.  The 8 keys' partial dot products are reduced
//     together by a transposing butterfly: 9 shuffles for 8 keys, after
//     which lane L holds the score of key kid(L).  The tile's max and sum
//     take 3 shuffles each; p_t is broadcast by shuffle for P.V.
//   * Rows: a CTA handles its R = W*G rows in chunks of RC in {1, 2, 4, 8}
//     register rows; R > 8 walks the split's keys once per chunk.
//   * End of a split: the 4 warps' (m, l, acc) merge through shared memory
//     in warp order 0..3.  When the request has one split (the serving
//     case at short context) the CTA writes the normalised output itself
//     and the combine launch, if any, skips the row.  Otherwise it writes
//     the split's (m, l, acc) and paged_attention_combine merges the splits
//     in split order 0..S-1, so results repeat bit for bit.
//   * Split plan (per request, on the card): with S grid splits, a request
//     with nkeys = nblk * bs keys uses s_eff = clip(nkeys / min_split_keys,
//     1, S) splits of ceil(tiles / s_eff) tiles; a split with no tile (s >=
//     s_eff, or past the last tile) writes m = NEG_INF, l = 0, acc = 0.
//
// Domain: hd 64 or 128 (the wrapper raises otherwise), any block size,
// any W and G, f32 or bf16 arenas, f32 q and output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeysPerWarp = 8;
constexpr int kTileKeys = kWarps * kKeysPerWarp;
constexpr int kStages = 3;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int floor_mod(int a, int m) {
  return ((a % m) + m) % m;
}

// The request's share of the walk, as ref.split_plan computes it.
struct Plan {
  int cnt, cap, last, nkeys, s_eff, t0, t1;
};

__device__ __forceinline__ Plan plan_of(int pos, int ring, int bs, int MB,
                                        int S, int split, int min_keys) {
  Plan p;
  p.cnt = max(pos, 1);
  p.cap = max(ring, 1);
  p.last = p.cnt - 1;
  const int nblk = min(max((min(p.cnt, p.cap) + bs - 1) / bs, 1), MB);
  p.nkeys = nblk * bs;
  p.s_eff = max(1, min(S, p.nkeys / min_keys));
  const int tiles = (p.nkeys + kTileKeys - 1) / kTileKeys;
  const int per = (tiles + p.s_eff - 1) / p.s_eff;
  p.t0 = split * per;
  p.t1 = min(p.t0 + per, tiles);
  return p;
}

// VEC consecutive elements (4, 8 or 16 bytes, aligned) as f32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  constexpr int kWords = VEC * (int)sizeof(T) / 4;
  static_assert(kWords == 1 || kWords == 2 || kWords == 4, "vector width");
  uint32_t w[kWords];
  if constexpr (kWords == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (kWords == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if constexpr (sizeof(T) == 4) {
      out[i] = __uint_as_float(w[i]);
    } else {                  // two bf16, the lower address in the low half
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// The key whose score lane L holds after reduce8, and the lane that holds
// key t's (one of four that do).
__device__ __forceinline__ int key_of_lane(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}
__device__ __forceinline__ int lane_of_key(int t) {
  return ((t >> 2) & 1) << 4 | ((t >> 1) & 1) << 3 | (t & 1) << 2;
}

// Sums 8 per-lane partials over the warp, transposed: each butterfly step
// hands half of the still-open keys to the partner lane, so 4 + 2 + 1
// shuffles split the keys across lane bits 4, 3, 2 and 2 more finish the
// sum; lane L returns the full sum of key key_of_lane(L).
__device__ __forceinline__ float reduce8(float (&v)[kKeysPerWarp], int lane) {
  static_assert(kKeysPerWarp == 8, "the butterfly splits 8 keys");
  bool hi = lane & 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = hi ? v[i] : v[i + 4];
    const float keep = hi ? v[i + 4] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  hi = lane & 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = hi ? v[i] : v[i + 2];
    const float keep = hi ? v[i + 2] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  hi = lane & 4;
  float s = (hi ? v[1] : v[0]) + __shfl_xor_sync(kFull, hi ? v[0] : v[1], 4);
  s += __shfl_xor_sync(kFull, s, 2);
  s += __shfl_xor_sync(kFull, s, 1);
  return s;
}

// over the 8 keys of a warp's slice (lane bits 4, 3, 2)
__device__ __forceinline__ float max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 4));
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 8));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 16));
}
__device__ __forceinline__ float sum8(float x) {
  x += __shfl_xor_sync(kFull, x, 4);
  x += __shfl_xor_sync(kFull, x, 8);
  return x + __shfl_xor_sync(kFull, x, 16);
}

// Shared memory: the K/V ring (the warps' merge area once the walk is
// done), then the split's block ids.
template <typename T, int HD, int RC>
__host__ __device__ constexpr size_t region_bytes() {
  const size_t ring = (size_t)kStages * 2 * kTileKeys * HD * sizeof(T);
  const size_t merge = sizeof(float) * kWarps * RC * (HD + 2);
  return ((ring > merge ? ring : merge) + 15) / 16 * 16;
}

template <typename T, int HD, int RC>
__global__ void __launch_bounds__(kThreads, 2)
paged_attention_split_kernel(const float* __restrict__ q,
                             const T* __restrict__ k_arena,
                             const T* __restrict__ v_arena,
                             const int* __restrict__ block_table,
                             const int* __restrict__ pos,
                             const int* __restrict__ ring_cap,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out,
                             float* __restrict__ acc_out,
                             float* __restrict__ out, int W, int H, int KV,
                             int bs, int MB, int window, float qscale,
                             int min_keys) {
  constexpr int VEC = HD / 32;                 // q / acc values per lane
  constexpr int CHUNK = 16 / (int)sizeof(T);   // elements per 16-byte copy
  constexpr int CPR = HD / CHUNK;              // copies per key row
  constexpr int KEY_STEP = kThreads / CPR;     // a thread's key stride
  constexpr int TILE = kTileKeys * HD;         // elements of one K (or V) tile
  static_assert(kThreads % CPR == 0 && kTileKeys % KEY_STEP == 0, "copy map");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* red_m = reinterpret_cast<float*>(smem);
  float* red_l = red_m + kWarps * RC;
  float* red_acc = red_l + kWarps * RC;
  int* ids = reinterpret_cast<int*>(smem + region_bytes<T, HD, RC>());

  const int G = H / KV, R = W * G;
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int B = gridDim.y, S = gridDim.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Plan p = plan_of(pos[b], ring_cap[b], bs, MB, S, split, min_keys);
  const bool direct = p.s_eff == 1;
  const size_t part0 = (((size_t)split * B + b) * KV + h) * R;
  if (p.t0 >= p.t1) {                 // no tile: a neutral partial
    if (!direct) {
      for (int r = threadIdx.x; r < R; r += kThreads) {
        m_out[part0 + r] = kNegInf;
        l_out[part0 + r] = 0.f;
      }
      for (int i = threadIdx.x; i < R * HD; i += kThreads)
        acc_out[part0 * HD + i] = 0.f;
    }
    return;
  }
  const int k1 = min(p.t1 * kTileKeys, p.nkeys);   // keys past k1: not read
  const int jb0 = p.t0 * kTileKeys / bs;
  const int nids = (k1 - 1) / bs - jb0 + 1;
  for (int i = threadIdx.x; i < nids; i += kThreads)
    ids[i] = block_table[(size_t)b * MB + jb0 + i];
  __syncthreads();

  // this thread's copies of tile t: column chunk `col` of keys key0,
  // key0 + KEY_STEP, ...; a key past k1 is zero-filled and masked
  const int col = threadIdx.x % CPR, key0 = threadIdx.x / CPR;
  auto issue = [&](int t) {
    T* ks = ring + (size_t)((t - p.t0) % kStages) * 2 * TILE;
    T* vs = ks + TILE;
    int idx = t * kTileKeys + key0;
    int j = idx / bs, off = idx - j * bs;
#pragma unroll
    for (int i = 0; i < kTileKeys / KEY_STEP; ++i) {
      const int key = key0 + i * KEY_STEP;
      const bool live = idx < k1;
      const size_t src = live ? ((((size_t)ids[j - jb0] * bs + off) * KV + h)
                                     * HD + col * CHUNK) : 0;
      tc::cp_async16(ks + key * HD + col * CHUNK, k_arena + src, live);
      tc::cp_async16(vs + key * HD + col * CHUNK, v_arena + src, live);
      idx += KEY_STEP;
      off += KEY_STEP;
      while (off >= bs) { off -= bs; ++j; }
    }
  };

  const int kid = key_of_lane(lane);
  for (int row0 = 0; row0 < R; row0 += RC) {
    float qv[RC][VEC], acc[RC][VEC], m[RC], l[RC];
    int qpos[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const int row = row0 + r;
      qpos[r] = p.cnt - W + row / G;
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int v = 0; v < VEC; ++v) { qv[r][v] = 0.f; acc[r][v] = 0.f; }
      if (row < R) {
        load_vec<float, VEC>(q + (((size_t)b * W + row / G) * H + h * G
                                  + row % G) * HD + lane * VEC, qv[r]);
#pragma unroll
        for (int v = 0; v < VEC; ++v) qv[r][v] *= qscale;
      }
    }

#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (p.t0 + st < p.t1) issue(p.t0 + st);
      tc::cp_async_commit();
    }
    for (int t = p.t0; t < p.t1; ++t) {
      tc::cp_async_wait<kStages - 2>();
      __syncthreads();          // tile t landed; tile t-1's slot is free
      if (t + kStages - 1 < p.t1) issue(t + kStages - 1);
      tc::cp_async_commit();

      const T* ks = ring + (size_t)((t - p.t0) % kStages) * 2 * TILE
                    + warp * kKeysPerWarp * HD + lane * VEC;
      const T* vs = ks + TILE;
      float kf[kKeysPerWarp][VEC];
#pragma unroll
      for (int kk = 0; kk < kKeysPerWarp; ++kk)
        load_vec<T, VEC>(ks + kk * HD, kf[kk]);
      const int idx = t * kTileKeys + warp * kKeysPerWarp + kid;
      const int stored = p.last - floor_mod(p.last - idx, p.cap);
      const bool live = idx < k1 && idx < p.cap && stored >= 0;
      float pr[RC], alpha[RC];
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        float part[kKeysPerWarp];
#pragma unroll
        for (int kk = 0; kk < kKeysPerWarp; ++kk) {
          part[kk] = 0.f;
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            part[kk] = fmaf(qv[r][v], kf[kk][v], part[kk]);
        }
        float s = reduce8(part, lane);
        bool valid = live && stored <= qpos[r];
        if (window > 0) valid = valid && qpos[r] - stored < window;
        s = valid ? s : kNegInf;
        const float m_new = fmaxf(m[r], max8(s));
        // re-mask: a fully masked slice has s == m_new == NEG_INF, where
        // exp2(s - m_new) = 1 would resurrect dead keys
        pr[r] = valid ? exp2f(s - m_new) : 0.f;
        alpha[r] = exp2f(m[r] - m_new);
        l[r] = l[r] * alpha[r] + sum8(pr[r]);
        m[r] = m_new;
      }
#pragma unroll
      for (int kk = 0; kk < kKeysPerWarp; ++kk)
        load_vec<T, VEC>(vs + kk * HD, kf[kk]);
#pragma unroll
      for (int r = 0; r < RC; ++r) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] *= alpha[r];
#pragma unroll
        for (int kk = 0; kk < kKeysPerWarp; ++kk) {
          const float pt = __shfl_sync(kFull, pr[r], lane_of_key(kk));
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[r][v] = fmaf(pt, kf[kk][v], acc[r][v]);
        }
      }
    }
    tc::cp_async_wait<0>();
    __syncthreads();            // every warp is done with the ring

    // merge the warps' partials in warp order
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      if (lane == 0) {
        red_m[warp * RC + r] = m[r];
        red_l[warp * RC + r] = l[r];
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        red_acc[(warp * RC + r) * HD + lane * VEC + v] = acc[r][v];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < RC * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, row = row0 + r;
      if (row >= R) continue;
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_m[w * RC + r]);
      float L = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = exp2f(red_m[w * RC + r] - M);
        L += red_l[w * RC + r] * e;
        a += red_acc[(w * RC + r) * HD + d] * e;
      }
      if (direct) {
        out[(((size_t)b * W + row / G) * H + h * G + row % G) * HD + d] =
            a / fmaxf(L, 1e-30f);
      } else {
        acc_out[(part0 + row) * HD + d] = a;
        if (d == 0) {
          m_out[part0 + row] = M;
          l_out[part0 + row] = L;
        }
      }
    }
    __syncthreads();            // the merge area is the next chunk's ring
  }
}

// Merges the S splits of each row in split order (exp2 domain, as the
// split kernel leaves m); a row whose request has one split was written by
// the split kernel and is skipped.
__global__ void paged_attention_combine_kernel(
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ acc_in, const int* __restrict__ pos,
    const int* __restrict__ ring_cap, float* __restrict__ out, int W, int H,
    int KV, int hd, int bs, int MB, int S, int min_keys) {
  const int G = H / KV, R = W * G;
  const size_t rows = (size_t)gridDim.x;      // B * KV * R
  const size_t row = blockIdx.x;
  const int b = (int)(row / ((size_t)KV * R));
  const int h = (int)((row / R) % KV);
  const int r = (int)(row % R);
  if (plan_of(pos[b], ring_cap[b], bs, MB, S, 0, min_keys).s_eff == 1) return;
  float m_max = kNegInf;
  for (int s = 0; s < S; ++s) m_max = fmaxf(m_max, m_in[s * rows + row]);
  float l_sum = 0.f;
  for (int s = 0; s < S; ++s)
    l_sum += l_in[s * rows + row] * exp2f(m_in[s * rows + row] - m_max);
  float* dst = out + (((size_t)b * W + r / G) * H + h * G + r % G) * hd;
  for (int dd = threadIdx.x; dd < hd; dd += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < S; ++s)
      o += acc_in[(s * rows + row) * hd + dd]
           * exp2f(m_in[s * rows + row] - m_max);
    dst[dd] = o / fmaxf(l_sum, 1e-30f);
  }
}

template <typename T, int HD, int RC>
cudaError_t launch_split(dim3 grid, const float* q, const void* k,
                         const void* v, const int* bt, const int* pos,
                         const int* ring, float* m, float* l, float* acc,
                         float* out, int W, int H, int KV, int bs, int MB,
                         int window, float qscale, int min_keys,
                         cudaStream_t st) {
  auto kernel = paged_attention_split_kernel<T, HD, RC>;
  const size_t smem = region_bytes<T, HD, RC>() + sizeof(int) * (size_t)MB;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, st>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), bt, pos, ring, m,
      l, acc, out, W, H, KV, bs, MB, window, qscale, min_keys);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_rows(int R, dim3 grid, const float* q, const void* k,
                        const void* v, const int* bt, const int* pos,
                        const int* ring, float* m, float* l, float* acc,
                        float* out, int W, int H, int KV, int bs, int MB,
                        int window, float qscale, int min_keys,
                        cudaStream_t st) {
#define PA_SPLIT(RC)                                                        \
  launch_split<T, HD, RC>(grid, q, k, v, bt, pos, ring, m, l, acc, out, W, \
                          H, KV, bs, MB, window, qscale, min_keys, st)
  if (R <= 1) return PA_SPLIT(1);
  if (R <= 2) return PA_SPLIT(2);
  if (R <= 4) return PA_SPLIT(4);
  return PA_SPLIT(8);
#undef PA_SPLIT
}

}  // namespace

// m / l / acc are (splits, B, KV, W*G[, hd]) scratch, unused (may be null)
// when splits == 1.  tile_keys must equal the kernel's kTileKeys (the
// wrapper and its plan walk read the same constant).
extern "C" int paged_attention(const float* q, const void* k_arena,
                               const void* v_arena, const int* block_table,
                               const int* pos, const int* ring_cap, float* m,
                               float* l, float* acc, float* out, int B, int W,
                               int H, int KV, int hd, int bs, int MB,
                               int window, float scale, int splits,
                               int kv_bf16, int tile_keys, int min_split_keys,
                               void* stream) {
  if (tile_keys != kTileKeys || (hd != 64 && hd != 128) || bs < 1 || MB < 1
      || splits < 1 || min_split_keys < 1 || H % KV)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = W * (H / KV);
  const dim3 grid(KV, B, splits);
  const float qscale = scale * kLog2e;
  cudaError_t e;
#define PA_ROWS(T, HD)                                                      \
  launch_rows<T, HD>(R, grid, q, k_arena, v_arena, block_table, pos,        \
                     ring_cap, m, l, acc, out, W, H, KV, bs, MB, window,     \
                     qscale, min_split_keys, st)
  if (kv_bf16)
    e = hd == 64 ? PA_ROWS(__nv_bfloat16, 64) : PA_ROWS(__nv_bfloat16, 128);
  else
    e = hd == 64 ? PA_ROWS(float, 64) : PA_ROWS(float, 128);
#undef PA_ROWS
  if (e != cudaSuccess || splits == 1) return (int)e;
  paged_attention_combine_kernel<<<B * KV * R, 128, 0, st>>>(
      m, l, acc, pos, ring_cap, out, W, H, KV, hd, bs, MB, splits,
      min_split_keys);
  return (int)cudaGetLastError();
}
