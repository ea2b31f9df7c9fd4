// Extended-RaBitQ code search + least-squares rescale, per column (Hopper).
//
// Replaces repro/kernels/rabitq_quant/quantize.py:quantize_pallas (_kernel),
// which computes exactly repro/core/rabitq.py:quantize: for each column w of
// a rotated (d, c) weight, delta0 = max(max|w|, 1e-30) / c_b, then over S
// geometric steps delta_s = delta0 * scale_s the codes
// v_s = clamp(round(w / delta_s + c_b), 0, L) - c_b and the objective
// -<w,v_s>^2 / max(<v_s,v_s>, 1e-30); the first strict minimum wins
// (argmin order), and the column's codes and rescale <w,v>/<v,v> follow.
//
// The Pallas kernel holds a (d, bc) slab in VMEM and makes S + 2 passes
// over it.  At d = 10974 a slab of any useful width exceeds a block's 227 KB
// of shared memory, so this kernel streams w from device memory three times:
//
//   1. absmax per column;
//   2. one sweep over d that accumulates <w,v_s> and <v_s,v_s> for all S
//      candidates at once, 2S registers per thread (S is a template
//      parameter, at most 16); then the choice;
//   3. the codes (u8) of the chosen step; the rescale comes from pass 2's
//      sums for that step.
//
// Layout: a CTA owns 32 adjacent columns, one per lane, so each warp's load
// of a row is 128 contiguous bytes of the row-major (d, c) w; its 16 warps
// split d by interleaved rows.  Cross-warp sums go through shared memory in
// warp order, so codes and rescales are the same run to run.
//
// Numerics follow the plain version (repro_torch/core/rabitq.py): IEEE
// division (__fdiv_rn) then the add for w / delta + c_b, delta = delta0 *
// scale as one f32 multiply, round half to even (rintf), clamp to [0, L]
// before subtracting c_b.  No fast math.  The candidate scales come in from
// the wrapper (the plain version's f32 numpy.geomspace array).
//
// What bounds it on this card: operations.  Each element costs S IEEE
// divisions plus ~7 f32 ops per candidate against 4 bytes read three times
// and one byte written; at S = 12 that is ~100x more issue slots than bytes
// at 3.35 TB/s would allow for.  The design keeps the passes over w at 3
// (not S + 2) and spends registers, not shared memory, on the S candidates.
// At c = 4096 the grid is 128 CTAs of 512 threads, one per SM: splitting d
// across CTAs (with a deterministic second pass) is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxCand = 16;
constexpr int kCols = 32;           // columns per CTA, one per lane
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;          // rows a thread loads before using any

// clamp(round(w / delta + c_b), 0, L): the code of w, as a float in [0, L].
__device__ __forceinline__ float code_of(float w, float delta, float c_b,
                                         float levels) {
  const float q = __fadd_rn(__fdiv_rn(w, delta), c_b);
  return fminf(fmaxf(rintf(q), 0.f), levels);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
rabitq_quant_kernel(const float* __restrict__ w,
                    const float* __restrict__ scales,
                    uint8_t* __restrict__ codes, float* __restrict__ rescale,
                    int32_t* __restrict__ choice, int d, int c, int bits) {
  static_assert(S >= 1 && S <= kMaxCand, "1 to 16 candidate steps");
  extern __shared__ float red[];    // [kWarps][2 * S][32]
  __shared__ float amax[kWarps][kCols];
  __shared__ float chosen[kCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kCols + lane;
  const bool live = col < c;
  const float levels = (float)((1 << bits) - 1);
  const float c_b = levels * 0.5f;  // exact

  // pass 1: per-column absmax (max is exact in any order)
  float m = 0.f;
  if (live) {
#pragma unroll 4
    for (int r = warp; r < d; r += kWarps)
      m = fmaxf(m, fabsf(__ldg(w + (size_t)r * c + col)));
  }
  amax[warp][lane] = m;
  __syncthreads();
  float absmax = 0.f;
  for (int k = 0; k < kWarps; ++k) absmax = fmaxf(absmax, amax[k][lane]);
  const float delta0 = __fdiv_rn(fmaxf(absmax, 1e-30f), c_b);
  float delta[S];
#pragma unroll
  for (int s = 0; s < S; ++s) delta[s] = __fmul_rn(delta0, __ldg(scales + s));

  // pass 2: <w,v_s> and <v_s,v_s> for every candidate in one sweep
  float wv[S], vv[S];
#pragma unroll
  for (int s = 0; s < S; ++s) wv[s] = vv[s] = 0.f;
  if (live) {
    int r = warp;
    for (; r + (kUnroll - 1) * kWarps < d; r += kUnroll * kWarps) {
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        x[u] = __ldg(w + (size_t)(r + u * kWarps) * c + col);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float v = code_of(x[u], delta[s], c_b, levels) - c_b;
          wv[s] = fmaf(x[u], v, wv[s]);
          vv[s] = fmaf(v, v, vv[s]);
        }
    }
    for (; r < d; r += kWarps) {
      const float x = __ldg(w + (size_t)r * c + col);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float v = code_of(x, delta[s], c_b, levels) - c_b;
        wv[s] = fmaf(x, v, wv[s]);
        vv[s] = fmaf(v, v, vv[s]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    red[(warp * 2 * S + s) * 32 + lane] = wv[s];
    red[(warp * 2 * S + S + s) * 32 + lane] = vv[s];
  }
  __syncthreads();
  if (warp == 0) {
    float best_err = INFINITY, best_wv = 0.f, best_vv = 0.f;
    int best = 0;
    for (int s = 0; s < S; ++s) {
      float a = 0.f, b = 0.f;
      for (int k = 0; k < kWarps; ++k) {      // warp order: deterministic
        a += red[(k * 2 * S + s) * 32 + lane];
        b += red[(k * 2 * S + S + s) * 32 + lane];
      }
      const float err = __fdiv_rn(-(a * a), fmaxf(b, 1e-30f));
      if (err < best_err) {                   // first strict minimum
        best_err = err;
        best = s;
        best_wv = a;
        best_vv = b;
      }
    }
    chosen[lane] = __fmul_rn(delta0, __ldg(scales + best));
    if (live) {
      rescale[col] =
          best_vv > 0.f ? __fdiv_rn(best_wv, fmaxf(best_vv, 1e-30f)) : 0.f;
      if (choice != nullptr) choice[col] = best;
    }
  }
  __syncthreads();

  // pass 3: the chosen step's codes
  const float dl = chosen[lane];
  if (!live) return;
  int r = warp;
  for (; r + (kUnroll - 1) * kWarps < d; r += kUnroll * kWarps) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      x[u] = __ldg(w + (size_t)(r + u * kWarps) * c + col);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      codes[(size_t)(r + u * kWarps) * c + col] =
          (uint8_t)code_of(x[u], dl, c_b, levels);
  }
  for (; r < d; r += kWarps)
    codes[(size_t)r * c + col] =
        (uint8_t)code_of(__ldg(w + (size_t)r * c + col), dl, c_b, levels);
}

template <int S>
cudaError_t launch(const float* w, const float* scales, uint8_t* codes,
                   float* rescale, int32_t* choice, int d, int c, int bits,
                   cudaStream_t st) {
  // opt in every time: at S = 12 the reduction buffer alone is 48 KB
  const size_t smem = (size_t)kWarps * 2 * S * 32 * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      rabitq_quant_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int blocks = (c + kCols - 1) / kCols;
  rabitq_quant_kernel<S><<<blocks, kThreads, smem, st>>>(
      w, scales, codes, rescale, choice, d, c, bits);
  return cudaGetLastError();
}

}  // namespace

// codes (d, c) u8, rescale (c,) f32 and, when choice is not null, the chosen
// candidate per column (c,) int32, for w (d, c) f32 row-major.
extern "C" int rabitq_quant(const float* w, const float* scales,
                            uint8_t* codes, float* rescale, int32_t* choice,
                            int d, int c, int bits, int n_cand, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits < 1 || bits > 8 || d < 1) return cudaErrorInvalidValue;
  switch (n_cand) {
#define RABITQ_CASE(S) \
    case S: return launch<S>(w, scales, codes, rescale, choice, d, c, bits, st);
    RABITQ_CASE(1) RABITQ_CASE(2) RABITQ_CASE(3) RABITQ_CASE(4)
    RABITQ_CASE(5) RABITQ_CASE(6) RABITQ_CASE(7) RABITQ_CASE(8)
    RABITQ_CASE(9) RABITQ_CASE(10) RABITQ_CASE(11) RABITQ_CASE(12)
    RABITQ_CASE(13) RABITQ_CASE(14) RABITQ_CASE(15) RABITQ_CASE(16)
#undef RABITQ_CASE
    default: return cudaErrorInvalidValue;
  }
}
