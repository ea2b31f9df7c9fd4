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
// The Pallas kernel holds a (d, bc) slab in VMEM and makes S + 2 passes over
// it.  Here a thread-block cluster of P CTAs (P in {1, 2, 4, 8}, from
// kernels/rabitq_quant/ops.py:search_plan) owns 32 adjacent columns, one
// per lane, and splits d into P slices of rows; each CTA's 8 warps split
// its slice by interleaved rows.  Three passes over w:
//
//   1. absmax of the slice; the cluster's maximum through distributed
//      shared memory (max is exact in any order);
//   2. one sweep that accumulates <w,v_s> and <v_s,v_s> for all S
//      candidates at once, 2S registers per thread (S a template parameter,
//      at most 16); warps summed in warp order, then the P slices' sums in
//      cluster-rank order, by every CTA of the cluster alike, so all of them
//      choose the same step and the result does not vary run to run;
//   3. the codes (u8) of the chosen step for the CTA's own slice; the
//      rescale comes from pass 2's sums for that step.
//
// Numerics follow the plain version (repro_torch/core/rabitq.py): w / delta
// rounded as IEEE division rounds it, then the add of c_b, delta = delta0 *
// scale as one f32 multiply, round half to even (rintf), clamp to [0, L]
// before subtracting c_b.  No fast math.  The division is taken from the
// correctly rounded reciprocal of delta (div_by: a multiply and two fmas,
// with no branch to a slow path, so the S candidates interleave); it equals
// __fdiv_rn bit for bit on every pair of f32 mantissas (checked on the card
// by div_sweep over all 2^46 pairs, chip_smoke.py --code-search), and a
// column whose absmax is below 2^-60, where the remainder could underflow,
// takes __fdiv_rn.  With __fdiv_rn in its place everywhere the same kernel
// took 1.6-1.7x as long at every timed shape (PERF.md §6).  The
// candidate scales come in from the wrapper (the plain version's f32
// numpy.geomspace array).
//
// What bounds it on this card: operations.  Each element costs, per
// candidate, the division (3 instructions), the add, rint, the clamp (2),
// the subtract and 2 fmas: about 10 f32 instructions, 120 at S = 12, against
// 4 bytes read and 1 written.  The design feeds the issue slots: 256-thread
// CTAs of at most 85 registers (3 per SM), 8 rows' loads in flight per
// thread, and no data-dependent branch in the sweep.  The Pallas kernel
// keeps its slab in VMEM between passes; here eight slices (about 510 rows
// x 128 B at the pipeline's d) keep what the resident CTAs read between
// the three passes over w to 26 MB, against a 50 MB L2; how much of it
// stays there is unmeasured (the passes take half the time).  A slab kept
// in shared memory read w once but left one or two CTAs per SM, and was
// slower at every pipeline shape (PERF.md §6).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCand = 16;
constexpr int kMaxSlices = 8;       // the portable cluster size
constexpr int kCols = 32;           // columns per CTA, one per lane
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;          // rows a thread loads before using any
constexpr float kTinyColumn = 0x1p-60f;

// RN(w / delta) from rcp = RN(1 / delta): q0 = RN(w * rcp) is within about
// an ulp of the quotient, its remainder w - q0 * delta is exact in one fma,
// and RN(q0 + rem * rcp) is the correctly rounded quotient (Markstein), as
// long as the remainder does not underflow: for |w| >= 2^-100 with a normal
// delta.  Where |w| < 2^-100 in a column whose absmax is at least 2^-60,
// |w / delta| < 2^-34 and w / delta + c_b rounds to c_b either way.
__device__ __forceinline__ float div_by(float w, float delta, float rcp) {
  const float q0 = __fmul_rn(w, rcp);
  const float rem = __fmaf_rn(-q0, delta, w);
  return __fmaf_rn(rem, rcp, q0);
}

// clamp(round(w / delta + c_b), 0, L): the code of w, as a float in [0, L].
template <bool kIeee>
__device__ __forceinline__ float code_of(float w, float delta, float rcp,
                                         float c_b, float levels) {
  const float q = kIeee ? __fdiv_rn(w, delta) : div_by(w, delta, rcp);
  return fminf(fmaxf(rintf(__fadd_rn(q, c_b)), 0.f), levels);
}

// Pass 2 over rows [r0, r1) of one column, this warp's interleaved rows.
template <int S, bool kIeee>
__device__ __forceinline__ void sweep(const float* __restrict__ col, int c,
                                      int r0, int r1, int warp,
                                      const float (&delta)[S],
                                      const float (&rcp)[S], float c_b,
                                      float levels, float (&wv)[S],
                                      float (&vv)[S]) {
  int r = r0 + warp;
  for (; r + (kUnroll - 1) * kWarps < r1; r += kUnroll * kWarps) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      x[u] = __ldg(col + (size_t)(r + u * kWarps) * c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float v =
            code_of<kIeee>(x[u], delta[s], rcp[s], c_b, levels) - c_b;
        wv[s] = fmaf(x[u], v, wv[s]);
        vv[s] = fmaf(v, v, vv[s]);
      }
  }
  for (; r < r1; r += kWarps) {
    const float x = __ldg(col + (size_t)r * c);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float v = code_of<kIeee>(x, delta[s], rcp[s], c_b, levels) - c_b;
      wv[s] = fmaf(x, v, wv[s]);
      vv[s] = fmaf(v, v, vv[s]);
    }
  }
}

// Pass 3: the chosen step's codes for rows [r0, r1) of one column (col and
// codes point at the column's first element).
template <bool kIeee>
__device__ __forceinline__ void write_codes(const float* __restrict__ col,
                                            uint8_t* __restrict__ codes,
                                            int c, int r0, int r1, int warp,
                                            float dl, float rl, float c_b,
                                            float levels) {
  int r = r0 + warp;
  for (; r + (kUnroll - 1) * kWarps < r1; r += kUnroll * kWarps) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      x[u] = __ldg(col + (size_t)(r + u * kWarps) * c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      codes[(size_t)(r + u * kWarps) * c] =
          (uint8_t)code_of<kIeee>(x[u], dl, rl, c_b, levels);
  }
  for (; r < r1; r += kWarps)
    codes[(size_t)r * c] = (uint8_t)code_of<kIeee>(
        __ldg(col + (size_t)r * c), dl, rl, c_b, levels);
}

template <int S>
__global__ void __launch_bounds__(kThreads, S <= 12 ? 3 : 2)
rabitq_quant_kernel(const float* __restrict__ w,
                    const float* __restrict__ scales,
                    uint8_t* __restrict__ codes, float* __restrict__ rescale,
                    int32_t* __restrict__ choice, int d, int c, int bits) {
  static_assert(S >= 1 && S <= kMaxCand, "1 to 16 candidate steps");
  __shared__ float red[kWarps][2 * S][kCols];   // warps' sums; [0]: totals
  __shared__ float slice_sum[2 * S][kCols];     // read by the cluster
  __shared__ float amax[kWarps][kCols];
  __shared__ float slice_amax[kCols];           // read by the cluster
  __shared__ float chosen[2][kCols];            // the step and its reciprocal
  cg::cluster_group cluster = cg::this_cluster();
  const int slices = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.y * kCols + lane;
  const bool live = col < c;
  const int per = (d + slices - 1) / slices;
  const int r0 = min(d, rank * per), r1 = min(d, r0 + per);
  const float levels = (float)((1 << bits) - 1);
  const float c_b = levels * 0.5f;  // exact

  // pass 1: absmax of the slice, then of the column (kUnroll rows' loads in
  // flight per thread, as in the later passes)
  float m = 0.f;
  if (live) {
    int r = r0 + warp;
    for (; r + (kUnroll - 1) * kWarps < r1; r += kUnroll * kWarps) {
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        x[u] = __ldg(w + (size_t)(r + u * kWarps) * c + col);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m = fmaxf(m, fabsf(x[u]));
    }
    for (; r < r1; r += kWarps)
      m = fmaxf(m, fabsf(__ldg(w + (size_t)r * c + col)));
  }
  amax[warp][lane] = m;
  __syncthreads();
  if (warp == 0) {
    float a = 0.f;
    for (int k = 0; k < kWarps; ++k) a = fmaxf(a, amax[k][lane]);
    slice_amax[lane] = a;
  }
  cluster.sync();
  float absmax = 0.f;
  for (int q = 0; q < slices; ++q)
    absmax = fmaxf(absmax, cluster.map_shared_rank(&slice_amax[0], q)[lane]);
  const float delta0 = __fdiv_rn(fmaxf(absmax, 1e-30f), c_b);
  float delta[S], rcp[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    delta[s] = __fmul_rn(delta0, __ldg(scales + s));
    rcp[s] = __frcp_rn(delta[s]);
  }
  // every warp of the cluster holds the same 32 columns: the same choice
  const bool ieee = __any_sync(0xffffffffu, live && absmax < kTinyColumn);

  // pass 2: <w,v_s> and <v_s,v_s> for every candidate in one sweep
  const float* src = w + col;
  float wv[S], vv[S];
#pragma unroll
  for (int s = 0; s < S; ++s) wv[s] = vv[s] = 0.f;
  if (live) {
    if (ieee)
      sweep<S, true>(src, c, r0, r1, warp, delta, rcp, c_b, levels, wv, vv);
    else
      sweep<S, false>(src, c, r0, r1, warp, delta, rcp, c_b, levels, wv, vv);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    red[warp][s][lane] = wv[s];
    red[warp][S + s][lane] = vv[s];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * S * kCols; i += kThreads) {
    float a = 0.f;
    for (int k = 0; k < kWarps; ++k)              // warp order
      a += red[k][i / kCols][i % kCols];
    slice_sum[i / kCols][i % kCols] = a;
  }
  cluster.sync();
  for (int i = threadIdx.x; i < 2 * S * kCols; i += kThreads) {
    float a = 0.f;
    for (int q = 0; q < slices; ++q)              // cluster-rank order
      a += cluster.map_shared_rank(&slice_sum[0][0], q)[i];
    red[0][i / kCols][i % kCols] = a;
  }
  __syncthreads();
  if (warp == 0) {
    float best_err = INFINITY, best_wv = 0.f, best_vv = 0.f;
    int best = 0;
    for (int s = 0; s < S; ++s) {
      const float a = red[0][s][lane], b = red[0][S + s][lane];
      const float err = __fdiv_rn(-(a * a), fmaxf(b, 1e-30f));
      if (err < best_err) {                       // first strict minimum
        best_err = err;
        best = s;
        best_wv = a;
        best_vv = b;
      }
    }
    const float dl = __fmul_rn(delta0, __ldg(scales + best));
    chosen[0][lane] = dl;
    chosen[1][lane] = __frcp_rn(dl);
    if (live && rank == 0) {
      rescale[col] =
          best_vv > 0.f ? __fdiv_rn(best_wv, fmaxf(best_vv, 1e-30f)) : 0.f;
      if (choice != nullptr) choice[col] = best;
    }
  }
  __syncthreads();

  // pass 3: the chosen step's codes for this slice
  if (live) {
    if (ieee)
      write_codes<true>(src, codes + col, c, r0, r1, warp, chosen[0][lane],
                        chosen[1][lane], c_b, levels);
    else
      write_codes<false>(src, codes + col, c, r0, r1, warp, chosen[0][lane],
                         chosen[1][lane], c_b, levels);
  }
  cluster.sync();     // no CTA leaves while a peer may read its sums
}

template <int S>
cudaError_t launch(const float* w, const float* scales, uint8_t* codes,
                   float* rescale, int32_t* choice, int d, int c, int bits,
                   int slices, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices, (c + kCols - 1) / kCols, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, rabitq_quant_kernel<S>, w,
                                           scales, codes, rescale, choice, d,
                                           c, bits);
  cudaGetLastError();     // a refused launch leaves no error behind
  return e;
}

// Counts the w mantissas in [1, 2) whose div_by differs from __fdiv_rn for
// delta = 1 + (first + stride * blockIdx.y) * 2^-23.
__global__ void div_sweep_kernel(unsigned first, unsigned stride,
                                 unsigned long long* bad) {
  const float delta =
      __uint_as_float(0x3f800000u | (first + stride * blockIdx.y));
  const float rcp = __frcp_rn(delta);
  unsigned n = 0;
  for (unsigned m = blockIdx.x * blockDim.x + threadIdx.x; m < (1u << 23);
       m += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(0x3f800000u | m);
    n += __float_as_uint(div_by(x, delta, rcp)) !=
         __float_as_uint(__fdiv_rn(x, delta));
  }
  for (int off = 16; off > 0; off >>= 1)
    n += __shfl_down_sync(0xffffffffu, n, off);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(bad, (unsigned long long)n);
}

}  // namespace

// codes (d, c) u8, rescale (c,) f32 and, when choice is not null, the chosen
// candidate per column (c,) int32, for w (d, c) f32 row-major; d split into
// `slices` (1, 2, 4 or 8) row slices, one CTA of a cluster each.
extern "C" int rabitq_quant(const float* w, const float* scales,
                            uint8_t* codes, float* rescale, int32_t* choice,
                            int d, int c, int bits, int n_cand, int slices,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits < 1 || bits > 8 || d < 1 || c < 1 || slices < 1 ||
      slices > kMaxSlices || (slices & (slices - 1)) ||
      (c + kCols - 1) / kCols > 65535)
    return cudaErrorInvalidValue;
  switch (n_cand) {
#define RABITQ_CASE(S) \
    case S: return launch<S>(w, scales, codes, rescale, choice, d, c, bits, slices, st);
    RABITQ_CASE(1) RABITQ_CASE(2) RABITQ_CASE(3) RABITQ_CASE(4)
    RABITQ_CASE(5) RABITQ_CASE(6) RABITQ_CASE(7) RABITQ_CASE(8)
    RABITQ_CASE(9) RABITQ_CASE(10) RABITQ_CASE(11) RABITQ_CASE(12)
    RABITQ_CASE(13) RABITQ_CASE(14) RABITQ_CASE(15) RABITQ_CASE(16)
#undef RABITQ_CASE
    default: return cudaErrorInvalidValue;
  }
}

// Adds to *bad the pairs (x, delta), x and delta over f32 mantissas in
// [1, 2) (x all 2^23 of them; delta first + stride * k for k < count),
// where the kernel's division differs from IEEE division.  Division by
// powers of 2 scales both alike, so the mantissa pairs cover every pair of
// normal operands whose remainder does not underflow.
extern "C" int rabitq_div_sweep(unsigned first, unsigned count,
                                unsigned stride, unsigned long long* bad,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (unsigned k = 0; k < count; k += 65535) {
    const unsigned part = count - k < 65535 ? count - k : 65535;
    div_sweep_kernel<<<dim3(128, part), 256, 0, st>>>(first + stride * k,
                                                      stride, bad);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}
