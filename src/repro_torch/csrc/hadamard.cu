// Randomized Hadamard transform over rows (Hopper): out = practical_rht(x).
//
// Replaces repro/kernels/hadamard/hadamard.py:rht_pallas (_kernel), which
// computes H(D x) for a power-of-2 d as two Kronecker matmuls on the MXU per
// row tile; the reference's practical_rht (hadamard/ops.py) calls it twice
// for a d that is not a power of 2.  Here one launch does both blocks of
// Alg. 5 in the same CTA (fwht.cuh): each thread holds its share of a block
// in registers, the butterflies run in registers and warp shuffles with one
// shared-memory transpose per block, and block 2 reads block 1's overlap
// and the row's tail (copied by cp.async at the start) from shared memory,
// so the row crosses device memory once each way.
//
// What bounds it on this card: latency, then bytes.  At the decode path's
// n = 8-16 rows one CTA per row leaves most of the 132 SMs idle, and a row
// costs a load latency, 1-3 barriers and its shuffles (5 per value); the
// 8 bytes per element of device traffic are far below what a launch costs.
// Rows up to d = 32767 (d_hat 16384) fit shared memory.
//
// Two C entries: rht (rows padded with zeros to out_ld and, when rowsum is
// not null, each rotated row's sum: what the fused GEMM's rotation writes)
// and noop, an empty kernel whose launch time is the card's launch floor.
#include <cuda_runtime.h>

#include "fwht.cuh"

namespace {
__global__ void noop_kernel() {}
}  // namespace

extern "C" int rht(const float* x, const float* signs1, const float* signs2,
                   float* out, float* rowsum, int n, int d, int d_hat,
                   int out_ld, int threads, int per_thread, void* stream) {
  return fwht::launch_rotate(x, signs1, signs2, out, rowsum, n, d, d_hat,
                             out_ld, threads, per_thread,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
