// Randomized Hadamard transform over rows (Hopper): out = practical_rht(x).
//
// Replaces repro/kernels/hadamard/hadamard.py:rht_pallas (_kernel), which
// computes H(D x) for a power-of-2 d as two Kronecker matmuls on the MXU per
// row tile; the reference's practical_rht (hadamard/ops.py) calls it twice
// for a d that is not a power of 2.  Here one launch does both blocks of
// Alg. 5 in the same CTA (fwht.cuh): the second block reads the first
// block's output from shared memory, so the overlap never round-trips
// through device memory and the row is read and written once.
//
// What bounds it on this card: bytes.  The butterfly does d*log2(d) f32 adds
// per row from shared memory, against 8 bytes of device traffic per element;
// at n <= 64 rows (the unfused decode and prefill path) one CTA per row
// leaves most SMs idle, so the call is latency-bound, not bandwidth-bound.
// A row fits shared memory up to d = 16384 (64 KB + signs); wider rows are
// refused by the wrapper.
#include <cuda_runtime.h>

#include "fwht.cuh"

extern "C" int rht(const float* x, const float* signs1, const float* signs2,
                   float* out, int n, int d, int d_hat, void* stream) {
  return fwht::launch_rotate(x, signs1, signs2, out, nullptr, n, d, d_hat, d,
                             static_cast<cudaStream_t>(stream));
}
