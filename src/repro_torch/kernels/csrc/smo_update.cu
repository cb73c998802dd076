// SMO rank-2 indicator update, out = f + delta * (K_i - K_j), in float64.
//
// Replaces the Pallas kernel src/repro/kernels/smo_update.py::smo_f_update
// (_fupdate_kernel). Bound by bytes: three (n,) streams in, one out, one FMA
// per element. A grid-stride loop with neighbouring threads on neighbouring
// elements keeps every load coalesced; delta is read from device memory so
// the caller never syncs to pass it.
#include <cuda_runtime.h>

#include "smo_common.cuh"

__global__ void smo_f_update_kernel(const double* __restrict__ f,
                                    const double* __restrict__ ki,
                                    const double* __restrict__ kj,
                                    const double* __restrict__ delta,
                                    double* __restrict__ out, long long n) {
  const double d = *delta;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += stride)
    out[k] = smo_f_update_elem(f[k], ki[k], kj[k], d);
}

extern "C" int smo_f_update_f64(const double* f, const double* ki,
                                const double* kj, const double* delta,
                                double* out, long long n, cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    smo_f_update_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        f, ki, kj, delta, out, n);
  }
  return (int)cudaGetLastError();
}
