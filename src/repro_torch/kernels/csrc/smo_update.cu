// SMO rank-2 indicator update, out = f + delta * (K_i - K_j), in float64,
// for one row of n or for rows of n, each with its own delta.
//
// Replaces the Pallas kernel src/repro/kernels/smo_update.py::smo_f_update
// (_fupdate_kernel). Bound by bytes: three (n,) streams in, one out, one FMA
// per element. A grid-stride loop with neighbouring threads on neighbouring
// elements keeps every load coalesced; delta is read from device memory so
// the caller never syncs to pass it. Rows (ATO's alpha update over a row of
// lanes, one eta a lane) run row r on blockIdx.y = r, the same code as one
// row, so each row is what the one-row launch gives it.
#include <cuda_runtime.h>

#include "smo_common.cuh"

__global__ void smo_f_update_kernel(const double* __restrict__ f,
                                    const double* __restrict__ ki,
                                    const double* __restrict__ kj,
                                    const double* __restrict__ delta,
                                    double* __restrict__ out, long long n) {
  const long long row = (long long)blockIdx.y * n;
  const double d = delta[blockIdx.y];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += stride)
    out[row + k] = smo_f_update_elem(f[row + k], ki[row + k], kj[row + k], d);
}

// rows x n: row r of out = f + delta[r] * (ki - kj), row r of each (one row:
// the (n,) update with its scalar delta).
extern "C" int smo_f_update_f64(const double* f, const double* ki,
                                const double* kj, const double* delta,
                                double* out, long long n, int rows,
                                cudaStream_t stream) {
  if (n > 0 && rows > 0) {
    if (rows > 65535) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    long long cap = 132 * 32 / rows;
    if (cap < 1) cap = 1;
    if (blocks > cap) blocks = cap;
    smo_f_update_kernel<<<dim3((unsigned)blocks, rows), threads, 0, stream>>>(
        f, ki, kj, delta, out, n);
  }
  return (int)cudaGetLastError();
}
