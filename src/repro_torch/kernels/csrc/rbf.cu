// Tiled RBF kernel matrix:
//   K[r, c] = exp(-gamma * max(xn[r] + zn[c] - 2 * sum_k X[r, k] Z[c, k], 0))
// for X (n, d), Z (m, d), row norms xn (n,), zn (m,) precomputed; float64 and
// float32.
//
// Replaces the Pallas kernel src/repro/kernels/rbf.py::rbf_kernel_matrix
// (_rbf_kernel). The TPU kernel accumulates the cross term on the MXU over
// (128, 128, 512) tiles; Hopper's wgmma has no float64 type, so this first
// version runs the contraction on the FP64 (or FP32) FMA pipes instead: a
// BM x BN output tile per block, X and Z slabs of depth BK staged through
// shared memory (stored k-major so a warp reads neighbouring words), a TM x TN
// register tile per thread, the clamp and exp fused into the epilogue. The
// ragged edges are masked in the kernel; nothing is padded on the host.
//
// Bound: 2*n*m*d operations at the card's FP64 rate against n*m*8 bytes
// written at 3.35 TB/s (the write dominates at d = 123 only when the FMA
// pipes run near peak). The float32 variant stays full float32: no tensor
// cores, so nothing rounds to TF32.
//
// Each output's sum runs k = 0 .. d-1 in order whatever the tile shape, so
// two tile shapes give identical results (chip_smoke.py checks it).
#include <cuda_runtime.h>

template <typename T>
__device__ __forceinline__ T exp_t(T x);
template <>
__device__ __forceinline__ double exp_t<double>(double x) { return exp(x); }
template <>
__device__ __forceinline__ float exp_t<float>(float x) { return expf(x); }

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
rbf_kernel(const T* __restrict__ X, const T* __restrict__ Z,
           const T* __restrict__ xn, const T* __restrict__ zn,
           T* __restrict__ out, int n, int m, int d, T neg_gamma) {
  constexpr int TX = BN / TN;  // threads along a row of the tile
  constexpr int TY = BM / TM;
  constexpr int NT = TX * TY;
  __shared__ T xs[BK][BM + 1];
  __shared__ T zs[BK][BN + 1];

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  T acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = T(0);

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += NT) {
      const int r = e / BK, kk = e % BK, gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < n && gk < d) ? X[(size_t)gr * d + gk] : T(0);
    }
    for (int e = threadIdx.x; e < BN * BK; e += NT) {
      const int c = e / BK, kk = e % BK, gc = col0 + c, gk = k0 + kk;
      zs[kk][c] = (gc < m && gk < d) ? Z[(size_t)gc * d + gk] : T(0);
    }
    __syncthreads();
    const int kmax = min(BK, d - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      T xa[TM], zb[TN];
#pragma unroll
      for (int a = 0; a < TM; ++a) xa[a] = xs[kk][ty + a * TY];
#pragma unroll
      for (int b = 0; b < TN; ++b) zb[b] = zs[kk][tx + b * TX];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) acc[a][b] = fma(xa[a], zb[b], acc[a][b]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int r = row0 + ty + a * TY;
    if (r >= n) continue;
    const T xr = xn[r];
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      const int c = col0 + tx + b * TX;
      if (c >= m) continue;
      T d2 = xr + zn[c] - T(2) * acc[a][b];
      d2 = d2 < T(0) ? T(0) : d2;  // max(d2, 0), NaN kept
      out[(size_t)r * m + c] = exp_t<T>(neg_gamma * d2);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
static void launch(const T* X, const T* Z, const T* xn, const T* zn, T* out,
                   int n, int m, int d, T neg_gamma, cudaStream_t stream) {
  const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  rbf_kernel<T, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      X, Z, xn, zn, out, n, m, d, neg_gamma);
}

// tile 64: 64 x 64 outputs per block, 4 x 4 per thread; tile 32: 32 x 32, 2 x 2.
template <typename T>
static int rbf_entry(const T* X, const T* Z, const T* xn, const T* zn, T* out,
                     int n, int m, int d, double gamma, int tile,
                     cudaStream_t stream) {
  if (n > 0 && m > 0) {
    const T neg_gamma = T(-gamma);
    if (tile == 32)
      launch<T, 32, 32, 32, 2, 2>(X, Z, xn, zn, out, n, m, d, neg_gamma, stream);
    else
      launch<T, 64, 64, 16, 4, 4>(X, Z, xn, zn, out, n, m, d, neg_gamma, stream);
  }
  return (int)cudaGetLastError();
}

extern "C" int rbf_kernel_matrix_f64(const double* X, const double* Z,
                                     const double* xn, const double* zn,
                                     double* out, int n, int m, int d,
                                     double gamma, int tile,
                                     cudaStream_t stream) {
  return rbf_entry<double>(X, Z, xn, zn, out, n, m, d, gamma, tile, stream);
}

extern "C" int rbf_kernel_matrix_f32(const float* X, const float* Z,
                                     const float* xn, const float* zn,
                                     float* out, int n, int m, int d,
                                     double gamma, int tile,
                                     cudaStream_t stream) {
  return rbf_entry<float>(X, Z, xn, zn, out, n, m, d, gamma, tile, stream);
}
