// Tiled RBF kernel matrix:
//   K[r, c] = exp(-gamma * max(xn[r] + zn[c] - 2 * sum_k X[r, k] Z[c, k], 0))
// for X (n, d), Z (m, d), row norms xn (n,), zn (m,) precomputed; float64 and
// float32. Replaces the Pallas kernel src/repro/kernels/rbf.py::
// rbf_kernel_matrix (_rbf_kernel), which accumulates the cross term on the
// TPU's MXU over (128, 128, 512) tiles. Two kernels, two routes:
//
// rbf_tc_kernel (route "tensor", every float64 build): the cross term on the
// FP64 tensor cores (mma.m16n8k4, dmma16 in smo_common.cuh), whose rate is
// twice the FP64 FMA pipes'. A persistent grid walks B x B output tiles (B =
// 128, 64 or 32; kernels/rbf.py::tensor_tile picks it from the tiles an SM
// gets). Each tile streams its X and Z rows through a two-stage cp.async
// ring of 32-feature slabs, so the next slab's loads overlap this slab's
// products and the next tile's first slab loads during this tile's
// epilogue; the tile's norms come with its first slab. At B = 128, 16 warps
// each own 32 x 32 outputs as 2 x 4 fragments (registers cap a thread at
// 128 there), the next k-step's fragments loaded before this step's
// products. The epilogue keeps the FMA kernel's expressions and order and
// stores 64-byte row segments with streaming (evict-first) 16-byte stores:
// K (8.5 GB at the paper's n = 32,560) is never read back from L2. For
// K(X, X) (Z is X: the SVM paths always ask for it) only tiles with row
// tile <= column tile are computed, and each off-diagonal tile is written
// twice, once as is and once transposed (a shuffle between neighbouring
// rows makes the transposed stores 16 bytes too): fma(a, b, c) ==
// fma(b, a, c) and xn[r] + xn[c] == xn[c] + xn[r], so K[c, r] computed
// directly would give the same bits.
//
// Bound: 2 n m d operations at 67 TFLOP/s (FP64 tensor cores) against the
// n m 8 bytes written at 3.35 TB/s: operations at d = 123 for distinct
// operands, bytes for K(X, X), whose operations halve. What holds it back
// on an H100 (chip_rbf_variants.py splits a launch's time by phase): the
// products run near the tensor cores' rate, but every warp stops for the
// next slab's copies after each barrier and for the epilogue, whose exps
// (15 FP64 operations each) share the FP64 pipe with the products, so
// neither overlaps the products.
//
// rbf_kernel (route "fma": float32, and float64's witness): the cross term
// on the FMA pipes, a BM x BN output tile per block, X and Z slabs of depth
// BK staged through shared memory (stored k-major so a warp reads
// neighbouring words), a TM x TN register tile per thread. float32 stays
// here, full float32: no tensor cores, so nothing rounds to TF32.
//
// Bitwise: every output's sum is a chain of fmas over k = 0 .. d-1 in
// order, from +0, in either kernel and any tile shape; the tensor cores
// round each m16n8k4 step like four such fmas (on every input tried;
// chip_smoke.py and the card tests hold the two kernels equal bit for bit).
// A slab past d is zero in shared memory: fma(0, 0, acc) == acc for any
// acc but -0, which only changes the sign of a zero dot product, and
// xn[r] + zn[c] - 2 * acc is the same for either sign.
#include <cuda_runtime.h>

#include <cstdint>

#include "smo_common.cuh"

template <typename T>
__device__ __forceinline__ T exp_t(T x);
template <>
__device__ __forceinline__ double exp_t<double>(double x) { return exp(x); }
template <>
__device__ __forceinline__ float exp_t<float>(float x) { return expf(x); }

// K[r, c] from the dot product and the norms (both kernels).
template <typename T>
__device__ __forceinline__ T rbf_value(T xr, T zc, T acc, T neg_gamma) {
  T d2 = xr + zc - T(2) * acc;
  d2 = d2 < T(0) ? T(0) : d2;  // max(d2, 0), NaN kept
  return exp_t<T>(neg_gamma * d2);
}

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
      out[(size_t)r * m + c] = rbf_value<T>(xr, zn[c], acc[a][b], neg_gamma);
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

// ---------------------------------------------------------------------------
// The tensor-core kernel (float64)
// ---------------------------------------------------------------------------

namespace {

constexpr int kSlab = 32;        // features per staged slab
constexpr int kRow = kSlab + 4;  // a staged row's stride: the fragment loads
                                 // (4 rows x 4 features a half-warp) hit
                                 // distinct banks
constexpr int kStages = 2;       // slabs in flight

// A B x B output tile, warps of WM x WN outputs. Shared memory: the ring of
// slabs (X's B rows, then Z's), and the norms of kStages tiles (the slabs
// in flight span at most that many).
template <int B, int WM, int WN>
struct TcTile {
  static constexpr int kWarpsN = B / WN;
  static constexpr int kThreads = 32 * (B / WM) * kWarpsN;
  static constexpr int FM = WM / 16, FN = WN / 8;  // fragments a warp
  static constexpr int kStage = 2 * B * kRow;      // doubles
  static constexpr size_t kSmem =
      (size_t)kStages * (kStage + 2 * B) * sizeof(double);
};

// Output tile p's row and column tiles: row-major over tiles_n column
// tiles, or, for K(X, X), the p-th (i, j) with i <= j in the order j (j +
// 1) / 2 + i.
__device__ __forceinline__ void tile_at(long long p, int tiles_n, bool sym,
                                        int& i, int& j) {
  if (!sym) {
    i = (int)(p / tiles_n);
    j = (int)(p % tiles_n);
    return;
  }
  long long jj = (long long)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
  while (jj * (jj + 1) / 2 > p) --jj;
  while ((jj + 1) * (jj + 2) / 2 <= p) ++jj;
  j = (int)jj;
  i = (int)(p - jj * (jj + 1) / 2);
}

// Two features of a staged row: one 16-byte cp.async where rows start at
// 16-byte boundaries (al16: an even d, or rows padded by kernels/
// smo_chunk.py::pad_rows, whose zero column past an odd d is read), else
// one 8-byte cp.async a feature; zeros where the row or a feature lies past
// the operand.
__device__ __forceinline__ void copy2(double* dst, const double* src,
                                     bool row_ok, int kleft, bool al16) {
  if (row_ok && al16 && kleft > 0) {
    cp_async<16>(dst, src);
    return;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (row_ok && e < kleft)
      cp_async<8>(dst + e, src + e);
    else
      dst[e] = 0.0;
  }
}

// Two values of one row of K at columns (c, c + 1), c even, with a
// streaming store: one 16-byte store where rows start at 16-byte
// boundaries (vec), else one or two 8-byte ones.
__device__ __forceinline__ void store_pair(double* p, double v0, double v1,
                                           bool vec, bool has1) {
  if (vec) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v0, v1));
  } else {
    __stcs(p, v0);
    if (has1) __stcs(p + 1, v1);
  }
}

template <int B, int WM, int WN, int MINB>
__global__ void __launch_bounds__(TcTile<B, WM, WN>::kThreads, MINB)
rbf_tc_kernel(const double* __restrict__ X, const double* __restrict__ Z,
              long long ldx, long long ldz, const double* __restrict__ xn,
              const double* __restrict__ zn, double* __restrict__ out, int n,
              int m, int d, double neg_gamma, int sym_flag, int al16_flag,
              int tiles_n, long long ntiles) {
  using S = TcTile<B, WM, WN>;
  constexpr int NT = S::kThreads, FM = S::FM, FN = S::FN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);
  double* norms = ring + kStages * S::kStage;  // [kStages][2 B]
  const bool sym = sym_flag != 0, al16 = al16_flag != 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / S::kWarpsN * WM, wc = warp % S::kWarpsN * WN;
  const int nslabs = (d + kSlab - 1) / kSlab;
  const bool vec = m % 2 == 0;  // K's rows (and, for K(X, X), columns) at
                                // 16-byte boundaries

  // The slabs in flight: this block's tiles in turn, each d / kSlab slabs,
  // a tile's norms with its first. kSlab / 2 neighbouring threads copy one
  // row's slab; a pass of the block copies kRP rows.
  constexpr int kRP = NT / (kSlab / 2);
  static_assert(B % kRP == 0, "whole passes");
  const int sr = threadIdx.x / (kSlab / 2), sk = threadIdx.x % (kSlab / 2) * 2;
  const double *xsrc = X, *zsrc = Z;  // this thread's first rows, feature sk
  int xleft = 0, zleft = 0;           // rows from them to n (m)
  long long ip = blockIdx.x;          // the next slab's tile,
  int iks = 0, ist = 0;               // its slab and ring stage
  int inb = 0;                        // and the next tile's norms buffer
  auto issue = [&]() {
    if (ip < ntiles) {
      if (iks == 0) {
        int i, j;
        tile_at(ip, tiles_n, sym, i, j);
        xleft = n - (i * B + sr);
        zleft = m - (j * B + sr);
        xsrc = X + (long long)(i * B + sr) * ldx + sk;
        zsrc = Z + (long long)(j * B + sr) * ldz + sk;
        double* nb = norms + inb * 2 * B;
        for (int e = threadIdx.x; e < 2 * B; e += NT)
          cp_async<8>(nb + e, e < B ? xn + min(i * B + e, n - 1)
                                    : zn + min(j * B + e - B, m - 1));
        inb = inb + 1 == kStages ? 0 : inb + 1;
      }
      const int k0 = iks * kSlab, kleft = d - k0 - sk;
      double* dst = ring + ist * S::kStage + sr * kRow + sk;
#pragma unroll
      for (int p = 0; p < B / kRP; ++p) {
        copy2(dst + p * kRP * kRow, xsrc + p * kRP * ldx + k0,
              p * kRP < xleft, kleft, al16);
        copy2(dst + (B + p * kRP) * kRow, zsrc + p * kRP * ldz + k0,
              p * kRP < zleft, kleft, al16);
      }
      if (++iks == nslabs) {
        iks = 0;
        ip += gridDim.x;
      }
    }
    cp_async_commit();  // every thread, every call: the group count in step
    ist = ist + 1 == kStages ? 0 : ist + 1;
  };
  for (int q = 0; q < kStages - 1; ++q) issue();

  double acc[FM][FN][2][2];
  int ks = 0, cst = 0, cnb = 0;  // the slab computed, its stage and norms
  for (long long tile = blockIdx.x; tile < ntiles;) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this slab landed; the last slab's stage is free
    issue();
    if (ks == 0) {
#pragma unroll
      for (int fm = 0; fm < FM; ++fm)
#pragma unroll
        for (int fn = 0; fn < FN; ++fn)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            acc[fm][fn][h][0] = acc[fm][fn][h][1] = 0.0;
    }
    const double* pa = ring + cst * S::kStage + (wr + g) * kRow + t;
    const double* pb = ring + cst * S::kStage + (B + wc + g) * kRow + t;
    cst = cst + 1 == kStages ? 0 : cst + 1;
    const int kw = min(kSlab, d - ks * kSlab);
    // k-steps of 4 features, the next step's fragments loaded before this
    // step's products (a ragged slab's extra loads read zeros or go unused)
    double a0[2][FM], a1[2][FM], b[2][FN];
    auto load = [&](int u, int k) {
#pragma unroll
      for (int fm = 0; fm < FM; ++fm) {
        a0[u][fm] = pa[fm * 16 * kRow + k];
        a1[u][fm] = pa[(fm * 16 + 8) * kRow + k];
      }
#pragma unroll
      for (int fn = 0; fn < FN; ++fn) b[u][fn] = pb[fn * 8 * kRow + k];
    };
    load(0, 0);
#pragma unroll
    for (int s4 = 0; s4 < kSlab / 4; ++s4) {
      if (s4 + 1 < kSlab / 4) load((s4 + 1) & 1, 4 * (s4 + 1));
      if (4 * s4 < kw) {
#pragma unroll
        for (int fm = 0; fm < FM; ++fm)
#pragma unroll
          for (int fn = 0; fn < FN; ++fn)
            dmma16(acc[fm][fn][0], acc[fm][fn][1], a0[s4 & 1][fm],
                   a1[s4 & 1][fm], b[s4 & 1][fn]);
      }
    }
    if (++ks < nslabs) continue;
    ks = 0;

    // the epilogue: this thread's outputs are rows r0 + 16 fm + 8 h and
    // columns c0 + 8 fn + {0, 1}, the tile's norms in shared memory
    int i, j;
    tile_at(tile, tiles_n, sym, i, j);
    tile += gridDim.x;
    const double* nx = norms + cnb * 2 * B + wr + g;
    const double* nz = norms + cnb * 2 * B + B + wc + 2 * t;
    cnb = cnb + 1 == kStages ? 0 : cnb + 1;
    const int r0 = i * B + wr + g, c0 = j * B + wc + 2 * t;
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const double xr = nx[fm * 16 + h * 8];
#pragma unroll
        for (int fn = 0; fn < FN; ++fn)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[fm][fn][h][e] = rbf_value<double>(
                xr, nz[fn * 8 + e], acc[fm][fn][h][e], neg_gamma);
      }
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + fm * 16 + h * 8;
        if (r >= n) continue;
#pragma unroll
        for (int fn = 0; fn < FN; ++fn) {
          const int c = c0 + fn * 8;
          if (c < m)
            store_pair(out + (size_t)r * m + c, acc[fm][fn][h][0],
                       acc[fm][fn][h][1], vec, c + 1 < m);
        }
      }
    if (!sym || i == j) continue;  // uniform over the block
    // the mirror tile K[c, r]: lanes g and g ^ 1 swap a value, so that an
    // even g holds column c at rows (r, r + 1) and an odd g column c + 1 at
    // rows (r - 1, r), each a 16-byte store (n = m here)
    const bool odd = g & 1;
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + fm * 16 + h * 8;
#pragma unroll
        for (int fn = 0; fn < FN; ++fn) {
          const int c = c0 + fn * 8;
          const double v0 = acc[fm][fn][h][0], v1 = acc[fm][fn][h][1];
          if (vec) {
            const double got =
                __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
            const int cc = odd ? c + 1 : c, rr = odd ? r - 1 : r;
            if (cc < n && rr < n)
              store_pair(out + (size_t)cc * n + rr, odd ? got : v0,
                         odd ? v1 : got, true, true);
          } else if (r < n) {
            if (c < n) __stcs(out + (size_t)c * n + r, v0);
            if (c + 1 < n) __stcs(out + (size_t)(c + 1) * n + r, v1);
          }
        }
      }
  }
  cp_async_wait_all();
}

// Resident blocks an SM are worked out once per device and build, after
// the kernel's shared memory is granted; the grid is that many blocks an
// SM, or fewer where there are fewer tiles.
template <int B, int WM, int WN, int MINB>
cudaError_t tc_launch(const double* X, const double* Z, long long ldx,
                      long long ldz, const double* xn, const double* zn,
                      double* out, int n, int m, int d, double neg_gamma,
                      bool sym, bool al16, cudaStream_t stream) {
  using S = TcTile<B, WM, WN>;
  auto kernel = rbf_tc_kernel<B, WM, WN, MINB>;
  static int c_dev = -1, c_blocks = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != c_dev) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)S::kSmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        S::kThreads, S::kSmem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    c_dev = dev;
    c_blocks = per_sm * sms;
  }
  const int tiles_n = (m + B - 1) / B;
  const long long ntiles = sym ? (long long)tiles_n * (tiles_n + 1) / 2
                               : (long long)((n + B - 1) / B) * tiles_n;
  const int grid = (int)(ntiles < c_blocks ? ntiles : c_blocks);
  rbf_tc_kernel<B, WM, WN, MINB><<<grid, S::kThreads, S::kSmem, stream>>>(
      X, Z, ldx, ldz, xn, zn, out, n, m, d, neg_gamma, sym ? 1 : 0,
      al16 ? 1 : 0, tiles_n, ntiles);
  return cudaGetLastError();
}

}  // namespace

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

// The tensor route: X's rows ldx apart and Z's ldz, sym != 0 when Z is X
// (then m == n, ldz == ldx, zn == xn). Rows at 16-byte boundaries (even
// strides and aligned bases) are copied 16 bytes at a time, others 8.
// tile: the output tile's edge, 128, 64 or 32 (kernels/rbf.py::
// tensor_tile picks it), each warp holding 32 x 32 outputs (32 x 16 at
// tile 32).
extern "C" int rbf_kernel_matrix_tc_f64(const double* X, const double* Z,
                                        long long ldx, long long ldz,
                                        const double* xn, const double* zn,
                                        double* out, int n, int m, int d,
                                        double gamma, int tile, int sym,
                                        cudaStream_t stream) {
  if (n <= 0 || m <= 0) return 0;
  if (sym && (n != m || ldx != ldz)) return (int)cudaErrorInvalidValue;
  const double ng = -gamma;
  const bool s = sym != 0;
  const bool al = ldx % 2 == 0 && ldz % 2 == 0 &&
                  reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(Z) % 16 == 0;
  switch (tile) {
    case 128:
      return (int)tc_launch<128, 32, 32, 1>(X, Z, ldx, ldz, xn, zn, out, n, m,
                                            d, ng, s, al, stream);
    case 64:
      return (int)tc_launch<64, 32, 32, 2>(X, Z, ldx, ldz, xn, zn, out, n, m,
                                           d, ng, s, al, stream);
    case 32:
      return (int)tc_launch<32, 32, 16, 4>(X, Z, ldx, ldz, xn, zn, out, n, m,
                                           d, ng, s, al, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
