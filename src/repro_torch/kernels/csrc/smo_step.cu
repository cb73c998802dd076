// Matrix-free SMO step over lanes: the fused kernel-row pair + rank-2
// f-update, and the WSS-1 selection that feeds it.
//
// fused_smo_step_kernel replaces the Pallas kernel
// src/repro/kernels/smo_step.py::fused_smo_step (_smo_step_kernel). For each
// of b lanes over one X (n, d) it computes
//   K2[r, w] = exp(-gamma * max(xn[r] + |p_w|^2 - 2 * X[r] . p_w, 0)),
//   f[r]    += delta * (K2[r, 0] - K2[r, 1])
// for the lane's pair rows p_0 = x_i, p_1 = x_j (xij, (b, 2, d)), without
// the two kernel rows ever reaching memory. A lane whose done flag is set
// keeps its f untouched, so the launch needs no host sync.
//
// Design: a block owns 32 rows of X and up to 32 lanes. It walks the feature
// axis in slabs of 32: the slab of its X rows and of the lanes' pair rows is
// staged in shared memory (coalesced loads, rows padded to an odd stride so
// the 16 rows a half-warp reads sit in distinct banks), and each of the 256
// threads owns one row and up to four lanes (lane g, g + 8, g + 16, g + 24),
// whose two dot products it carries in registers across the slabs. Then the
// clamp, exp and f-update. So each X tile is read from device memory once
// for up to 32 lanes, any d fits, and every output's dot product runs k = 0
// .. d-1 in order (fma) whatever the tile, grid or number of lanes: a lane's
// f is bitwise the same alone or packed. More than 32 lanes go in groups of
// 32, each re-reading the tile.
//
// Bound: bytes. Per launch X (8 n d bytes) is read once, f read and written
// per lane (16 b n) and the norms read (8 n); the products are 4 b n d
// operations, which at d = 123 stay below the FP64 rate's share of that
// time. An f32 instance accumulates in f32, as the TPU kernel does.
//
// smo_select_kernel is the rest of the reference's streaming SMO step
// (src/repro/svm/engine.py::_step, WSS-1 branch with a streaming source): one
// block per lane picks the maximal violating pair, evaluates K[i, j] by the
// same expression and the same order as the fused kernel's row j (the
// reference's interpret-mode kij, engine.py:452-454), clips delta, updates
// alpha_i and alpha_j, and writes (pair rows, delta, done) for the fused
// launch. smo_stream_chunk_f64 issues up to n_iters (select, fused) pairs from
// one host call and stops soon after every lane is done; the lanes' state
// stays in device memory throughout.
#include <cuda_runtime.h>

#include "smo_common.cuh"

namespace {

constexpr int kRows = 32;                   // X rows per block
constexpr int kThreads = 256;
constexpr int kGroup = kThreads / kRows;    // lanes side by side
constexpr int kSlots = 4;                   // lanes a thread carries
constexpr int kMaxLanes = kGroup * kSlots;  // lanes per pass over the tile
constexpr int kSlab = 32;                   // features per staged slab

template <typename T>
__device__ __forceinline__ T exp_t(T x);
template <>
__device__ __forceinline__ double exp_t<double>(double x) { return exp(x); }
template <>
__device__ __forceinline__ float exp_t<float>(float x) { return expf(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_smo_step_kernel(T* __restrict__ f, const T* __restrict__ X,
                      const T* __restrict__ xn, const T* __restrict__ xij,
                      const T* __restrict__ delta,
                      const unsigned char* __restrict__ done, int n, int d,
                      int b, T neg_gamma) {
  __shared__ T xs[kRows][kSlab + 1];
  __shared__ T ps[2 * kMaxLanes][kSlab + 1];
  __shared__ T sn2[2 * kMaxLanes];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  const int r = tid % kRows, g = tid / kRows;

  for (int l0 = 0; l0 < b; l0 += kMaxLanes) {
    const int nl = min(kMaxLanes, b - l0);
    // a done lane keeps its f, so its products are skipped; a pass whose
    // lanes are all done skips the tile (the same test in every thread)
    bool any = false, live[kSlots];
    for (int p = 0; p < nl; ++p) any |= !(done != nullptr && done[l0 + p]);
    if (!any) continue;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int p = g + s * kGroup;
      live[s] = p < nl && !(done != nullptr && done[l0 + p]);
    }
    T ci[kSlots], cj[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) ci[s] = cj[s] = T(0);
    T sn = T(0);  // thread tid < 2 nl: the norm of pair row tid
    for (int k0 = 0; k0 < d; k0 += kSlab) {
      const int kw = min(kSlab, d - k0);
      __syncthreads();  // the last slab's reads (and sn2's) are done
      for (int e = tid; e < rows * kw; e += kThreads) {
        const int rr = e / kw, k = e - rr * kw;
        xs[rr][k] = X[(size_t)(row0 + rr) * d + k0 + k];
      }
      for (int e = tid; e < 2 * nl * kw; e += kThreads) {
        const int p = e / kw, k = e - p * kw;
        ps[p][k] = xij[(size_t)(2 * l0 + p) * d + k0 + k];
      }
      __syncthreads();
      if (tid < 2 * nl)
        for (int k = 0; k < kw; ++k) sn = sn + ps[tid][k] * ps[tid][k];
      if (r < rows) {
        for (int k = 0; k < kw; ++k) {
          const T x = xs[r][k];
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            const int p = g + s * kGroup;  // uniform over a warp
            if (live[s]) {
              ci[s] = fma_t(x, ps[2 * p][k], ci[s]);
              cj[s] = fma_t(x, ps[2 * p + 1][k], cj[s]);
            }
          }
        }
      }
    }
    if (tid < 2 * nl) sn2[tid] = sn;
    __syncthreads();
    if (r < rows) {
      const T xr2 = xn[row0 + r];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int p = g + s * kGroup, l = l0 + p;
        if (!live[s]) continue;
        T d2i = xr2 + sn2[2 * p] - T(2) * ci[s];
        T d2j = xr2 + sn2[2 * p + 1] - T(2) * cj[s];
        d2i = d2i < T(0) ? T(0) : d2i;  // max(d2, 0), NaN kept
        d2j = d2j < T(0) ? T(0) : d2j;
        const T ki = exp_t<T>(neg_gamma * d2i);
        const T kj = exp_t<T>(neg_gamma * d2j);
        const size_t o = (size_t)l * n + row0 + r;
        f[o] = smo_f_update_elem<T>(f[o], ki, kj, delta[l]);
      }
    }
  }
}

template <typename T>
int launch_fused(T* f, const T* X, const T* xn, const T* xij, const T* delta,
                 const unsigned char* done, int n, int d, int b, double gamma,
                 cudaStream_t stream) {
  if (n > 0 && b > 0)
    fused_smo_step_kernel<T><<<(n + kRows - 1) / kRows, kThreads, 0,
                               stream>>>(f, X, xn, xij, delta, done, n, d, b,
                                         T(-gamma));
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kMaxThreads)
smo_select_kernel(const double* __restrict__ X, const double* __restrict__ xn,
                  const double* __restrict__ y,
                  const unsigned char* __restrict__ masks,
                  const double* __restrict__ Cs, double tol,
                  const long long* __restrict__ it_caps, double* alphas,
                  const double* __restrict__ fs, long long* n_iter,
                  unsigned char* done_flags, double* xij,
                  double* __restrict__ deltas, int n, int d, double neg_gamma,
                  int clip_all) {
  __shared__ Scratch s;
  const int lane = blockIdx.x;
  if (done_flags[lane]) return;  // uniform over the block
  const int tid = threadIdx.x, nt = blockDim.x;
  const unsigned char* mask = masks + (size_t)lane * n;
  double* alpha = alphas + (size_t)lane * n;
  const double* f = fs + (size_t)lane * n;
  const double C = Cs[lane];
  const long long it = n_iter[lane];

  int i, j;
  const double gap = select_pass1(s, alpha, f, y, mask, C, n, i, j);
  if ((gap <= tol) || (it >= it_caps[lane]) || isnan(gap)) {
    if (tid == 0) done_flags[lane] = 1;
    return;
  }
  double* pair = xij + (size_t)lane * 2 * d;  // x_i then x_j
  for (int e = tid; e < 2 * d; e += nt)
    pair[e] = e < d ? X[(size_t)i * d + e] : X[(size_t)j * d + e - d];
  __syncthreads();  // the block's global writes are visible to thread 0
  if (tid == 0) {
    // K[i, j] as the fused kernel computes row j of lane pair (i, j)
    double sn = 0.0, cross = 0.0;
    for (int k = 0; k < d; ++k) sn = sn + pair[k] * pair[k];
    for (int k = 0; k < d; ++k) cross = fma(pair[d + k], pair[k], cross);
    double d2 = xn[j] + sn - 2.0 * cross;
    d2 = d2 < 0.0 ? 0.0 : d2;
    const double kij = exp(neg_gamma * d2);
    const double eta_ij = nan_max(1.0 + 1.0 - 2.0 * kij, kTau);  // diag = 1
    deltas[lane] = pair_update(alpha, f, y, i, j, eta_ij, C);
    if (!clip_all) {
      alpha[i] = clip(alpha[i], C);
      alpha[j] = clip(alpha[j], C);
    }
    n_iter[lane] = it + 1;
  }
  if (clip_all) {
    __syncthreads();
    for (int k = tid; k < n; k += nt) alpha[k] = clip(alpha[k], C);
  }
}

void launch_select(const double* X, const double* xn, const double* y,
                   const unsigned char* masks, const double* Cs, double tol,
                   const long long* it_caps, double gamma, double* alphas,
                   const double* fs, long long* n_iter, unsigned char* done,
                   double* xij, double* delta, int n, int d, int b,
                   int clip_all, cudaStream_t stream) {
  int threads = ((n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  smo_select_kernel<<<b, threads, 0, stream>>>(
      X, xn, y, masks, Cs, tol, it_caps, alphas, fs, n_iter, done, xij, delta,
      n, d, -gamma, clip_all);
}

}  // namespace

// f (b, n) updated in place; xij (b, 2, d); delta (b,); done (b,) or null.
extern "C" int fused_smo_step_f64(double* f, const double* X,
                                  const double* xn, const double* xij,
                                  const double* delta,
                                  const unsigned char* done, int n, int d,
                                  int b, double gamma, cudaStream_t stream) {
  return launch_fused<double>(f, X, xn, xij, delta, done, n, d, b, gamma,
                              stream);
}

extern "C" int fused_smo_step_f32(float* f, const float* X, const float* xn,
                                  const float* xij, const float* delta,
                                  const unsigned char* done, int n, int d,
                                  int b, double gamma, cudaStream_t stream) {
  return launch_fused<float>(f, X, xn, xij, delta, done, n, d, b, gamma,
                             stream);
}

// One selection step over b lanes (alpha clipped whole, as the plain step
// does): alphas, n_iter and done updated in place; the pair rows and delta
// of each lane that steps written to xij (b, 2, d) and delta (b,).
extern "C" int smo_select_f64(const double* X, const double* xn,
                              const double* y, const unsigned char* masks,
                              const double* Cs, double tol,
                              const long long* it_caps, double gamma,
                              double* alphas, const double* fs,
                              long long* n_iter, unsigned char* done,
                              double* xij, double* delta, int n, int d, int b,
                              cudaStream_t stream) {
  if (n > 0 && b > 0)
    launch_select(X, xn, y, masks, Cs, tol, it_caps, gamma, alphas, fs,
                  n_iter, done, xij, delta, n, d, b, 1, stream);
  return (int)cudaGetLastError();
}

// Up to n_iters streaming WSS-1 iterations over b lanes of one X: each is one
// selection launch (one block per lane) and one fused launch over all lanes.
// masks, alphas, fs (b, n); Cs, it_caps, n_iter, done (b,); xij (b, 2, d) and
// delta (b,) are scratch. *issued gets the number of iterations launched.
//
// Like the reference's any(~done) loop, the chunk stops once every lane is
// done, without draining the stream: every kPoll iterations the done flags
// are copied to pinned host memory behind an event, and the host reads the
// copy made kPoll iterations earlier, so at most 2 kPoll no-op iterations
// are launched past the last lane's stop while kPoll stay queued. A stream
// being captured into a graph launches all n_iters.
extern "C" int smo_stream_chunk_f64(const double* X, const double* xn,
                                    const double* y, const unsigned char* masks,
                                    const double* Cs, double tol,
                                    const long long* it_caps,
                                    long long n_iters, double gamma,
                                    double* alphas, double* fs,
                                    long long* n_iter, unsigned char* done,
                                    double* xij, double* delta, int n, int d,
                                    int b, cudaStream_t stream,
                                    long long* issued) {
  constexpr long long kPoll = 64;
  *issued = 0;
  if (n <= 0 || b <= 0) return (int)cudaGetLastError();
  cudaStreamCaptureStatus capture;
  int err = (int)cudaStreamIsCapturing(stream, &capture);
  if (err) return err;
  const bool poll = capture == cudaStreamCaptureStatusNone && n_iters > kPoll;
  // two copies of the flags in flight; one host process, one caller at a time
  static unsigned char* host = nullptr;
  static int host_lanes = 0;
  cudaEvent_t ev[2] = {nullptr, nullptr};
  if (poll) {
    if (host_lanes < b) {
      if (host) cudaFreeHost(host);
      host_lanes = 0;
      err = (int)cudaMallocHost((void**)&host, 2 * (size_t)b);
      if (err) return err;
      host_lanes = b;
    }
    for (int e = 0; e < 2 && !err; ++e)
      err = (int)cudaEventCreateWithFlags(&ev[e], cudaEventDisableTiming);
  }
  bool pending[2] = {false, false};
  long long t = 0;
  for (; t < n_iters && !err; ++t) {
    if (poll && t > 0 && t % kPoll == 0) {
      const int slot = (int)(t / kPoll) & 1, prev = slot ^ 1;
      if (pending[prev]) {
        err = (int)cudaEventSynchronize(ev[prev]);
        pending[prev] = false;
        bool all = true;
        for (int l = 0; l < b && all; ++l) all = host[prev * b + l] != 0;
        if (err || all) break;
      }
      err = (int)cudaMemcpyAsync(host + slot * b, done, b,
                                 cudaMemcpyDeviceToHost, stream);
      if (!err) err = (int)cudaEventRecord(ev[slot], stream);
      if (err) break;
      pending[slot] = true;
    }
    launch_select(X, xn, y, masks, Cs, tol, it_caps, gamma, alphas, fs,
                  n_iter, done, xij, delta, n, d, b, t == 0 ? 1 : 0, stream);
    err = (int)cudaGetLastError();
    if (!err)
      err = launch_fused<double>(fs, X, xn, xij, delta, done, n, d, b, gamma,
                                 stream);
    if (!err) *issued = t + 1;
  }
  // the host buffer is free again once the copies still in flight land
  for (int e = 0; e < 2; ++e) {
    if (pending[e]) {
      const int e2 = (int)cudaEventSynchronize(ev[e]);
      if (!err) err = e2;
    }
    if (ev[e]) cudaEventDestroy(ev[e]);
  }
  return err;
}
