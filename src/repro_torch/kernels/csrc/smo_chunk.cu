// Device-resident SMO chunk: up to n_iters iterations of the dense engine's
// step (WSS-2 or WSS-1 pair selection, box-clipped rank-2 update) in ONE
// launch, float64, one thread block per lane, state in global memory.
//
// Replaces the lax.while_loop of src/repro/svm/engine.py::smo_chunk over
// _step, whose f-update is the Pallas kernel kernels/smo_update.py on a TPU.
// XLA keeps that loop on the device; a Python loop of torch ops would launch
// ~20 kernels per SMO iteration and sync on the convergence test. Here the
// host reads `done` only between chunks.
//
// One iteration, all inside the block:
//   pass 1  I_up / I_low from (alpha, y, mask, C); argmin of f over I_up
//           (i, b_up), argmax of f over I_low (b_low, the WSS-1 j); the done
//           freeze (gap <= tol, it >= it_cap, NaN gap) ends the loop;
//   pass 2  (WSS-2) j = argmax over I_low, f_j > f_i of (f_j - f_i)^2 / eta_j;
//   scalar  thread 0: the clipped delta, alpha_i and alpha_j updated in the
//           reference's order;
//   pass 3  f += delta * (K_i - K_j) through smo_f_update_elem (the same
//           fma as smo_update.cu), alpha clipped to [0, C].
//
// Bitwise equal to the plain step (kernels/ref.py::smo_step_ref): each
// (value, index) min or max lets NaN win and the lowest index win a tie, which
// is exact in any reduction order; -fmad=false rounds the selection
// arithmetic op by op, as torch does. The first update of a launch clips all
// of alpha (the reference clips every element every step; after one step the
// others are inside the box, and clip is idempotent), later ones only i and j.
//
// Bound: per iteration the block streams the K_i and K_j rows (16 n bytes)
// plus f, alpha, y, mask and diag; one block uses one SM, so at large n the
// time is one SM's share of bandwidth and the barriers, not the card's.
#include <cuda_runtime.h>

#include <climits>

#include "smo_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr double kTau = 1e-12;

__device__ __forceinline__ bool better_min(double va, int ia, double vb,
                                           int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na != nb) return na;
  if (!na && va != vb) return va < vb;
  return ia < ib;
}

__device__ __forceinline__ bool better_max(double va, int ia, double vb,
                                           int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na != nb) return na;
  if (!na && va != vb) return va > vb;
  return ia < ib;
}

template <bool MAX>
__device__ __forceinline__ void warp_best(double& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (MAX ? better_max(ov, oi, v, i) : better_min(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

struct Scratch {
  double v0[kMaxWarps], v1[kMaxWarps];
  int i0[kMaxWarps], i1[kMaxWarps], flags[kMaxWarps];
  double r_v0, r_v1, delta;
  int r_i0, r_i1, r_flags;
};

// Block-wide (value, index) reduction of one min-pair, one max-pair and an OR
// of flag bits; the results land in s.r_* for every thread to read.
__device__ void block_reduce(Scratch& s, double v0, int i0, double v1, int i1,
                             int flags, bool need_min) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  if (need_min) warp_best<false>(v0, i0);
  warp_best<true>(v1, i1);
  flags = __reduce_or_sync(0xffffffffu, flags);
  if (lane == 0) {
    s.v0[warp] = v0;
    s.i0[warp] = i0;
    s.v1[warp] = v1;
    s.i1[warp] = i1;
    s.flags[warp] = flags;
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < nwarps;
    v0 = live ? s.v0[lane] : INFINITY;
    i0 = live ? s.i0[lane] : INT_MAX;
    v1 = live ? s.v1[lane] : -INFINITY;
    i1 = live ? s.i1[lane] : INT_MAX;
    flags = live ? s.flags[lane] : 0;
    if (need_min) warp_best<false>(v0, i0);
    warp_best<true>(v1, i1);
    flags = __reduce_or_sync(0xffffffffu, flags);
    if (lane == 0) {
      s.r_v0 = v0;
      s.r_i0 = i0;
      s.r_v1 = v1;
      s.r_i1 = i1;
      s.r_flags = flags;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void sets(double a, double yk, bool m, double C,
                                     bool& up, bool& low) {
  const bool pos = yk > 0.0, neg = yk < 0.0;
  const bool at_lo = a <= 0.0, at_hi = a >= C;
  up = m && !((pos && at_hi) || (neg && at_lo));
  low = m && !((pos && at_lo) || (neg && at_hi));
}

__device__ __forceinline__ double clip(double a, double C) {
  return nan_min(nan_max(a, 0.0), C);
}

__global__ void __launch_bounds__(kMaxThreads)
smo_chunk_kernel(const double* __restrict__ K, const double* __restrict__ diag,
                 const double* __restrict__ y,
                 const unsigned char* __restrict__ mask, double C, double tol,
                 long long it_cap, long long n_iters, int wss, double* alpha,
                 double* f, long long* n_iter, unsigned char* done_flag,
                 int n) {
  __shared__ Scratch s;
  const int tid = threadIdx.x, nt = blockDim.x;
  long long it = *n_iter;
  bool done = *done_flag != 0;
  bool clip_all = true;

  for (long long t = 0; t < n_iters && !done; ++t) {
    // ---- pass 1: sets, b_up / i, b_low / WSS-1 j, non-empty flags ----
    double vu = INFINITY, vl = -INFINITY;
    int iu = INT_MAX, il = INT_MAX, fl = 0;
    for (int k = tid; k < n; k += nt) {
      bool up, low;
      sets(alpha[k], y[k], mask[k] != 0, C, up, low);
      const double fk = f[k];
      const double cu = up ? fk : INFINITY, cl = low ? fk : -INFINITY;
      if (better_min(cu, k, vu, iu)) { vu = cu; iu = k; }
      if (better_max(cl, k, vl, il)) { vl = cl; il = k; }
      fl |= (up ? 1 : 0) | (low ? 2 : 0);
    }
    block_reduce(s, vu, iu, vl, il, fl, true);
    const int i = s.r_i0;
    const double b_up = s.r_v0, b_low = s.r_v1;
    const double gap = s.r_flags == 3 ? b_low - b_up : -INFINITY;
    done = (gap <= tol) || (it >= it_cap) || isnan(gap);
    if (done) break;  // uniform: every thread read the same shared values

    const double f_i = f[i];
    const double* Ki = K + (size_t)i * n;
    int j = s.r_i1;
    if (wss == 2) {
      // ---- pass 2: WSS-2 second-order choice of j ----
      const double diag_i = diag[i];
      double vg = -INFINITY;
      int ig = INT_MAX;
      for (int k = tid; k < n; k += nt) {
        bool up, low;
        sets(alpha[k], y[k], mask[k] != 0, C, up, low);
        const double diff = f[k] - f_i;
        const double eta = nan_max(diag_i + diag[k] - 2.0 * Ki[k], kTau);
        const double g = (low && diff > 0.0) ? diff * diff / eta : -INFINITY;
        if (better_max(g, k, vg, ig)) { vg = g; ig = k; }
      }
      // the reductions are done by every thread, so the barrier inside
      // block_reduce also orders pass 1's shared reads before these writes
      block_reduce(s, INFINITY, INT_MAX, vg, ig, 0, false);
      j = s.r_i1;
    }
    const double* Kj = K + (size_t)j * n;

    // ---- scalar: clipped delta, alpha_i / alpha_j in the reference's order
    if (tid == 0) {
      const double f_j = f[j], a_i = alpha[i], a_j = alpha[j];
      const double y_i = y[i], y_j = y[j];
      const double eta_ij = nan_max(diag[i] + diag[j] - 2.0 * Ki[j], kTau);
      double delta = (f_j - f_i) / eta_ij;
      const double hi_i = y_i > 0.0 ? C - a_i : a_i;
      const double hi_j = y_j > 0.0 ? a_j : C - a_j;
      delta = nan_max(nan_min(nan_min(delta, hi_i), hi_j), 0.0);
      alpha[i] = a_i + y_i * delta;
      alpha[j] = alpha[j] + (-y_j) * delta;
      s.delta = delta;
    }
    __syncthreads();

    // ---- pass 3: f-update for every row, alpha back into the box ----
    const double delta = s.delta;
    for (int k = tid; k < n; k += nt) {
      f[k] = smo_f_update_elem(f[k], Ki[k], Kj[k], delta);
      if (clip_all || k == i || k == j) alpha[k] = clip(alpha[k], C);
    }
    clip_all = false;
    ++it;
    __syncthreads();
  }
  if (tid == 0) {
    *n_iter = it;
    *done_flag = done ? 1 : 0;
  }
}

}  // namespace

extern "C" int smo_chunk_f64(const double* K, const double* diag,
                             const double* y, const unsigned char* mask,
                             double C, double tol, long long it_cap,
                             long long n_iters, int wss, double* alpha,
                             double* f, long long* n_iter,
                             unsigned char* done, int n, cudaStream_t stream) {
  if (n > 0 && n_iters > 0) {
    int threads = ((n + 31) / 32) * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    smo_chunk_kernel<<<1, threads, 0, stream>>>(K, diag, y, mask, C, tol,
                                                it_cap, n_iters, wss, alpha, f,
                                                n_iter, done, n);
  }
  return (int)cudaGetLastError();
}
