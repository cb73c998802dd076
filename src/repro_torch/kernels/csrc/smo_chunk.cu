// Device-resident dense SMO chunk over a grid of lanes: up to n_iters
// iterations of the dense engine's step (WSS-2 or WSS-1 pair selection,
// box-clipped rank-2 update) in ONE launch, float64, one thread block per
// lane, state in global memory. The lanes share K, diag and y; each has its
// own train mask, C, iteration cap, alpha, f, n_iter and done flag.
//
// Replaces the lax.while_loop of src/repro/svm/engine.py::smo_chunk over
// _step (one lane) and chunk_batched_jit (the vmapped lanes), whose f-update
// is the Pallas kernel kernels/smo_update.py on a TPU. XLA keeps that loop on
// the device; a Python loop of torch ops would launch ~20 kernels per SMO
// iteration and sync on the convergence test. Here the host reads the lanes'
// `done` flags only between chunks.
//
// One iteration, all inside the lane's block:
//   pass 1  I_up / I_low from (alpha, y, mask, C); argmin of f over I_up
//           (i, b_up), argmax of f over I_low (b_low, the WSS-1 j); the done
//           freeze (gap <= tol, it >= it_cap, NaN gap) ends the lane's loop;
//   pass 2  (WSS-2) j = argmax over I_low, f_j > f_i of (f_j - f_i)^2 / eta_j;
//   scalar  thread 0: the clipped delta, alpha_i and alpha_j updated in the
//           reference's order;
//   pass 3  f += delta * (K_i - K_j) through smo_f_update_elem (the same
//           fma as smo_update.cu), alpha clipped to [0, C].
//
// Bitwise equal to the plain step (kernels/ref.py::smo_step_ref): the
// (value, index) reductions of smo_common.cuh are exact in any order, and
// -fmad=false rounds the selection arithmetic op by op, as torch does. The
// first update of a launch clips all of alpha (the reference clips every
// element every step; after one step the others are inside the box, and clip
// is idempotent), later ones only i and j. A lane's block does the same work
// whatever the grid's width, so a lane packed with others is bitwise equal to
// the lane alone; a pad lane arrives done and exits at once.
//
// Bound: per iteration a lane's block streams the K_i and K_j rows (16 n
// bytes) plus f, alpha, y, mask and diag; one block uses one SM, so at large
// n a lane's time is one SM's share of bandwidth and the barriers, not the
// card's. Lanes run on separate SMs in parallel.
#include <cuda_runtime.h>

#include "smo_common.cuh"

namespace {

__global__ void __launch_bounds__(kMaxThreads)
smo_chunk_kernel(const double* __restrict__ K, const double* __restrict__ diag,
                 const double* __restrict__ y,
                 const unsigned char* __restrict__ masks,
                 const double* __restrict__ Cs, double tol,
                 const long long* __restrict__ it_caps, long long n_iters,
                 int wss, double* alphas, double* fs, long long* n_iter,
                 unsigned char* done_flags, int n) {
  __shared__ Scratch s;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const unsigned char* mask = masks + (size_t)lane * n;
  double* alpha = alphas + (size_t)lane * n;
  double* f = fs + (size_t)lane * n;
  const double C = Cs[lane];
  const long long it_cap = it_caps[lane];
  long long it = n_iter[lane];
  bool done = done_flags[lane] != 0;
  bool clip_all = true;

  for (long long t = 0; t < n_iters && !done; ++t) {
    // ---- pass 1: sets, b_up / i, b_low / WSS-1 j, non-empty flags ----
    int i, j;
    const double gap = select_pass1(s, alpha, f, y, mask, C, n, i, j);
    done = (gap <= tol) || (it >= it_cap) || isnan(gap);
    if (done) break;  // uniform: every thread read the same shared values

    const double f_i = f[i];
    const double* Ki = K + (size_t)i * n;
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
      const double eta_ij = nan_max(diag[i] + diag[j] - 2.0 * Ki[j], kTau);
      s.delta = pair_update(alpha, f, y, i, j, eta_ij, C);
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
    n_iter[lane] = it;
    done_flags[lane] = done ? 1 : 0;
  }
}

}  // namespace

// b lanes over one K (n, n): masks, alphas, fs (b, n); Cs, it_caps, n_iter,
// done (b,). The block's width depends on n only.
extern "C" int smo_chunk_f64(const double* K, const double* diag,
                             const double* y, const unsigned char* masks,
                             const double* Cs, double tol,
                             const long long* it_caps, long long n_iters,
                             int wss, double* alphas, double* fs,
                             long long* n_iter, unsigned char* done, int n,
                             int b, cudaStream_t stream) {
  if (n > 0 && b > 0 && n_iters > 0) {
    int threads = ((n + 31) / 32) * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    smo_chunk_kernel<<<b, threads, 0, stream>>>(K, diag, y, masks, Cs, tol,
                                                it_caps, n_iters, wss, alphas,
                                                fs, n_iter, done, n);
  }
  return (int)cudaGetLastError();
}
