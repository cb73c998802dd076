// Device-resident dense SMO chunk over a grid of lanes: up to n_iters
// iterations of the dense engine's step (WSS-2 or WSS-1 pair selection,
// box-clipped rank-2 update) in ONE launch, float64. Each lane has its own
// train mask, C, iteration cap, alpha, f, n_iter and done flag. Lane l
// reads K + l * k_lane, diag + l * v_lane and y + l * v_lane (elements):
// strides of 0 share one K, diag and y (the lanes of one kernel source);
// k_lane = n * n and v_lane = n give each lane its own (the shrinking
// scheduler's compact lanes, each over the rows it kept active).
//
// Replaces the lax.while_loop of src/repro/svm/engine.py::smo_chunk over
// _step (one lane), chunk_batched_jit (the vmapped lanes) and
// chunk_batched_sources_jit (lanes with their own operands), whose f-update
// is the Pallas kernel kernels/smo_update.py on a TPU. XLA keeps that loop on
// the device; a Python loop of torch ops would launch ~20 kernels per SMO
// iteration and sync on the convergence test. Here the host reads the lanes'
// `done` flags only between chunks.
//
// Four kernels, routes by size and lanes (kernels/smo_chunk.py::
// chunk_route, the fastest that places the launch):
//   * smo_chunk_resident_kernel ("one_block"): one block a lane, the
//     lane's state in registers or shared memory, wherever it fits a block
//     (n <= 6,144): every Table-1 launch;
//   * smo_chunk_multi_kernel ("multi_block"): each lane over many blocks of
//     a cooperative launch, for large n while the lanes' state fits the
//     card's shared memory;
//   * smo_chunk_cluster_kernel ("cluster"): each lane over a thread-block
//     cluster, its alpha and f in the cluster's shared memory, for wide
//     batches at large n (24 folds at n = 32,544);
//   * smo_chunk_kernel ("one_block_global", below): one block a lane, state
//     in global memory, for batches whose state fits nowhere on chip.
//
// smo_chunk_kernel's iteration, all inside the lane's block:
//   pass 1  I_up / I_low from (alpha, y, mask, C); argmin of f over I_up
//           (i, b_up), argmax of f over I_low (b_low, the WSS-1 j); the done
//           freeze (gap <= tol, it >= it_cap, NaN gap) ends the lane's loop;
//   pass 2  (WSS-2) j = argmax over I_low, f_j > f_i of (f_j - f_i)^2 / eta_j;
//   scalar  thread 0: the clipped delta, alpha_i and alpha_j updated in the
//           reference's order;
//   pass 3  f += delta * (K_i - K_j) through smo_f_update_elem (the same
//           fma as smo_update.cu), alpha clipped to [0, C].
//
// Bitwise equal to the plain step (kernels/ref.py::smo_step_ref), and the
// three kernels to each other: the (value, index) reductions of
// smo_common.cuh are exact in any order, and -fmad=false rounds the
// selection arithmetic op by op, as torch does. The first update of a
// launch clips all of alpha (the reference clips every element every step;
// after one step the others are inside the box, and clip is idempotent),
// later ones only i and j. A lane's block does the same work whatever the
// grid's width, so a lane packed with others is bitwise equal to the lane
// alone; a pad lane arrives done and exits at once.
//
// Bound: what a chunk must move is the K_i and K_j rows of each iteration
// (16 n bytes) and the lane's state once: alpha, f, y, diag and the mask
// read (33 n), alpha and f written (16 n); alpha changes at i and j only,
// and the state of a lane fits on chip. So about 16 n + 49 n / iterations
// bytes an iteration. smo_chunk_kernel keeps the state in global memory
// and streams it every iteration (~65 n bytes) through one SM; lanes run
// on separate SMs in parallel. What bounds every route at the paper's
// sizes is latency (barriers and dependent L2 round trips), not bytes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "smo_common.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void __launch_bounds__(kMaxThreads)
smo_chunk_kernel(const double* __restrict__ K, const double* __restrict__ diag,
                 const double* __restrict__ y,
                 const unsigned char* __restrict__ masks,
                 const double* __restrict__ Cs, double tol,
                 const long long* __restrict__ it_caps, long long n_iters,
                 int wss, double* alphas, double* fs, long long* n_iter,
                 unsigned char* done_flags, int n, long long k_lane,
                 long long v_lane) {
  __shared__ Scratch s;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  K += lane * k_lane;
  diag += lane * v_lane;
  y += lane * v_lane;
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


// ------------------------------------------------------------------------
// Resident one-block route (the wrapper's "one_block"): one block a lane,
// the lane's state on chip for the whole launch. What bounds an iteration
// at Table 1's sizes is a chain of dependent latencies, not bytes (a few
// ns of them). The kernel above pays, every iteration, three passes that
// re-read the state from L2, six block barriers, a scalar step that
// thread 0 runs from eight dependent global loads, and four block
// reductions of five shuffle levels each, every level a chain of NaN-aware
// float64 compares (3.4-4.9 us an iteration on an H100). Here:
//
//   * thread t owns rows t R .. t R + R - 1 (T threads, R rows a thread,
//     both fixed per launch; rows rise with the lane, which the tie rule
//     below uses) and holds their alpha, f, y, diag, mask bit and the
//     signs of y in registers (or, past 2,048 rows, in the block's shared
//     memory, 33 bytes a row), loaded once and stored once a launch; the
//     only global reads left in the loop are the K_i and K_j rows;
//   * one sweep a step: the f-update of step t and pass 1 of step t+1 are
//     one loop over the thread's rows, branch-free;
//   * a thread keeps its best row by one float64 compare a row; only that
//     row becomes an order key (see min_key), and a warp finds its least
//     key with two __reduce_min_sync and a ballot (the lowest lane, so
//     the lowest row, wins a tie);
//   * one barrier a reduction: the lane that holds the warp's winner writes
//     its key, value and row's scalars to the warp's slot in shared
//     memory; one __syncthreads; every warp then reduces the slots itself
//     and reads the winner's scalars. Slots alternate by reduction parity,
//     so a warp that runs ahead never overwrites a slot another still
//     reads;
//   * no serial scalar step: every thread computes delta and the new
//     alpha_i / alpha_j with pair_step from the published scalars, while
//     its K_j loads are in flight; the owners of rows i and j take them
//     in the next sweep;
//   * each thread issues its rows' K_i loads as soon as i is known and its
//     K_j loads as soon as j is (WSS-1: both, and K_ij, at once).
//
// That leaves an iteration two block barriers (one in WSS-1), four warp
// reductions with their slot exchanges, and two dependent round trips for
// the K rows (one in WSS-1), which at Table 1's sizes hit the L2 (heart's
// K is 0.58 MB, adult's 8 MB; the kernel prefers L1 to shared memory, so
// hot rows may hit L1). Fewer rows a thread shorten the sweeps; more warps
// lengthen the reductions (every warp reduces the slots) and the
// barriers: the wrapper's placement picks R from the card's sweep.
//
// Every quantity is the kernel above's, by the same expressions in the
// same order (the sets, the gain's diff * diff / eta, eta_ij, pair_step,
// smo_f_update_elem, the clip on the launch's first update only), and
// the reductions pick the same winner under the same order, so a lane is
// bitwise that kernel, the multi-block route and the plain step engine,
// and does the same work whatever the grid's width.
// ------------------------------------------------------------------------

// The most threads a build of the resident kernel takes: R rows a thread
// in registers (SMEM false) or in shared memory (SMEM true). Registers
// bound it: 65,536 a SM over the rows' state, the K rows and the
// candidates. The wrapper reads it through smo_chunk_resident_build.
template <int R, bool SMEM>
struct Resident {
  static constexpr int kThreads = SMEM ? 768 : R <= 2 ? 1024 : 512;
};

// The warp's least key: every lane gets it, and the lowest lane that holds
// it. Lanes hold rows in rising order (see Rows), so the lowest lane
// holds the lowest row: the tie rule.
__device__ __forceinline__ int warp_least(unsigned long long& key) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned mh = __reduce_min_sync(0xffffffffu, hi);
  const unsigned ml = __reduce_min_sync(0xffffffffu, hi == mh ? lo : ~0u);
  const unsigned at = __ballot_sync(0xffffffffu, hi == mh && lo == ml);
  key = ((unsigned long long)mh << 32) | ml;
  return __ffs(at) - 1;
}

// One row's candidate against a thread's best so far, rows rising: a NaN
// beats a number and nothing beats an earlier NaN; otherwise only a
// strictly better value wins, so a tie keeps the earlier (lower) row. The
// rule of better_min / better_max over one thread's rows, with one float64
// compare a row; the thread's winner alone becomes a key. (The per-row
// logic is written with & and | on bools: && and || made nvcc branch
// around each compare, and the rows ran one after another.)
template <bool MAX>
__device__ __forceinline__ void row_best(double v, int r, double& bv,
                                         int& br) {
  const bool take =
      (isnan(v) & !isnan(bv)) | (MAX ? v > bv : v < bv);
  bv = take ? v : bv;
  br = take ? r : br;
}

// A warp's candidate of one reduction, in shared memory: its key, value
// and row, the OR of the set flags (pass 1), and its row's scalars (WSS-2's
// second reduction: f, alpha, y, diag and K_ij of j).
struct Cand {
  unsigned long long key;
  double v;
  int i;
  int flags;
  double f, a, y, d, kij;
};

// A thread's R rows: thread t owns rows t R .. t R + R - 1, so rows rise
// with the lane and, within a thread, with r. State in registers...
template <int R, bool SMEM>
struct Rows {
  double a_[R], f_[R], y_[R], d_[R];
  unsigned m_ = 0, pos_ = 0, neg_ = 0;
  __device__ Rows(double*, int, int) {}
  __device__ double& a(int r) { return a_[r]; }
  __device__ double& f(int r) { return f_[r]; }
  __device__ double& y(int r) { return y_[r]; }
  __device__ double& d(int r) { return d_[r]; }
  __device__ bool m(int r) const { return (m_ >> r) & 1u; }
  __device__ bool pos(int r) const { return (pos_ >> r) & 1u; }
  __device__ bool neg(int r) const { return (neg_ >> r) & 1u; }
  __device__ void set(int r, double a, double f, double y, double d,
                      bool m) {
    a_[r] = a;
    f_[r] = f;
    y_[r] = y;
    d_[r] = d;
    m_ |= (m ? 1u : 0u) << r;
    pos_ |= (y > 0.0 ? 1u : 0u) << r;
    neg_ |= (y < 0.0 ? 1u : 0u) << r;
  }
};

// ... or in shared memory, row r of thread t at [r * T + t]
template <int R>
struct Rows<R, true> {
  double *a_, *f_, *y_, *d_;
  unsigned char* m_;
  int T;
  __device__ Rows(double* base, int T_, int tid) : T(T_) {
    const int rows = R * T_;
    a_ = base + tid;
    f_ = a_ + rows;
    y_ = f_ + rows;
    d_ = y_ + rows;
    m_ = reinterpret_cast<unsigned char*>(base + 4 * rows) + tid;
  }
  __device__ double& a(int r) { return a_[r * T]; }
  __device__ double& f(int r) { return f_[r * T]; }
  __device__ double& y(int r) { return y_[r * T]; }
  __device__ double& d(int r) { return d_[r * T]; }
  __device__ bool m(int r) const { return m_[r * T] != 0; }
  __device__ bool pos(int r) { return y(r) > 0.0; }
  __device__ bool neg(int r) { return y(r) < 0.0; }
  __device__ void set(int r, double a, double f, double y, double d,
                      bool m) {
    a_[r * T] = a;
    f_[r * T] = f;
    y_[r * T] = y;
    d_[r * T] = d;
    m_[r * T] = m ? 1 : 0;
  }
};

// The lane that holds the warp's winner writes it to the warp's slot, with
// row rb's scalars (selected without indexing the register arrays).
template <int R, bool SMEM>
__device__ __forceinline__ void publish_cand(Cand& c, Rows<R, SMEM>& s,
                                             int rb, unsigned long long key,
                                             double v, int i, int flags) {
  c.key = key;
  c.v = v;
  c.i = i;
  c.flags = flags;
  double f = s.f(0), a = s.a(0), y = s.y(0), d = s.d(0);
#pragma unroll
  for (int r = 1; r < R; ++r)
    if (r == rb) {
      f = s.f(r);
      a = s.a(r);
      y = s.y(r);
      d = s.d(r);
    }
  c.f = f;
  c.a = a;
  c.y = y;
  c.d = d;
}

template <int R, bool SMEM>
__global__ void __launch_bounds__(Resident<R, SMEM>::kThreads)
smo_chunk_resident_kernel(const double* __restrict__ K,
                          const double* __restrict__ diag,
                          const double* __restrict__ y,
                          const unsigned char* __restrict__ masks,
                          const double* __restrict__ Cs, double tol,
                          const long long* __restrict__ it_caps,
                          long long n_iters, int wss, double* alphas,
                          double* fs, long long* n_iter,
                          unsigned char* done_flags, int n, long long k_lane,
                          long long v_lane) {
  extern __shared__ double rows_smem[];  // the SMEM build's state
  __shared__ Cand c_up[2][kMaxWarps], c_low[2][kMaxWarps];
  const int lane = blockIdx.x;
  if (done_flags[lane] != 0) return;  // a pad or done lane exits at once
  K += lane * k_lane;
  diag += lane * v_lane;
  y += lane * v_lane;
  const int tid = threadIdx.x, T = blockDim.x;
  const int wl = tid & 31, warp = tid >> 5, W = (T + 31) >> 5;
  // every warp reduces all W slots: lane l reads slot l % W (so every
  // slot is read, some twice, which a least-key reduction ignores); slots
  // rise with their warps' rows, so the lowest lane that holds the least
  // key reads the lowest row's slot
  const int q = wl % W;
  const int k0 = tid * R;  // this thread's first row
  const unsigned char* mask = masks + (size_t)lane * n;
  double* alpha = alphas + (size_t)lane * n;
  double* f = fs + (size_t)lane * n;
  const double C = Cs[lane];
  const long long it_cap = it_caps[lane];
  long long it = n_iter[lane];
  bool done = false;

  // rows past n hold no set (mask 0) and K entries 0: they never win a
  // reduction (every row below n ties or beats them, at a lower row), so
  // the sweeps need no guard
  Rows<R, SMEM> s(rows_smem, T, tid);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = k0 + r;
    const bool in = k < n;
    s.set(r, in ? alpha[k] : 0.0, in ? f[k] : 0.0, in ? y[k] : 0.0,
          in ? diag[k] : 0.0, in && mask[k] != 0);
  }

  double ki[R], kj[R];
  // the step whose update the next sweep applies (none before the first):
  // its rows, delta, and the new alpha_i / alpha_j already clipped
  int pi = -1, pj = -1;
  double p_delta = 0.0, p_ci = 0.0, p_cj = 0.0;
  bool p_clip_all = false;
  int slot = 0;
  for (long long t = 0;; ++t) {
    // ---- the sweep: step t-1's f-update and clip, then step t's pass 1
    if (pi >= 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = k0 + r;
        s.f(r) = smo_f_update_elem(s.f(r), ki[r], kj[r], p_delta);
        s.a(r) = k == pj ? p_cj : k == pi ? p_ci : s.a(r);
      }
      if (p_clip_all) {  // the launch's first update clips all of alpha
#pragma unroll
        for (int r = 0; r < R; ++r) s.a(r) = clip(s.a(r), C);
      }
    }
    double bu = 0.0, bl = 0.0;
    int ru = 0, rl = 0, fl = 0;
    unsigned low_bits = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // I_up / I_low as sets() decides them
      const double ar = s.a(r);
      const bool at_lo = ar <= 0.0, at_hi = ar >= C;
      const bool pos = s.pos(r), neg = s.neg(r), m = s.m(r);
      const bool up = m & !((pos & at_hi) | (neg & at_lo));
      const bool low = m & !((pos & at_lo) | (neg & at_hi));
      const double fk = s.f(r);
      const double cu = up ? fk : INFINITY, cl = low ? fk : -INFINITY;
      if (r == 0) {
        bu = cu;
        bl = cl;
      } else {
        row_best<false>(cu, r, bu, ru);
        row_best<true>(cl, r, bl, rl);
      }
      fl |= (up ? 1 : 0) | (low ? 2 : 0);
      low_bits |= (low ? 1u : 0u) << r;
    }
    if (t >= n_iters) break;

    // ---- reduction 1: b_up / i and b_low / the WSS-1 j, the set flags
    {
      unsigned long long ku = min_key(bu), kl = max_key(bl);
      const int wu = warp_least(ku), wlo = warp_least(kl);
      fl = __reduce_or_sync(0xffffffffu, fl);
      if (wl == wu)
        publish_cand(c_up[slot][warp], s, ru, ku, bu, k0 + ru, fl);
      if (wl == wlo)
        publish_cand(c_low[slot][warp], s, rl, kl, bl, k0 + rl, fl);
    }
    __syncthreads();
    unsigned long long ku = c_up[slot][q].key, kl = c_low[slot][q].key;
    const Cand& ci = c_up[slot][warp_least(ku)];
    const Cand& cl = c_low[slot][warp_least(kl)];
    fl = __reduce_or_sync(0xffffffffu, c_up[slot][q].flags);
    const double gap = fl == 3 ? cl.v - ci.v : -INFINITY;
    done = (gap <= tol) || (it >= it_cap) || isnan(gap);
    if (done) break;  // uniform: every warp reduced the same slots
    const int i = ci.i;
    const double f_i = ci.f, a_i = ci.a, y_i = ci.y, d_i = ci.d;
    const double* Ki = K + (size_t)i * n;
    int j;
    double f_j, a_j, y_j, d_j, kij;
    if (wss == 2) {
#pragma unroll
      for (int r = 0; r < R; ++r) ki[r] = k0 + r < n ? Ki[k0 + r] : 0.0;
      slot ^= 1;
      // ---- pass 2 and reduction 2: WSS-2's second-order j
      double bg = 0.0;
      int rg = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool low = (low_bits >> r) & 1u;
        const double diff = s.f(r) - f_i;
        const double eta = nan_max(d_i + s.d(r) - 2.0 * ki[r], kTau);
        const double q = diff * diff / eta;
        const double g = (low & (diff > 0.0)) ? q : -INFINITY;
        if (r == 0)
          bg = g;
        else
          row_best<true>(g, r, bg, rg);
      }
      unsigned long long kg = max_key(bg);
      if (wl == warp_least(kg)) {
        Cand& c = c_low[slot][warp];
        publish_cand(c, s, rg, kg, bg, k0 + rg, 0);
        double kk = ki[0];
#pragma unroll
        for (int r = 1; r < R; ++r) kk = r == rg ? ki[r] : kk;
        c.kij = kk;
      }
      __syncthreads();
      kg = c_low[slot][q].key;
      const Cand& cj = c_low[slot][warp_least(kg)];
      j = cj.i;
      const double* Kj = K + (size_t)j * n;
#pragma unroll
      for (int r = 0; r < R; ++r) kj[r] = k0 + r < n ? Kj[k0 + r] : 0.0;
      f_j = cj.f;
      a_j = cj.a;
      y_j = cj.y;
      d_j = cj.d;
      kij = cj.kij;
    } else {
      // WSS-1: j is b_low's row; K_i, K_j and K_ij in one round trip
      j = cl.i;
      const double* Kj = K + (size_t)j * n;
      kij = Ki[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ki[r] = k0 + r < n ? Ki[k0 + r] : 0.0;
        kj[r] = k0 + r < n ? Kj[k0 + r] : 0.0;
      }
      f_j = cl.f;
      a_j = cl.a;
      y_j = cl.y;
      d_j = cl.d;
    }
    slot ^= 1;

    // ---- the scalar step, in every thread while its K_j loads are in
    // flight; the next sweep applies it
    const double eta_ij = nan_max(d_i + d_j - 2.0 * kij, kTau);
    double new_i, new_j;
    p_delta = pair_step(f_i, f_j, a_i, a_j, y_i, y_j, i == j, eta_ij, C,
                        new_i, new_j);
    p_ci = clip(new_i, C);
    p_cj = clip(new_j, C);
    p_clip_all = pi < 0;
    pi = i;
    pj = j;
    ++it;
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = k0 + r;
    if (k < n) {
      alpha[k] = s.a(r);
      f[k] = s.f(r);
    }
  }
  if (tid == 0) {
    n_iter[lane] = it;
    done_flags[lane] = done ? 1 : 0;
  }
}

// Threads of the resident kernel's block for n rows at R rows a thread.
int resident_threads(int n, int rows) {
  const int per = (n + rows - 1) / rows;
  return ((per + 31) / 32) * 32;
}

size_t resident_smem(int threads, int rows, bool smem) {
  return smem ? (size_t)rows * threads * (4 * sizeof(double) + 1) : 0;
}

template <int R, bool SMEM>
int launch_resident(const double* K, const double* diag, const double* y,
                    const unsigned char* masks, const double* Cs, double tol,
                    const long long* it_caps, long long n_iters, int wss,
                    double* alphas, double* fs, long long* n_iter,
                    unsigned char* done, int n, int b, long long k_lane,
                    long long v_lane, cudaStream_t stream) {
  const int threads = resident_threads(n, R);
  if (threads > Resident<R, SMEM>::kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = resident_smem(threads, R, SMEM);
  auto kernel = smo_chunk_resident_kernel<R, SMEM>;
  // the rows' K entries are the loop's only global reads: as much L1 as
  // the block's shared memory leaves
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      SMEM ? (int)cudaSharedmemCarveoutMaxShared
           : (int)cudaSharedmemCarveoutMaxL1);
  if (e == cudaSuccess && SMEM)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<b, threads, smem, stream>>>(K, diag, y, masks, Cs, tol, it_caps,
                                       n_iters, wss, alphas, fs, n_iter,
                                       done, n, k_lane, v_lane);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// Multi-block route: one lane over m blocks. At n = 32,560 the one-block
// kernel streams ~3.3 MB per iteration through one SM (~62 GB/s, 48-54 us
// an iteration) against a bound of ~16 n bytes (the K_i and K_j rows: 0.16
// us at 3.35 TB/s; the state's load and store, once a chunk, add little).
// Here a lane's n rows are cut into m slices, one per block; each block
// keeps its slice of alpha, f, y, diag and mask in shared memory for the
// whole launch, so an iteration reads only its slices of K_i and K_j from
// device memory, and what bounds it is the two barriers across the lane's
// blocks, not the bytes.
//
// One iteration of a lane:
//   pass 1  each block's (value, index) candidates for b_up / i and
//           b_low / j over its slice, the set flags, and the scalars
//           (f, alpha, y, diag) of each candidate's row, published in a
//           device workspace; barrier across the lane's blocks; every
//           block reduces the m candidates itself with the same NaN-first,
//           lowest-index rule (exact in any order), so every block knows
//           i, the WSS-1 j, the gap and the rows' scalars;
//   pass 2  (WSS-2) the same for j: candidates from the block's slice of
//           K_i, published with their scalars and K_ij; a second
//           barrier; reduce;
//   scalar  every block computes delta and the new alpha_i / alpha_j with
//           pair_step (WSS-1 reads K_ij from K); the owners store them;
//   pass 3  each block updates its own f slice through smo_f_update_elem
//           and clips alpha as the one-block kernel does.
// Every quantity is the one-block kernel's, by the same expressions, so
// the lane is bitwise that kernel and the plain step engine. The barrier
// is a monotonic counter per lane (zeroed by the wrapper for each launch):
// each block's thread 0 publishes, adds one (a release), and spins until the
// lane's m blocks have arrived; then warp 0 reads all m picks in one
// round trip, the winner's scalars in one more. (Polling the picks
// themselves from every lane of every warp 0, or reading every pick's
// scalars, was slower: all blocks read the same lines of L2 at once, so
// the exchange reads as few of them as it can.) Picks are
// double-buffered by iteration parity. Lanes have separate counters, so a
// lane that is done only stops its own blocks. The launch is cooperative,
// so every block is resident and no barrier can wait on a block not yet
// scheduled; the plan sizes b * m from the occupancy calculator.
// ------------------------------------------------------------------------

constexpr int kMultiThreads = 256;  // threads per block of the route
constexpr int kMultiRows = 256;     // rows per block it aims at

// A block's candidate of one reduction, in two parts: the 16-byte key
// every block reads from every other (one load each), and the scalars
// only the winner's are read of.
struct Key {
  double v;                   // its value (f, or the WSS-2 gain)
  int i;                      // its row (INT_MAX: none)
  int flags;                  // pass 1: the OR of the slice's set flags
};
struct Scalars {
  double f, a, y, d;          // f, alpha, y and diag of its row
  double kij;                 // pass 2: K_i at its row
};
struct Pick {                 // a reduced candidate, in shared memory
  Key key;
  Scalars sc;
};

// Thread 0 publishes its block's candidate (to L2: readers bypass L1).
__device__ __forceinline__ void publish(Key* key, Scalars* sc, double v,
                                        int i, int flags, int lo,
                                        const double* f_s, const double* a_s,
                                        const double* y_s, const double* d_s,
                                        double kij) {
  const bool own = i != INT_MAX;
  const int k = own ? i - lo : 0;
  __stcg(reinterpret_cast<int4*>(key),
         make_int4(__double2loint(v), __double2hiint(v), i, flags));
  __stcg(&sc->f, own ? f_s[k] : 0.0);
  __stcg(&sc->a, own ? a_s[k] : 0.0);
  __stcg(&sc->y, own ? y_s[k] : 0.0);
  __stcg(&sc->d, own ? d_s[k] : 0.0);
  __stcg(&sc->kij, kij);
}

// Warp 0 reduces the m published keys keys[q * 3] (q = 0 .. m-1: the
// lane's blocks; MAX: argmax, else argmin) into `out`, flags the OR of
// all, then fetches the winner's scalars. Reads go to L2, never L1.
template <bool MAX>
__device__ __forceinline__ void reduce_picks(const Key* keys,
                                             const Scalars* scs, int m,
                                             Pick& out) {
  const int lane = threadIdx.x & 31;
  double v = MAX ? -INFINITY : INFINITY;
  int i = INT_MAX, p = 0, fl = 0;
  for (int q = lane; q < m; q += 32) {
    const int4 raw = __ldcg(reinterpret_cast<const int4*>(keys + q * 3));
    const double cv = __hiloint2double(raw.y, raw.x);
    fl |= raw.w;
    if (MAX ? better_max(cv, raw.z, v, i) : better_min(cv, raw.z, v, i)) {
      v = cv;
      i = raw.z;
      p = q;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    const int op = __shfl_down_sync(0xffffffffu, p, off);
    fl |= __shfl_down_sync(0xffffffffu, fl, off);
    if (MAX ? better_max(ov, oi, v, i) : better_min(ov, oi, v, i)) {
      v = ov;
      i = oi;
      p = op;
    }
  }
  if (lane == 0) {
    const Scalars* c = scs + p * 3;
    out.key.v = v;
    out.key.i = i;
    out.key.flags = fl;
    out.sc.f = __ldcg(&c->f);
    out.sc.a = __ldcg(&c->a);
    out.sc.y = __ldcg(&c->y);
    out.sc.d = __ldcg(&c->d);
    out.sc.kij = __ldcg(&c->kij);
  }
}

__global__ void __launch_bounds__(kMultiThreads)
smo_chunk_multi_kernel(const double* __restrict__ K,
                       const double* __restrict__ diag,
                       const double* __restrict__ y,
                       const unsigned char* __restrict__ masks,
                       const double* __restrict__ Cs, double tol,
                       const long long* __restrict__ it_caps,
                       long long n_iters, int wss, double* alphas, double* fs,
                       long long* n_iter, unsigned char* done_flags, int n,
                       long long k_lane, long long v_lane, int m, int slice,
                       unsigned long long* counters, Key* keys,
                       Scalars* scalars) {
  extern __shared__ double state[];   // alpha, f, y, diag, K_i slices;
                                      // then the mask
  __shared__ Scratch s;
  __shared__ Pick up, low, sec;       // the lane's reduced picks
  __shared__ double s_delta;
  const int lane = blockIdx.x / m, part = blockIdx.x % m;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lo = min(n, part * slice), cnt = min(n, lo + slice) - lo;
  K += lane * k_lane;
  diag += lane * v_lane;
  y += lane * v_lane;
  double* a_s = state;
  double* f_s = a_s + slice;
  double* y_s = f_s + slice;
  double* d_s = y_s + slice;
  double* k_s = d_s + slice;
  unsigned char* m_s = reinterpret_cast<unsigned char*>(k_s + slice);
  double* alpha = alphas + (size_t)lane * n;
  double* f = fs + (size_t)lane * n;
  for (int k = tid; k < cnt; k += nt) {
    a_s[k] = alpha[lo + k];
    f_s[k] = f[lo + k];
    y_s[k] = y[lo + k];
    d_s[k] = diag[lo + k];
    m_s[k] = masks[(size_t)lane * n + lo + k];
  }
  const double C = Cs[lane];
  const long long it_cap = it_caps[lane];
  long long it = n_iter[lane];
  bool done = done_flags[lane] != 0;
  bool clip_all = true;
  unsigned long long* ctr = counters + lane;
  unsigned long long epoch = 0;   // the lane's barriers so far
  __syncthreads();

  for (long long t = 0; t < n_iters && !done; ++t) {
    // two sets of picks, by iteration parity: a block that runs ahead
    // into the next iteration never overwrites picks still being read
    const size_t set = ((size_t)lane * 2 + (t & 1)) * m * 3;
    Key* keys_t = keys + set;
    Scalars* scs_t = scalars + set;
    Key* my_key = keys_t + part * 3;
    Scalars* my_sc = scs_t + part * 3;

    // ---- pass 1 over the slice (each thread's rows are the ones it
    // updated in the last pass 3, so no barrier is needed in between)
    double vu = INFINITY, vl = -INFINITY;
    int iu = INT_MAX, il = INT_MAX, fl = 0;
    for (int k = tid; k < cnt; k += nt) {
      bool in_up, in_low;
      sets(a_s[k], y_s[k], m_s[k] != 0, C, in_up, in_low);
      const double fk = f_s[k];
      const double cu = in_up ? fk : INFINITY, cl = in_low ? fk : -INFINITY;
      if (better_min(cu, lo + k, vu, iu)) { vu = cu; iu = lo + k; }
      if (better_max(cl, lo + k, vl, il)) { vl = cl; il = lo + k; }
      fl |= (in_up ? 1 : 0) | (in_low ? 2 : 0);
    }
    block_reduce(s, vu, iu, vl, il, fl, true);
    if (tid == 0) {
      publish(my_key, my_sc, s.r_v0, s.r_i0, s.r_flags, lo, f_s, a_s, y_s,
              d_s, 0.0);
      publish(my_key + 1, my_sc + 1, s.r_v1, s.r_i1, s.r_flags, lo, f_s, a_s,
              y_s, d_s, 0.0);
    }
    lane_barrier(ctr, ++epoch * m);
    if (tid < 32) {
      reduce_picks<false>(keys_t, scs_t, m, up);
      reduce_picks<true>(keys_t + 1, scs_t + 1, m, low);
    }
    __syncthreads();
    const double gap = up.key.flags == 3 ? low.key.v - up.key.v : -INFINITY;
    done = (gap <= tol) || (it >= it_cap) || isnan(gap);
    if (done) break;  // uniform: every block of the lane reduced the same
    const int i = up.key.i;
    const double* Ki = K + (size_t)i * n;
    const Pick* pj = &low;

    if (wss == 2) {
      // ---- pass 2: WSS-2 candidates from the slice
      const double f_i = up.sc.f, diag_i = up.sc.d;
      double vg = -INFINITY;
      int ig = INT_MAX;
      for (int k = tid; k < cnt; k += nt) {
        bool in_up, in_low;
        sets(a_s[k], y_s[k], m_s[k] != 0, C, in_up, in_low);
        const double diff = f_s[k] - f_i;
        const double kik = Ki[lo + k];
        k_s[k] = kik;   // pass 3 reads it again
        const double eta = nan_max(diag_i + d_s[k] - 2.0 * kik, kTau);
        const double g =
            (in_low && diff > 0.0) ? diff * diff / eta : -INFINITY;
        if (better_max(g, lo + k, vg, ig)) { vg = g; ig = lo + k; }
      }
      block_reduce(s, INFINITY, INT_MAX, vg, ig, 0, false);
      if (tid == 0) {
        const int jg = s.r_i1;
        publish(my_key + 2, my_sc + 2, s.r_v1, jg, 0, lo, f_s, a_s, y_s, d_s,
                jg != INT_MAX ? k_s[jg - lo] : 0.0);
      }
      lane_barrier(ctr, ++epoch * m);
      if (tid < 32) reduce_picks<true>(keys_t + 2, scs_t + 2, m, sec);
      __syncthreads();
      pj = &sec;
    }
    const int j = pj->key.i;
    const double* Kj = K + (size_t)j * n;

    // ---- scalar: every block the same delta; owners store the alphas
    if (tid == 0) {
      const Scalars& si = up.sc;
      const Scalars& sj = pj->sc;
      const double kij = wss == 2 ? sj.kij : Ki[j];
      const double eta_ij = nan_max(si.d + sj.d - 2.0 * kij, kTau);
      double new_i, new_j;
      s_delta = pair_step(si.f, sj.f, si.a, sj.a, si.y, sj.y, i == j,
                          eta_ij, C, new_i, new_j);
      if (i >= lo && i < lo + cnt) a_s[i - lo] = new_i;
      if (j >= lo && j < lo + cnt) a_s[j - lo] = new_j;
    }
    __syncthreads();

    // ---- pass 3: f-update of the slice, alpha back into the box
    const double delta = s_delta;
    for (int k = tid; k < cnt; k += nt) {
      const double kik = wss == 2 ? k_s[k] : Ki[lo + k];
      f_s[k] = smo_f_update_elem(f_s[k], kik, Kj[lo + k], delta);
      if (clip_all || lo + k == i || lo + k == j) a_s[k] = clip(a_s[k], C);
    }
    clip_all = false;
    ++it;
  }
  __syncthreads();
  for (int k = tid; k < cnt; k += nt) {
    alpha[lo + k] = a_s[k];
    f[lo + k] = f_s[k];
  }
  if (part == 0 && tid == 0) {
    n_iter[lane] = it;
    done_flags[lane] = done ? 1 : 0;
  }
}

size_t multi_smem(int slice) {
  return (size_t)slice * (5 * sizeof(double) + 1);
}

// Blocks per lane for b lanes over n rows: the most, up to about
// kMultiRows rows a block, for which every lane's slice fits in a block's
// shared memory and all b * m blocks are resident at once (a cooperative
// launch). Fewer blocks mean larger slices and fewer blocks a SM, so the
// scan goes down from the most and stops at the first that fits; m = 0
// when none does (the lanes' state alone is more than the card's shared
// memory), and the wrapper then keeps one block a lane.
int multi_plan(int n, int b, int& m) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, smo_chunk_multi_kernel);
  if (e != cudaSuccess) return (int)e;
  for (m = (n + kMultiRows - 1) / kMultiRows; m >= 1; --m) {
    const size_t smem = multi_smem((n + m - 1) / m);
    if (smem + attr.sharedSizeBytes > (size_t)optin) break;
    e = cudaFuncSetAttribute(smo_chunk_multi_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, smo_chunk_multi_kernel, kMultiThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if ((long long)per_sm * sms >= (long long)b * m) return 0;
  }
  m = 0;
  return 0;
}

// ------------------------------------------------------------------------
// Cluster route ("cluster"): one lane over a thread-block cluster of m
// blocks (2-8), for wide batches at large n. There the global-state
// kernel runs each lane on one SM (24 lanes leave 108 of 132 SMs idle) and
// streams the lane's state through it every iteration (~65 n bytes: ~52
// us at n = 32,544), and the multi-block route cannot place the lanes:
// it keeps 41 bytes a row a lane in shared memory, and 24 x 32,544 x 41 B
// is more than the card has. Here:
//
//   * block rank c of the lane's cluster owns rows c T R .. (c + 1) T R -
//     1; warp w of it the 32 R rows from c T R + 32 R w, lane l of the
//     warp rows + 32 r + l (r = 0 .. R-1), so a warp reads 32 neighbouring
//     K entries at once (R rows a lane side by side would make every load
//     instruction touch 32 lines of L2), and rows rise with the rank, the
//     warp and, within a lane, with r;
//   * a lane keeps its state on chip for the whole launch: alpha, f and
//     diag in the block's shared memory (24 bytes a row, in the block's
//     row order, so a thread's offsets are constants), its mask and the
//     signs of y as bits in registers; the K rows bypass L1 (__ldcg);
//     diag_i, diag_j, y_i, y_j and K_ij, the same for every thread, load
//     beside the K rows, off the chain. 24 x 32,544 rows take 18.7 MB of
//     the card's ~30 MB of shared memory (diag there, not read through
//     L1, keeps pass 2's R diag loads out of a thread's registers);
//   * the iteration is the resident kernel's: one sweep (step t-1's
//     f-update and clip, then step t's pass 1), a thread's best row by one
//     float64 compare a row, a warp's winner by order keys (reductions of
//     the key, then of the row among the lanes that hold it: a lane's rows
//     are not contiguous), the scalar step in every thread;
//   * a reduction across the cluster is one barrier: the lane that holds a
//     warp's winner writes its key, value, row, f and alpha to the warp's
//     slot in its block's shared memory; barrier.cluster (arrive.release
//     / wait.acquire); then in every warp lane l reads slot l of the
//     lane's m W <= 32 slots through distributed shared memory, all in one
//     round trip; slots rise with the rows, so the lowest lane that holds
//     the least key holds the winner, whose fields a shuffle hands round.
//     Slots alternate by reduction parity, as in the resident kernel. That
//     replaces the multi-block route's counter spin in L2. The gap, and so
//     `done`, comes from the same slots in every block: uniform before
//     anyone breaks;
//   * lanes are independent clusters, so nothing waits across lanes; the
//     plan (kernels/smo_chunk.py::cluster_plan) places a launch only where
//     cudaOccupancyMaxActiveClusters holds all b clusters at once (a later
//     one would wait for an earlier one to end).
//
// What bounds an iteration at 24 lanes x 32,544 rows: the K_i and K_j rows
// from device memory (12.5 MB: 3.7 us at 3.35 TB/s), two round trips of
// them on the chain, two cluster barriers, and the sweeps' float64 work
// (~8,000 rows an SM). Every quantity is the resident kernel's, by the
// same expressions in the same order, so a lane is bitwise that kernel,
// the other routes and the plain step engine, and does the same work
// whatever the launch's other lanes.
// ------------------------------------------------------------------------

// The most threads a build of the cluster kernel takes at R rows a thread:
// registers bound it (the K_i and K_j rows, 4 R, beside the loop's own),
// and a cluster's 32 warps (so 512 threads a block at 2 blocks).
template <int R>
struct ClusterBuild {
  static constexpr int kThreads = R <= 8 ? 512 : R <= 16 ? 384 : 256;
};

constexpr int kMaxCluster = 8;  // blocks a cluster: the portable sizes

// A warp's candidate of one reduction, in its block's shared memory and
// read across the cluster: its order key and value, its row's f and
// alpha, its row, and (pass 1) the OR of the warp's set flags. 16-byte
// parts, so a reader takes it in three loads.
struct alignas(16) Slot {
  unsigned long long key;
  double v;
  double f, a;
  int i, flags;
};

// The lane's winner of one reduction, in every lane of every warp of the
// cluster: lane l < G = m W reads slot l of the parity's slots (block l /
// W, warp l % W, rising with the rows) through distributed shared memory,
// all lanes at once; the lowest lane with the least key holds the lowest
// row's slot, and its fields go to every lane. `flags`: the OR of the
// slots' set flags.
struct Winner {
  double v, f, a;
  int i, flags;
};

__device__ __forceinline__ Winner cluster_winner(
    const cg::cluster_group& cluster, Slot* slots, int W, int G) {
  const int wl = threadIdx.x & 31;
  unsigned long long key = ~0ull;  // above every key (keys <= 0xfff0...)
  double v = 0.0, f = 0.0, a = 0.0;
  int i = 0, fl = 0;
  if (wl < G) {
    const Slot* c = cluster.map_shared_rank(slots, wl / W) + wl % W;
    const ulonglong2 kv = *reinterpret_cast<const ulonglong2*>(&c->key);
    const double2 fa = *reinterpret_cast<const double2*>(&c->f);
    const int2 ifl = *reinterpret_cast<const int2*>(&c->i);
    key = kv.x;
    v = __longlong_as_double((long long)kv.y);
    f = fa.x;
    a = fa.y;
    i = ifl.x;
    fl = ifl.y;
  }
  const int at = warp_least(key);
  Winner w;
  w.v = __shfl_sync(0xffffffffu, v, at);
  w.f = __shfl_sync(0xffffffffu, f, at);
  w.a = __shfl_sync(0xffffffffu, a, at);
  w.i = __shfl_sync(0xffffffffu, i, at);
  w.flags = __reduce_or_sync(0xffffffffu, fl);
  return w;
}

// The lane that holds a warp's winner writes it to the warp's slot.
__device__ __forceinline__ void publish_slot(Slot& c, unsigned long long key,
                                             double v, double f, double a,
                                             int i, int flags) {
  c.key = key;
  c.v = v;
  c.f = f;
  c.a = a;
  c.i = i;
  c.flags = flags;
}

template <int R>
__global__ void __launch_bounds__(ClusterBuild<R>::kThreads)
smo_chunk_cluster_kernel(const double* __restrict__ K,
                         const double* __restrict__ diag,
                         const double* __restrict__ y,
                         const unsigned char* __restrict__ masks,
                         const double* __restrict__ Cs, double tol,
                         const long long* __restrict__ it_caps,
                         long long n_iters, int wss, double* alphas,
                         double* fs, long long* n_iter,
                         unsigned char* done_flags, int n, long long k_lane,
                         long long v_lane) {
  extern __shared__ double rows_smem[];  // alpha, f, diag
  __shared__ Slot s_up[2][kMaxWarps], s_low[2][kMaxWarps];
  const cg::cluster_group cluster = cg::this_cluster();
  const int m = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = blockIdx.x / m;
  if (done_flags[lane] != 0) return;  // the lane's whole cluster exits
  K += lane * k_lane;
  diag += lane * v_lane;
  y += lane * v_lane;
  const int tid = threadIdx.x, T = blockDim.x;
  const int wl = tid & 31, warp = tid >> 5, W = (T + 31) >> 5;
  const int G = m * W;  // <= 32: the wrapper's plan
  // this thread's row r is k0 + 32 r
  const int k0 = rank * T * R + warp * 32 * R + wl;
  // row r of this thread at a_s[32 r]: the block's rows in their order,
  // so a warp's 32 lanes hit 32 banks and every offset is a constant
  double* a_s = rows_smem + warp * 32 * R + wl;
  double* f_s = a_s + R * T;
  double* d_s = f_s + R * T;
  const double C = Cs[lane];
  const long long it_cap = it_caps[lane];
  long long it = n_iter[lane];
  bool done = false;

  // rows past n hold no set (mask 0) and K entries 0: they never win a
  // reduction, so the sweeps need no guard
  unsigned mb = 0, pos = 0, neg = 0;
  {
    const unsigned char* mask = masks + (size_t)lane * n;
    const double* alpha = alphas + (size_t)lane * n;
    const double* f = fs + (size_t)lane * n;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = k0 + 32 * r;
      const bool in = k < n;
      a_s[32 * r] = in ? alpha[k] : 0.0;
      f_s[32 * r] = in ? f[k] : 0.0;
      d_s[32 * r] = in ? diag[k] : 0.0;
      const double yk = in ? y[k] : 0.0;
      mb |= (in && mask[k] != 0 ? 1u : 0u) << r;
      pos |= (yk > 0.0 ? 1u : 0u) << r;
      neg |= (yk < 0.0 ? 1u : 0u) << r;
    }
  }

  double ki[R], kj[R];
  // the step whose update the next sweep applies (none before the first)
  int pi = -1, pj = -1;
  double p_delta = 0.0, p_ci = 0.0, p_cj = 0.0;
  bool p_clip_all = false;
  int slot = 0;
  for (long long t = 0;; ++t) {
    // ---- the sweep: step t-1's f-update and clip, then step t's pass 1
    double bu = 0.0, bl = 0.0;
    int ru = 0, rl = 0, fl = 0;
    unsigned low_bits = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = k0 + 32 * r;
      double fk = f_s[32 * r], ar = a_s[32 * r];
      if (pi >= 0) {
        fk = smo_f_update_elem(fk, ki[r], kj[r], p_delta);
        f_s[32 * r] = fk;
        const bool pair = (k == pi) | (k == pj);
        ar = k == pj ? p_cj : k == pi ? p_ci : ar;
        if (p_clip_all) ar = clip(ar, C);  // the launch's first update
        if (p_clip_all | pair) a_s[32 * r] = ar;
      }
      // I_up / I_low as sets() decides them
      const bool at_lo = ar <= 0.0, at_hi = ar >= C;
      const bool ps = (pos >> r) & 1u, ng = (neg >> r) & 1u;
      const bool mk = (mb >> r) & 1u;
      const bool up = mk & !((ps & at_hi) | (ng & at_lo));
      const bool low = mk & !((ps & at_lo) | (ng & at_hi));
      const double cu = up ? fk : INFINITY, cl = low ? fk : -INFINITY;
      if (r == 0) {
        bu = cu;
        bl = cl;
      } else {
        row_best<false>(cu, r, bu, ru);
        row_best<true>(cl, r, bl, rl);
      }
      fl |= (up ? 1 : 0) | (low ? 2 : 0);
      low_bits |= (low ? 1u : 0u) << r;
    }
    if (t >= n_iters) break;

    // ---- reduction 1: b_up / i and b_low / the WSS-1 j, the set flags
    {
      const int iu = k0 + 32 * ru, il = k0 + 32 * rl;
      unsigned long long ku = min_key(bu), kl = max_key(bl);
      const int wu = warp_least_row(ku, iu), wlo = warp_least_row(kl, il);
      fl = __reduce_or_sync(0xffffffffu, fl);
      if (wl == wu)
        publish_slot(s_up[slot][warp], ku, bu, f_s[32 * ru], a_s[32 * ru],
                     iu, fl);
      if (wl == wlo)
        publish_slot(s_low[slot][warp], kl, bl, f_s[32 * rl], a_s[32 * rl],
                     il, fl);
    }
    cluster.sync();
    const Winner wi = cluster_winner(cluster, &s_up[slot][0], W, G);
    const Winner wlw = cluster_winner(cluster, &s_low[slot][0], W, G);
    const double gap = wi.flags == 3 ? wlw.v - wi.v : -INFINITY;
    done = (gap <= tol) || (it >= it_cap) || isnan(gap);
    if (done) break;  // uniform: every warp of the cluster read the same
    const int i = wi.i;
    const double f_i = wi.f, a_i = wi.a;
    const double* Ki = K + (size_t)i * n;
    // i's diag and y (the same for every lane) with the K_i row
    const double d_i = __ldg(diag + i), y_i = __ldg(y + i);
    int j;
    double f_j, a_j;
    if (wss == 2) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = k0 + 32 * r;
        ki[r] = k < n ? __ldcg(Ki + k) : 0.0;
      }
      slot ^= 1;
      // ---- pass 2 and reduction 2: WSS-2's second-order j
      double bg = 0.0;
      int rg = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool low = (low_bits >> r) & 1u;
        const double diff = f_s[32 * r] - f_i;
        const double eta = nan_max(d_i + d_s[32 * r] - 2.0 * ki[r], kTau);
        const double q = diff * diff / eta;
        const double g = (low & (diff > 0.0)) ? q : -INFINITY;
        if (r == 0)
          bg = g;
        else
          row_best<true>(g, r, bg, rg);
      }
      const int ig = k0 + 32 * rg;
      unsigned long long kg = max_key(bg);
      if (wl == warp_least_row(kg, ig))
        publish_slot(s_low[slot][warp], kg, bg, f_s[32 * rg], a_s[32 * rg],
                     ig, 0);
      cluster.sync();
      const Winner wj = cluster_winner(cluster, &s_low[slot][0], W, G);
      j = wj.i;
      f_j = wj.f;
      a_j = wj.a;
      const double* Kj = K + (size_t)j * n;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = k0 + 32 * r;
        kj[r] = k < n ? __ldcg(Kj + k) : 0.0;
      }
    } else {
      // WSS-1: j is b_low's row; K_i and K_j in one round trip
      j = wlw.i;
      f_j = wlw.f;
      a_j = wlw.a;
      const double* Kj = K + (size_t)j * n;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = k0 + 32 * r;
        ki[r] = k < n ? __ldcg(Ki + k) : 0.0;
        kj[r] = k < n ? __ldcg(Kj + k) : 0.0;
      }
    }
    slot ^= 1;

    // ---- the scalar step, in every thread while its K_j loads are in
    // flight (K_ij, diag_j and y_j with them); the next sweep applies it
    const double kij = __ldcg(Ki + j);
    const double d_j = __ldg(diag + j), y_j = __ldg(y + j);
    const double eta_ij = nan_max(d_i + d_j - 2.0 * kij, kTau);
    double new_i, new_j;
    p_delta = pair_step(f_i, f_j, a_i, a_j, y_i, y_j, i == j, eta_ij, C,
                        new_i, new_j);
    p_ci = clip(new_i, C);
    p_cj = clip(new_j, C);
    p_clip_all = pi < 0;
    pi = i;
    pj = j;
    ++it;
  }
  // no block leaves while another may still read its slots
  cluster.sync();

  double* alpha = alphas + (size_t)lane * n;
  double* f = fs + (size_t)lane * n;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = k0 + 32 * r;
    if (k < n) {
      alpha[k] = a_s[32 * r];
      f[k] = f_s[32 * r];
    }
  }
  if (rank == 0 && tid == 0) {
    n_iter[lane] = it;
    done_flags[lane] = done ? 1 : 0;
  }
}

// Threads of the cluster kernel's blocks for n rows over m blocks at R
// rows a thread, and the block's dynamic shared memory (alpha, f, diag).
int cluster_threads(int n, int m, int rows) {
  const int per = (n + m - 1) / m;
  return ((per + 32 * rows - 1) / (32 * rows)) * 32;
}

size_t cluster_smem(int threads, int rows) {
  return (size_t)3 * rows * threads * sizeof(double);
}

// The launch of b clusters of m blocks over n rows at R rows a thread:
// cudaErrorInvalidValue where the build cannot take the block (too many
// threads, registers or shared memory for it, more than 32 warps a
// cluster: a warp reads the cluster's slots in one load a lane, or m
// outside 2..8).
template <int R>
cudaError_t cluster_config(int n, int m, int b, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute* attr, cudaStream_t stream) {
  const int threads = cluster_threads(n, m, R);
  if (m < 2 || m > kMaxCluster || threads > ClusterBuild<R>::kThreads ||
      m * (threads / 32) > 32)
    return cudaErrorInvalidValue;
  auto kernel = smo_chunk_cluster_kernel<R>;
  int dev = 0, optin = 0, regs_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&regs_sm, cudaDevAttrMaxRegistersPerBlock,
                               dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  const size_t smem = cluster_smem(threads, R);
  if (smem + fa.sharedSizeBytes > (size_t)optin ||
      (long long)fa.numRegs * threads > regs_sm)
    return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  cfg = {};
  cfg.gridDim = dim3(b * m);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = m;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int R>
int launch_cluster(const double* K, const double* diag, const double* y,
                   const unsigned char* masks, const double* Cs, double tol,
                   const long long* it_caps, long long n_iters, int wss,
                   double* alphas, double* fs, long long* n_iter,
                   unsigned char* done, int n, int b, int m,
                   long long k_lane, long long v_lane, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = cluster_config<R>(n, m, b, cfg, attr, stream);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&K,     &diag,  &y,      &masks,   &Cs,   &tol,
                  &it_caps, &n_iters, &wss, &alphas, &fs, &n_iter,
                  &done,  &n,     &k_lane, &v_lane};
  e = cudaLaunchKernelExC(&cfg, (const void*)smo_chunk_cluster_kernel<R>,
                          args);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Clusters of m blocks at R rows a thread over n rows that the card runs
// at once (cudaOccupancyMaxActiveClusters: it knows how the GPCs hold
// them); 0 where the build cannot take the block.
template <int R>
int cluster_capacity(int n, int m, int* clusters) {
  *clusters = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t e = cluster_config<R>(n, m, 1, cfg, attr, 0);
  if (e == cudaErrorInvalidValue) return 0;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, (const void*)smo_chunk_cluster_kernel<R>, &cfg);
}

template <int R>
int cluster_build(int* threads, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, smo_chunk_cluster_kernel<R>);
  *threads = ClusterBuild<R>::kThreads;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)e;
}

}  // namespace

// b lanes over K (n, n): masks, alphas, fs (b, n); Cs, it_caps, n_iter,
// done (b,). Lane l reads K + l * k_lane, diag + l * v_lane and y + l *
// v_lane (0: one K, diag and y for every lane). The block's width depends
// on n only. Every entry below takes the same two strides.
extern "C" int smo_chunk_f64(const double* K, const double* diag,
                             const double* y, const unsigned char* masks,
                             const double* Cs, double tol,
                             const long long* it_caps, long long n_iters,
                             int wss, double* alphas, double* fs,
                             long long* n_iter, unsigned char* done, int n,
                             int b, long long k_lane, long long v_lane,
                             cudaStream_t stream) {
  if (n > 0 && b > 0 && n_iters > 0) {
    int threads = ((n + 31) / 32) * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    smo_chunk_kernel<<<b, threads, 0, stream>>>(K, diag, y, masks, Cs, tol,
                                                it_caps, n_iters, wss, alphas,
                                                fs, n_iter, done, n,
                                                k_lane, v_lane);
  }
  return (int)cudaGetLastError();
}

// The resident route (smo_chunk_resident_kernel) for b lanes over n rows:
// `rows` rows a thread (1, 2, 4 or 8), in registers, or in shared memory
// with `smem` (rows 8 only); the block is 32 * ceil(n / (32 rows))
// threads. cudaErrorInvalidValue for a build that does not exist or a
// block wider than its build takes (kernels/smo_chunk.py::
// one_block_plan places only what fits).
extern "C" int smo_chunk_resident_f64(const double* K, const double* diag,
                                      const double* y,
                                      const unsigned char* masks,
                                      const double* Cs, double tol,
                                      const long long* it_caps,
                                      long long n_iters, int wss,
                                      double* alphas, double* fs,
                                      long long* n_iter, unsigned char* done,
                                      int n, int b, long long k_lane,
                                      long long v_lane, int rows, int smem,
                                      cudaStream_t stream) {
  if (n <= 0 || b <= 0 || n_iters <= 0) return (int)cudaGetLastError();
#define SMO_RESIDENT(R, S)                                                  \
  launch_resident<R, S>(K, diag, y, masks, Cs, tol, it_caps, n_iters, wss, \
                        alphas, fs, n_iter, done, n, b, k_lane, v_lane,   \
                        stream)
  if (smem) return rows == 8 ? SMO_RESIDENT(8, true)
                             : (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return SMO_RESIDENT(1, false);
    case 2: return SMO_RESIDENT(2, false);
    case 4: return SMO_RESIDENT(4, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SMO_RESIDENT
}

// A build of the resident route: its most threads a block
// (Resident<R, SMEM>::kThreads), and from the built kernel its registers a
// thread and its local memory (spills) a thread, in bytes.
// cudaErrorInvalidValue for a build that does not exist.
template <int R, bool SMEM>
int resident_build(int* threads, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, smo_chunk_resident_kernel<R, SMEM>);
  *threads = Resident<R, SMEM>::kThreads;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)e;
}

extern "C" int smo_chunk_resident_build(int rows, int smem, int* threads,
                                        int* regs, int* local_bytes) {
  if (smem) return rows == 8 ? resident_build<8, true>(threads, regs,
                                                       local_bytes)
                             : (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return resident_build<1, false>(threads, regs, local_bytes);
    case 2: return resident_build<2, false>(threads, regs, local_bytes);
    case 4: return resident_build<4, false>(threads, regs, local_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The multi-block route's plan for b lanes over n rows: m blocks a lane (0:
// the route cannot place them), and the bytes of the workspace the launch
// needs zeroed.
extern "C" int smo_chunk_multi_plan(int n, int b, int* m,
                                    long long* workspace_bytes) {
  const int e = multi_plan(n, b, *m);
  *workspace_bytes = (long long)b * (16 + 2 * 3 * (long long)*m *
                                              (sizeof(Key) + sizeof(Scalars)));
  return e;
}

// As smo_chunk_f64, each lane over m blocks (smo_chunk_multi_plan's), with
// `workspace` its zeroed bytes: b barrier counters (16 bytes each, so the
// keys after them stay 16-byte aligned), the keys, then the scalars. The
// launch is cooperative (cudaLaunchKernelExC with the cooperative
// attribute, which stream capture takes into a CUDA graph): it fails
// rather than start blocks that cannot all be resident.
extern "C" int smo_chunk_multi_f64(const double* K, const double* diag,
                                   const double* y, const unsigned char* masks,
                                   const double* Cs, double tol,
                                   const long long* it_caps, long long n_iters,
                                   int wss, double* alphas, double* fs,
                                   long long* n_iter, unsigned char* done,
                                   int n, int b, long long k_lane,
                                   long long v_lane, int m, void* workspace,
                                   cudaStream_t stream) {
  if (n <= 0 || b <= 0 || n_iters <= 0) return (int)cudaGetLastError();
  const int slice = (n + m - 1) / m;
  const cudaError_t a = cudaFuncSetAttribute(
      smo_chunk_multi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)multi_smem(slice));
  if (a != cudaSuccess) return (int)a;
  unsigned long long* counters =
      reinterpret_cast<unsigned long long*>(workspace);
  Key* keys = reinterpret_cast<Key*>(counters + 2 * b);
  Scalars* scalars = reinterpret_cast<Scalars*>(keys + (size_t)b * 6 * m);
  void* args[] = {&K, &diag, &y, &masks, &Cs, &tol, &it_caps, &n_iters,
                  &wss, &alphas, &fs, &n_iter, &done, &n, &k_lane,
                  &v_lane, &m, const_cast<int*>(&slice), &counters, &keys,
                  &scalars};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * m);
  cfg.blockDim = dim3(kMultiThreads);
  cfg.dynamicSmemBytes = multi_smem(slice);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelExC(&cfg, (const void*)smo_chunk_multi_kernel, args);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The cluster route (smo_chunk_cluster_kernel) for b lanes over n rows:
// each lane a cluster of m blocks (2..8), `rows` rows a thread (4, 8, 16
// or 32), 32 * ceil(ceil(n / m) / (32 rows)) threads a block. The launch is
// cudaLaunchKernelExC with the cluster-dimension attribute; a shape the
// build cannot take returns cudaErrorInvalidValue, and a refused launch
// its error (kernels/smo_chunk.py::cluster_plan places only shapes of
// which the card holds all b clusters at once).
extern "C" int smo_chunk_cluster_f64(const double* K, const double* diag,
                                     const double* y,
                                     const unsigned char* masks,
                                     const double* Cs, double tol,
                                     const long long* it_caps,
                                     long long n_iters, int wss,
                                     double* alphas, double* fs,
                                     long long* n_iter, unsigned char* done,
                                     int n, int b, long long k_lane,
                                     long long v_lane, int m, int rows,
                                     cudaStream_t stream) {
  if (n <= 0 || b <= 0 || n_iters <= 0) return (int)cudaGetLastError();
#define SMO_CLUSTER(R)                                                      \
  launch_cluster<R>(K, diag, y, masks, Cs, tol, it_caps, n_iters, wss,     \
                    alphas, fs, n_iter, done, n, b, m, k_lane, v_lane,   \
                    stream)
  switch (rows) {
    case 4: return SMO_CLUSTER(4);
    case 8: return SMO_CLUSTER(8);
    case 16: return SMO_CLUSTER(16);
    case 32: return SMO_CLUSTER(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SMO_CLUSTER
}

// Clusters of m blocks at `rows` rows a thread over n rows that the card
// runs at once (0 where the build cannot take the block).
extern "C" int smo_chunk_cluster_capacity(int n, int m, int rows,
                                          int* clusters) {
  switch (rows) {
    case 4: return cluster_capacity<4>(n, m, clusters);
    case 8: return cluster_capacity<8>(n, m, clusters);
    case 16: return cluster_capacity<16>(n, m, clusters);
    case 32: return cluster_capacity<32>(n, m, clusters);
    default: *clusters = 0; return (int)cudaErrorInvalidValue;
  }
}

// A build of the cluster route: its most threads a block
// (ClusterBuild<R>::kThreads), and from the built kernel its registers a
// thread and its local memory (spills) a thread, in bytes.
extern "C" int smo_chunk_cluster_build(int rows, int* threads, int* regs,
                                       int* local_bytes) {
  switch (rows) {
    case 4: return cluster_build<4>(threads, regs, local_bytes);
    case 8: return cluster_build<8>(threads, regs, local_bytes);
    case 16: return cluster_build<16>(threads, regs, local_bytes);
    case 32: return cluster_build<32>(threads, regs, local_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}
