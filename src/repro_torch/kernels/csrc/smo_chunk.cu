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
// Bound: what a chunk must move is the K_i and K_j rows of each iteration
// (16 n bytes) and the lane's state once: alpha, f, y, diag and the mask
// read (33 n), alpha and f written (16 n); alpha changes at i and j only,
// and the state of a lane fits on chip. So about 16 n + 49 n / iterations
// bytes an iteration. This kernel keeps the state in global memory and
// streams it every iteration (~65 n bytes). One block uses one SM, so at
// large n its iteration is one SM's share of bandwidth and its block
// barriers, not the card's; lanes run on separate SMs in parallel. At
// small n that is the better trade (kernels/smo_chunk.py::chunk_route): an
// iteration at heart's n = 270 is a latency floor of a few block barriers.
// At large n the multi-block route below spreads each lane over many SMs.
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
                       int m, int slice, unsigned long long* counters,
                       Key* keys, Scalars* scalars) {
  extern __shared__ double state[];   // alpha, f, y, diag, K_i slices;
                                      // then the mask
  __shared__ Scratch s;
  __shared__ Pick up, low, sec;       // the lane's reduced picks
  __shared__ double s_delta;
  const int lane = blockIdx.x / m, part = blockIdx.x % m;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lo = min(n, part * slice), cnt = min(n, lo + slice) - lo;
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
                                   int n, int b, int m, void* workspace,
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
                  &wss, &alphas, &fs, &n_iter, &done, &n, &m,
                  const_cast<int*>(&slice), &counters, &keys, &scalars};
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
