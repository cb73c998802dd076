// Alpha seeding's device loops in float64: water_fill's bisection, SIR's
// greedy replacement pass, one step of ATO's ramp over a row of lanes in
// two halves (ato_system before the LU solve, ato_apply after it; the solo
// ramp is one lane), and the LOO seeders' spills (avg_spill, top_spill).
//
// Replaces the reference's jitted device loops in src/repro/core/seeding.py
// (lax loops, not Pallas): water_fill's fori_loop (:61), sir_seed's
// fori_loop over |R| (:225), the body of _ato_ramp's while_loop
// (:361-420) and its vmap over a C row (_ato_seed_batch_jit, :435),
// avg_seed_loo's 8-round spill (:537) and top_seed_loo's spill over the
// instances in order of similarity (:566), which would otherwise run as
// eager torch ops launched from the host (~8 launches a bisection step, ~20
// a removed row, ~50 and four host syncs a ramp step, ~10 a spill step).
//
// Every loop here is sequential by nature and small (|T| and |R| are a
// tenth of n, the working set a few hundred rows), so each kernel is bound
// by its chain of block-wide reductions, not by bytes or operations: one
// block runs the whole loop on chip, with one reduction (a few barriers)
// a step. water_fill keeps beta, lo and hi in shared memory while they fit
// and streams them from L2 past that (repair_equality's S side at n =
// 32,560: ~26,000 rows). sir_greedy keeps each thread's share of T
// (priorities, labels, used bits) in registers and loads the next row of
// the kernel block while it reduces this one. ato_system compacts the free set in ascending order (what
// torch.nonzero gives, with no host sync) redundantly in every block, so
// that one launch of many blocks also writes the bordered (m_cap + 1)^2
// KKT matrix row by row. ato_apply reduces the step size, applies the f
// update and retires / graduates rows in one block, and writes the ramp's
// device stop flag, which the host reads once per chunk of steps. Over a
// row of lanes (a grid's C row, one fold transition) each lane takes the
// same code on its own slice: ato_system's blocks are a (rows, lanes) grid,
// ato_apply runs a block a lane, so a lane's outputs do not depend on the
// other lanes. avg_spill runs its 8 rounds in one
// block, two block reductions a round (the count, exact, and the sum of the
// adds). top_spill is a chain through the residual: one thread walks the
// order over lo, hi and beta that the block gathered into shared memory,
// and stops where the residual is 0, past which every take is a zero.
//
// Built with -fmad=false (kernels/_build.py): each expression rounds op by
// op as the plain versions (kernels/ref.py) do, the f update being one
// fma as torch.addcmul rounds it. Only sums differ in order from torch's
// (water_fill's, ato_system's b and r0); every compare, copy, min and max
// is exact.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "smo_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Block-wide reductions whose result every thread gets, bit for bit the
// same: a butterfly (xor) shuffle gives every lane of a warp the same value
// (each level adds a + b where the partner adds b + a), and past one warp
// every thread folds the warps' values in one order. Each takes one
// barrier: the per-warp slots are double-buffered by the caller's parity
// `par`, and a thread that comes to write a buffer again has passed the
// barrier of the call in between, which every thread reached after its
// last read of it. One warp takes none.
struct Red {
  double v[2][kMaxWarps];
  int i[2][kMaxWarps];
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <bool MAX>
__device__ __forceinline__ double warp_ext(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double o = __shfl_xor_sync(kFull, v, off);
    v = MAX ? nan_max(v, o) : nan_min(v, o);
  }
  return v;
}

// (value, index) argmax over the warp, every lane getting the winner: NaN
// wins, then the larger value, then the lower index (torch.argmax's pick).
__device__ __forceinline__ void warp_argmax(double& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (better_max(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ double block_sum(double v, Red& red, int& par) {
  v = warp_sum(v);
  const int nw = blockDim.x >> 5;
  if (nw == 1) {
    __syncwarp();
    return v;
  }
  if ((threadIdx.x & 31) == 0) red.v[par][threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
  for (int w = 0; w < nw; ++w) t += red.v[par][w];
  par ^= 1;
  return t;
}

// NaN-propagating block min (MAX = false) or max.
template <bool MAX>
__device__ double block_ext(double v, Red& red, int& par) {
  v = warp_ext<MAX>(v);
  const int nw = blockDim.x >> 5;
  if (nw == 1) {
    __syncwarp();
    return v;
  }
  if ((threadIdx.x & 31) == 0) red.v[par][threadIdx.x >> 5] = v;
  __syncthreads();
  double t = red.v[par][0];
  for (int w = 1; w < nw; ++w)
    t = MAX ? nan_max(t, red.v[par][w]) : nan_min(t, red.v[par][w]);
  par ^= 1;
  return t;
}

__device__ void block_argmax(double& v, int& i, Red& red, int& par) {
  warp_argmax(v, i);
  const int nw = blockDim.x >> 5;
  if (nw == 1) {
    __syncwarp();
    return;
  }
  if ((threadIdx.x & 31) == 0) {
    red.v[par][threadIdx.x >> 5] = v;
    red.i[par][threadIdx.x >> 5] = i;
  }
  __syncthreads();
  v = red.v[par][0];
  i = red.i[par][0];
  for (int w = 1; w < nw; ++w)
    if (better_max(red.v[par][w], red.i[par][w], v, i)) {
      v = red.v[par][w];
      i = red.i[par][w];
    }
  par ^= 1;
}

// torch.clamp(x, lo, hi) with tensor bounds: max, then min, NaN kept.
__device__ __forceinline__ double clamp_t(double x, double lo, double hi) {
  return nan_min(nan_max(x, lo), hi);
}

__device__ __forceinline__ bool same_bits(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}

// ---------------------------------------------------------------------------
// water_fill: out = clip(beta - c, lo, hi) with sum(out) == clip(target,
// sum(lo), sum(hi)), c by bisection (at most `iters` steps; it stops once
// (c_lo, c_hi) repeat, after which every step is the identity), then the
// residue added to the freest coordinate. One block.
// ---------------------------------------------------------------------------
__global__ void water_fill_kernel(const double* __restrict__ beta,
                                  const double* __restrict__ lo,
                                  const double* __restrict__ hi,
                                  const double* __restrict__ target_p,
                                  double* __restrict__ out, int n, int iters,
                                  int in_smem) {
  extern __shared__ double stage[];
  __shared__ Red red;
  int par = 0;
  const int tid = threadIdx.x, nt = blockDim.x;
  const double* B = beta;
  const double* L = lo;
  const double* H = hi;
  if (in_smem) {
    for (int i = tid; i < n; i += nt) {
      stage[i] = beta[i];
      stage[n + i] = lo[i];
      stage[2 * n + i] = hi[i];
    }
    B = stage;
    L = stage + n;
    H = stage + 2 * n;
    __syncthreads();
  }
  double slo = 0.0, shi = 0.0, mn = CUDART_INF, mx = -CUDART_INF;
  for (int i = tid; i < n; i += nt) {
    const double b = B[i], l = L[i], h = H[i];
    slo += l;
    shi += h;
    mn = nan_min(mn, b - h);
    mx = nan_max(mx, b - l);
  }
  slo = block_sum(slo, red, par);
  shi = block_sum(shi, red, par);
  mn = block_ext<false>(mn, red, par);
  mx = block_ext<true>(mx, red, par);
  const double target = nan_min(nan_max(*target_p, slo), shi);
  double c_lo = mn - 1.0, c_hi = mx + 1.0;
  for (int k = 0; k < iters; ++k) {
    const double c = 0.5 * (c_lo + c_hi);
    double s = 0.0;
    for (int i = tid; i < n; i += nt) s += clamp_t(B[i] - c, L[i], H[i]);
    const bool too_big = block_sum(s, red, par) > target;
    const double nlo = too_big ? c : c_lo, nhi = too_big ? c_hi : c;
    if (same_bits(nlo, c_lo) && same_bits(nhi, c_hi)) break;
    c_lo = nlo;
    c_hi = nhi;
  }
  const double c = 0.5 * (c_lo + c_hi);
  double s = 0.0;
  for (int i = tid; i < n; i += nt) {
    const double o = clamp_t(B[i] - c, L[i], H[i]);
    out[i] = o;
    s += o;
  }
  const double resid = target - block_sum(s, red, par);
  double rv = -CUDART_INF;
  int ri = INT_MAX;
  for (int i = tid; i < n; i += nt) {
    const double o = out[i];
    const double room = resid >= 0.0 ? H[i] - o : o - L[i];
    if (better_max(room, i, rv, ri)) {
      rv = room;
      ri = i;
    }
  }
  block_argmax(rv, ri, red, par);
  if (tid == 0) {
    const int j = ri;
    const double o = out[j];
    const double room = resid >= 0.0 ? H[j] - o : o - L[j];
    const double sgn = resid > 0.0 ? 1.0 : (resid < 0.0 ? -1.0 : 0.0);
    out[j] = o + sgn * nan_min(fabs(resid), room);
  }
}

// ---------------------------------------------------------------------------
// sir_greedy: for r = 0..m-1, removed row r hands y_T[t] * alpha_R[r] to
// the unused same-label t of largest K_RT[r, t] (lowest t on a tie), or,
// with no such t, to the unused t of largest priority (skip: to none).
// One block, one reduction (one barrier; none at one warp) a row, two where
// the fallback decides.
// ---------------------------------------------------------------------------
// The block's pick for one removed row, from each thread's best same-label
// candidate (bv, bi) and best unused priority (pv, pi): every thread gets
// `found` and `pick`; `any` says some t is unused. The priority pick
// matters only where no same-label t is left (`found` false on every
// thread alike), so it is reduced only there.
struct SirRed {
  Red kv, pr;
  int any[2][kMaxWarps];
};

__device__ __forceinline__ void sir_pick(double bv, int bi, double pv, int pi,
                                         int any, SirRed& sr, int& par,
                                         bool& found, int& pick, bool& free_t) {
  const int tid = threadIdx.x, nw = blockDim.x >> 5, w = tid >> 5;
  warp_argmax(bv, bi);
  if (nw > 1) {
    if ((tid & 31) == 0) {
      sr.kv.v[par][w] = bv;
      sr.kv.i[par][w] = bi;
    }
    __syncthreads();
    bv = sr.kv.v[par][0];
    bi = sr.kv.i[par][0];
    for (int x = 1; x < nw; ++x)
      if (better_max(sr.kv.v[par][x], sr.kv.i[par][x], bv, bi)) {
        bv = sr.kv.v[par][x];
        bi = sr.kv.i[par][x];
      }
    par ^= 1;
  }
  found = bv > -CUDART_INF;
  if (found) {            // a same-label candidate is an unused t
    pick = bi;
    free_t = true;
    return;
  }
  warp_argmax(pv, pi);
  any = __any_sync(kFull, any);
  if (nw > 1) {
    if ((tid & 31) == 0) {
      sr.pr.v[par][w] = pv;
      sr.pr.i[par][w] = pi;
      sr.any[par][w] = any;
    }
    __syncthreads();
    pv = sr.pr.v[par][0];
    pi = sr.pr.i[par][0];
    any = sr.any[par][0];
    for (int x = 1; x < nw; ++x) {
      if (better_max(sr.pr.v[par][x], sr.pr.i[par][x], pv, pi)) {
        pv = sr.pr.v[par][x];
        pi = sr.pr.i[par][x];
      }
      any |= sr.any[par][x];
    }
    par ^= 1;
  }
  pick = pi;
  free_t = any != 0;
}

// Up to E of t's entries a thread (t = tid + k nt), their priorities,
// labels and used bits held in registers for the whole pass, and the next
// row of K_RT loaded while this one is reduced: a row costs one load
// latency and one reduction. Only an entry's owner reads or writes its
// used bit and beta_T: every thread reaches the same pick, so the owner
// applies it, with no barrier after it.
template <int E>
__global__ void __launch_bounds__(kMaxThreads)
sir_greedy_kernel(const double* __restrict__ K_RT,
                                  long long ld, const double* __restrict__ y_R,
                                  const double* __restrict__ y_T,
                                  const double* __restrict__ alpha_R,
                                  const double* __restrict__ priority,
                                  double* __restrict__ beta_T, int m, int t,
                                  int skip) {
  __shared__ SirRed sr;
  const int tid = threadIdx.x, nt = blockDim.x;
  int par = 0;
  double pri[E], yt[E], next[E];
  unsigned used = 0;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int i = tid + k * nt;
    pri[k] = yt[k] = next[k] = 0.0;
    if (i < t) {
      pri[k] = priority[i];
      yt[k] = y_T[i];
      beta_T[i] = 0.0;
      if (m > 0) next[k] = K_RT[i];
    } else {
      used |= 1u << k;            // past t: never a candidate
    }
  }
  double yr_next = m > 0 ? y_R[0] : 0.0;
  for (int r = 0; r < m; ++r) {
    double kv[E];
#pragma unroll
    for (int k = 0; k < E; ++k) kv[k] = next[k];
    const double yr = yr_next;
    if (r + 1 < m) {
      const double* row = K_RT + (long long)(r + 1) * ld;
#pragma unroll
      for (int k = 0; k < E; ++k)
        if (tid + k * nt < t) next[k] = row[tid + k * nt];
      yr_next = y_R[r + 1];
    }
    double bv = -CUDART_INF, pv = -CUDART_INF;
    int bi = INT_MAX, pi = INT_MAX, any = 0;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if ((used >> k) & 1u) continue;
      const int i = tid + k * nt;
      any = 1;
      if (better_max(pri[k], i, pv, pi)) {
        pv = pri[k];
        pi = i;
      }
      if (yt[k] == yr && better_max(kv[k], i, bv, bi)) {
        bv = kv[k];
        bi = i;
      }
    }
    bool found, free_t;
    int pick;
    sir_pick(bv, bi, pv, pi, any, sr, par, found, pick, free_t);
    if (free_t && (found || !skip) && pick % nt == tid) {
      const int own = pick / nt;
#pragma unroll
      for (int k = 0; k < E; ++k)
        if (k == own) {
          used |= 1u << k;
          beta_T[pick] = yt[k] * alpha_R[r];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// ato_system: the ramp step's masks, bias b, directions v and w = y * v,
// the free set compacted into idx[m_cap] (ascending, padded with row 0),
// lane = j < nf, yM, the bordered KKT matrix
//     B = [[nf > 0 ? 0 : 1, yM^T], [yM, (yM yM^T) * K[idx][:, idx] + diag]]
// (diag: lam on lanes, 1 on padding; lam = 1e-10 (1 + max |diag Q|)) and
// rhs[0] = nf > 0 ? sum(w) : 0. Every block compacts the free set in
// shared memory; block 0 writes the vectors; the blocks share B's rows.
// ---------------------------------------------------------------------------
// Lane l = blockIdx.y reads row l of alpha, f, T_act, R_act (n each), its
// b_fallback and C (Cs[l]), and writes row l of every output.
__global__ void ato_system_kernel(
    const double* __restrict__ K, int n, const double* __restrict__ y,
    const double* __restrict__ alpha, const double* __restrict__ f,
    const double* __restrict__ b_fallback, const bool* __restrict__ in_S,
    const bool* __restrict__ in_T, const bool* __restrict__ T_act,
    const bool* __restrict__ R_act, const double* __restrict__ Cs,
    int m_cap, bool* __restrict__ train_now_o, bool* __restrict__ free_o,
    long long* __restrict__ nf_o, double* __restrict__ b_o,
    double* __restrict__ v_o, double* __restrict__ w_o,
    long long* __restrict__ idx_o, bool* __restrict__ lane_o,
    double* __restrict__ yM_o, double* __restrict__ Bm,
    double* __restrict__ rhs) {
  {
    const long long l = blockIdx.y, ln = l * n, lm = l * m_cap,
                    M1 = (long long)m_cap + 1;
    alpha += ln;
    f += ln;
    T_act += ln;
    R_act += ln;
    b_fallback += l;
    train_now_o += ln;
    free_o += ln;
    v_o += ln;
    w_o += ln;
    nf_o += l;
    b_o += l;
    idx_o += lm;
    lane_o += lm;
    yM_o += lm;
    Bm += l * M1 * M1;
    rhs += l * M1;
  }
  const double C = Cs[blockIdx.y];
  extern __shared__ double dyn[];
  double* s_yM = dyn;                          // m_cap doubles
  int* s_idx = reinterpret_cast<int*>(dyn + m_cap);   // m_cap ints
  __shared__ Red red;
  __shared__ int wcnt[kMaxWarps];
  int par = 0;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31,
            wid = tid >> 5, nw = nt >> 5;
  const bool writer = blockIdx.x == 0;
  double sf = 0.0, sw = 0.0;
  int base = 0;
  for (int tile = 0; tile < n; tile += nt) {
    const int i = tile + tid;
    bool fr = false;
    if (i < n) {
      const bool ta = T_act[i], ra = R_act[i];
      const bool tn = in_S[i] || (in_T[i] && !ta);
      const double a = alpha[i];
      fr = tn && a > 0.0 && a < C;
      const double v = (ta ? C - a : 0.0) - (ra ? a : 0.0);
      const double w = y[i] * v;
      sw += w;
      if (fr) sf += f[i];
      if (writer) {
        train_now_o[i] = tn;
        free_o[i] = fr;
        v_o[i] = v;
        w_o[i] = w;
      }
    }
    const unsigned bal = __ballot_sync(kFull, fr);
    if (lane == 0) wcnt[wid] = __popc(bal);
    __syncthreads();
    int pre = base, tot = 0;
    for (int w = 0; w < nw; ++w) {
      if (w < wid) pre += wcnt[w];
      tot += wcnt[w];
    }
    if (fr) {
      const int pos = pre + __popc(bal & ((1u << lane) - 1u));
      if (pos < m_cap) s_idx[pos] = i;
    }
    base += tot;
    __syncthreads();
  }
  const int nf = base;
  sf = block_sum(sf, red, par);
  sw = block_sum(sw, red, par);
  for (int j = (nf < m_cap ? nf : m_cap) + tid; j < m_cap; j += nt)
    s_idx[j] = 0;
  __syncthreads();
  double dmax = -CUDART_INF;
  for (int j = tid; j < m_cap; j += nt) {
    const int r = s_idx[j];
    const bool ln = j < nf;
    const double ym = ln ? y[r] : 0.0;
    s_yM[j] = ym;
    dmax = nan_max(dmax, fabs((ym * ym) * K[(long long)r * n + r]));
    if (writer) {
      idx_o[j] = r;
      lane_o[j] = ln;
      yM_o[j] = ym;
    }
  }
  const double lam = 1e-10 * (1.0 + block_ext<true>(dmax, red, par));
  __syncthreads();   // s_yM complete (one warp's reduction has no barrier)
  if (writer && tid == 0) {
    *nf_o = nf;
    *b_o = nf > 0 ? sf / (double)nf : *b_fallback;
    rhs[0] = nf > 0 ? sw : 0.0;
  }
  const long long M1 = (long long)m_cap + 1;
  for (int r = blockIdx.x; r < M1; r += gridDim.x) {
    double* row = Bm + (long long)r * M1;
    if (r == 0) {
      for (int c = tid; c < M1; c += nt)
        row[c] = c == 0 ? (nf > 0 ? 0.0 : 1.0) : s_yM[c - 1];
      continue;
    }
    const int i = r - 1;
    const double yi = s_yM[i];
    const double* Ki = K + (long long)s_idx[i] * n;
    const double di = i < nf ? lam : 1.0;
    for (int c = tid; c < M1; c += nt) {
      if (c == 0) {
        row[0] = yi;
      } else {
        const int j = c - 1;
        row[c] = (yi * s_yM[j]) * Ki[s_idx[j]] + (i == j ? di : 0.0);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// ato_apply: eta = min(1, the smallest eta > 1e-12 that puts a bound row's
// f at b), non-finite -> 1; f += eta * g (one fma); R rows retire at alpha'
// <= thresh and T rows graduate by Eq. 5, alpha' = clip(alpha + eta (v -
// Phi), 0, C) being what smo_f_update and the clamp then store; step += 1;
// done = eta >= 1 or step == max_steps or no R or T row active. A step
// that starts done writes eta = 0 and changes nothing. One block.
// ---------------------------------------------------------------------------
// Lane l = blockIdx.x: row l of g, f, alpha, v, Phi, train_now, free_m,
// T_act and R_act, and entry l of b, done, step and eta (y is shared); C is
// Cs[l]; thresh = 1e-12 max(C, 1).
__global__ void ato_apply_kernel(
    const double* __restrict__ g, double* __restrict__ f,
    const double* __restrict__ alpha, const double* __restrict__ v,
    const double* __restrict__ Phi, const double* __restrict__ y,
    const double* __restrict__ b_p, const bool* __restrict__ train_now,
    const bool* __restrict__ free_m, bool* __restrict__ T_act,
    bool* __restrict__ R_act, bool* __restrict__ done,
    long long* __restrict__ step, double* __restrict__ eta_o, int n,
    const double* __restrict__ Cs, double tol, long long max_steps) {
  __shared__ Red red;
  int par = 0;
  const int tid = threadIdx.x, nt = blockDim.x;
  {
    const long long l = blockIdx.x, ln = l * n;
    g += ln;
    f += ln;
    alpha += ln;
    v += ln;
    Phi += ln;
    train_now += ln;
    free_m += ln;
    T_act += ln;
    R_act += ln;
    b_p += l;
    done += l;
    step += l;
    eta_o += l;
  }
  const double C = Cs[blockIdx.x];
  const double thresh = 1e-12 * (1.0 > C ? 1.0 : C);   // Python's max(C, 1)
  if (*done) {
    if (tid == 0) *eta_o = 0.0;
    return;
  }
  const double b = *b_p;
  double mn = CUDART_INF;
  for (int i = tid; i < n; i += nt) {
    const double gi = g[i];
    const bool live = fabs(gi) > 1e-12;
    const bool bound = train_now[i] && !free_m[i];
    double e = (bound && live) ? (b - f[i]) / gi : CUDART_INF;
    e = e > 1e-12 ? e : CUDART_INF;
    mn = nan_min(mn, e);
  }
  mn = block_ext<false>(mn, red, par);
  double eta = nan_min(mn, 1.0);
  if (!isfinite(eta)) eta = 1.0;
  int anyR = 0, anyT = 0;
  for (int i = tid; i < n; i += nt) {
    const double a = clamp_t(fma(eta, v[i] - Phi[i], alpha[i]), 0.0, C);
    const double fi = fma(eta, g[i], f[i]);
    f[i] = fi;
    const bool ra = R_act[i] && a > thresh;
    R_act[i] = ra;
    anyR |= ra;
    const double yi = y[i];
    const bool ok_m = a > 0.0 && a < C && fabs(fi - b) <= tol;
    const bool ok_u = ((yi > 0.0 && a <= 0.0) || (yi < 0.0 && a >= C)) &&
                      fi >= b - tol;
    const bool ok_l = ((yi > 0.0 && a >= C) || (yi < 0.0 && a <= 0.0)) &&
                      fi <= b + tol;
    const bool ta = T_act[i] && !(ok_m || ok_u || ok_l);
    T_act[i] = ta;
    anyT |= ta;
  }
  anyR = __syncthreads_or(anyR);
  anyT = __syncthreads_or(anyT);
  if (tid == 0) {
    *eta_o = eta;
    const long long st = *step + 1;
    *step = st;
    *done = eta >= 1.0 || st >= max_steps || !(anyR || anyT);
  }
}

// ---------------------------------------------------------------------------
// avg_spill: avg_seed_loo's spill of the held-out residual over the free set,
// `rounds` times: room = resid >= 0 ? hi - beta : beta - lo, can = free0 &
// room > 1e-15, share = resid / max(#can, 1), add = clip(can ? share : 0,
// -(beta - lo), hi - beta), beta += add, resid -= sum(add). One block; each
// thread owns rows tid + k nt of out (beta's copy) and reads them from L1/L2;
// #can is an integer count (exact), sum(add) sums in the block's order.
// ---------------------------------------------------------------------------
__global__ void avg_spill_kernel(const double* __restrict__ beta,
                                 const double* __restrict__ lo,
                                 const double* __restrict__ hi,
                                 const bool* __restrict__ free0,
                                 const double* __restrict__ resid_p,
                                 double* __restrict__ out, int n,
                                 int rounds) {
  __shared__ Red red;
  int par = 0;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < n; i += nt) out[i] = beta[i];
  double resid = *resid_p;
  for (int r = 0; r < rounds; ++r) {
    double cnt = 0.0;
    for (int i = tid; i < n; i += nt) {
      const double b = out[i];
      const double room = resid >= 0.0 ? hi[i] - b : b - lo[i];
      cnt += (free0[i] && room > 1e-15) ? 1.0 : 0.0;
    }
    const double d = block_sum(cnt, red, par);   // integers: exact
    const double share = resid / (d > 1.0 ? d : 1.0);
    double sum_add = 0.0;
    for (int i = tid; i < n; i += nt) {
      const double b = out[i], l = lo[i], h = hi[i];
      const double room = resid >= 0.0 ? h - b : b - l;
      const bool can = free0[i] && room > 1e-15;
      const double add = clamp_t(can ? share : 0.0, -(b - l), h - b);
      out[i] = b + add;
      sum_add += add;
    }
    resid = resid - block_sum(sum_add, red, par);
  }
}

// ---------------------------------------------------------------------------
// top_spill: top_seed_loo's spill of the held-out residual over the rows in
// `order` (the first `steps`): room = resid >= 0 ? hi[j] - beta[j] : lo[j] -
// beta[j], take = clip(resid, min(room, 0), max(room, 0)), beta[j] += take,
// resid -= take. Each step needs the last one's residual, so one thread
// walks the order; the block first gathers lo, hi and beta by the order into
// shared memory (where they fit; past that the walker gathers from global
// memory), and scatters the visited rows back. Once resid == 0 every later
// take is a zero, which leaves beta's values as they are: the walk stops.
// ---------------------------------------------------------------------------
__global__ void top_spill_kernel(const long long* __restrict__ order,
                                 const double* __restrict__ beta,
                                 const double* __restrict__ lo,
                                 const double* __restrict__ hi,
                                 const double* __restrict__ resid_p,
                                 double* __restrict__ out, int n, int steps,
                                 int in_smem) {
  extern __shared__ double stage[];
  __shared__ int visited;
  const int tid = threadIdx.x, nt = blockDim.x;
  double* sb = stage;
  double* sl = stage + steps;
  double* sh = stage + 2 * (long long)steps;
  for (int i = tid; i < n; i += nt) out[i] = beta[i];
  if (in_smem) {
    for (int i = tid; i < steps; i += nt) {
      const long long j = order[i];
      sb[i] = beta[j];
      sl[i] = lo[j];
      sh[i] = hi[j];
    }
  }
  __syncthreads();
  if (tid == 0) {
    double resid = *resid_p;
    int i = 0;
    for (; i < steps && resid != 0.0; ++i) {
      const long long j = order[i];
      const double b = in_smem ? sb[i] : beta[j];
      const double room = resid >= 0.0 ? (in_smem ? sh[i] : hi[j]) - b
                                       : (in_smem ? sl[i] : lo[j]) - b;
      const double take =
          nan_min(nan_max(resid, nan_min(room, 0.0)), nan_max(room, 0.0));
      if (in_smem)
        sb[i] = b + take;
      else
        out[j] = b + take;
      resid = resid - take;
    }
    visited = i;
  }
  __syncthreads();
  if (in_smem)
    for (int i = tid; i < visited; i += nt) out[order[i]] = sb[i];
}

int threads_for(long long n, int per_thread) {
  long long t = (n + per_thread - 1) / per_thread;
  t = (t + 31) / 32 * 32;
  return (int)(t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t));
}

}  // namespace

// the most dynamic shared memory a block may take on sm_90
static constexpr int kMaxDynSmem = 227 * 1024;

extern "C" int water_fill_f64(const double* beta, const double* lo,
                              const double* hi, const double* target,
                              double* out, int n, int iters,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long stage = 3LL * 8 * n;
  const int in_smem = stage <= kMaxDynSmem - 4096;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(water_fill_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxDynSmem - 4096);
    attr = true;
  }
  water_fill_kernel<<<1, threads_for(n, 8), in_smem ? (size_t)stage : 0,
                      stream>>>(beta, lo, hi, target, out, n, iters, in_smem);
  return (int)cudaGetLastError();
}

// the most entries of T sir_greedy takes: 8 a thread of 1,024
extern "C" int sir_greedy_max_t() { return 8 * kMaxThreads; }

extern "C" int sir_greedy_f64(const double* K_RT, long long ld,
                              const double* y_R, const double* y_T,
                              const double* alpha_R, const double* priority,
                              double* beta_T, int m, int t, int skip,
                              cudaStream_t stream) {
  if (t <= 0) return 0;
  if (t > sir_greedy_max_t()) return (int)cudaErrorInvalidValue;
  const int threads = threads_for(t, 4);
  if ((long long)threads * 4 >= t)
    sir_greedy_kernel<4><<<1, threads, 0, stream>>>(
        K_RT, ld, y_R, y_T, alpha_R, priority, beta_T, m, t, skip);
  else
    sir_greedy_kernel<8><<<1, threads, 0, stream>>>(
        K_RT, ld, y_R, y_T, alpha_R, priority, beta_T, m, t, skip);
  return (int)cudaGetLastError();
}

// the most working-set rows ato_system's shared memory holds (yM + idx)
extern "C" int ato_system_max_m_cap() {
  return (kMaxDynSmem - 4096) / 12;
}

// ato_system over `lanes` lanes: alpha, f, T_act, R_act (lanes, n), Cs and
// b_fallback (lanes,); every output has a leading lane axis.
extern "C" int ato_system_lanes_f64(
    const double* K, int n, const double* y, const double* alpha,
    const double* f, const double* b_fallback, const bool* in_S,
    const bool* in_T, const bool* T_act, const bool* R_act, const double* Cs,
    int lanes, int m_cap, bool* train_now, bool* free_m, long long* nf,
    double* b, double* v, double* w, long long* idx, bool* lane, double* yM,
    double* B, double* rhs, cudaStream_t stream) {
  if (n <= 0 || m_cap <= 0 || lanes <= 0) return 0;
  if (m_cap > ato_system_max_m_cap() || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(ato_system_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxDynSmem - 4096);
    attr = true;
  }
  const int rows = m_cap + 1;
  const dim3 grid(rows < 264 ? rows : 264, lanes);
  ato_system_kernel<<<grid, 256, (size_t)12 * m_cap, stream>>>(
      K, n, y, alpha, f, b_fallback, in_S, in_T, T_act, R_act, Cs, m_cap,
      train_now, free_m, nf, b, v, w, idx, lane, yM, B, rhs);
  return (int)cudaGetLastError();
}

// ato_apply over `lanes` lanes, a block each: every array but y has a
// leading lane axis, and C is per lane (Cs).
extern "C" int ato_apply_lanes_f64(
    const double* g, double* f, const double* alpha, const double* v,
    const double* Phi, const double* y, const double* b,
    const bool* train_now, const bool* free_m, bool* T_act, bool* R_act,
    bool* done, long long* step, double* eta, int n, const double* Cs,
    int lanes, double tol, long long max_steps, cudaStream_t stream) {
  if (n <= 0 || lanes <= 0) return 0;
  ato_apply_kernel<<<lanes, threads_for(n, 4), 0, stream>>>(
      g, f, alpha, v, Phi, y, b, train_now, free_m, T_act, R_act, done, step,
      eta, n, Cs, tol, max_steps);
  return (int)cudaGetLastError();
}

extern "C" int avg_spill_f64(const double* beta, const double* lo,
                             const double* hi, const bool* free0,
                             const double* resid, double* out, int n,
                             int rounds, cudaStream_t stream) {
  if (n <= 0) return 0;
  avg_spill_kernel<<<1, threads_for(n, 4), 0, stream>>>(
      beta, lo, hi, free0, resid, out, n, rounds);
  return (int)cudaGetLastError();
}

extern "C" int top_spill_f64(const long long* order, const double* beta,
                             const double* lo, const double* hi,
                             const double* resid, double* out, int n,
                             int steps, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (steps < 0 || steps > n) return (int)cudaErrorInvalidValue;
  const long long stage = 3LL * 8 * steps;
  const int in_smem = stage <= kMaxDynSmem - 4096;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(top_spill_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxDynSmem - 4096);
    attr = true;
  }
  top_spill_kernel<<<1, threads_for(n, 4), in_smem ? (size_t)stage : 0,
                     stream>>>(order, beta, lo, hi, resid, out, n, steps,
                               in_smem);
  return (int)cudaGetLastError();
}
