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
// a step. water_fill takes several bisection steps a barrier: a round
// sums every midpoint of the next levels of the bisection tree, in the
// one-level loop's order, and walks the outcomes; it keeps as many rows in
// shared memory as fit (an SVM box as beta and a bit a row: all of
// repair_equality's S side at n = 32,560, ~26,000 rows) and reads the rest
// from L2 once a round. sir_greedy splits its pass: its reads of K
// (through the index sets, no gathered block) do not depend on the earlier
// picks, so for a segment of removed rows at a time every SM builds each
// row's list of best candidates among the T still unused, and one block
// then walks the segment's rows in order over used bits in shared memory,
// a row an on-chip check. ATO's step has two routes a half. ato_apply's
// fused route reduces the step size, applies the f and alpha updates,
// retires / graduates rows and writes the ramp's device stop flag (read by
// the host once per chunk of steps) in one block, and from the rows it
// holds builds the next step's working set: the free set compacted in
// ascending order (what torch.nonzero gives, with no host sync), its
// labels, the ridge and the sums b and r0. ato_system's carried route
// then writes the bordered (m_cap + 1)^2 KKT matrix alone, every block
// storing at once; its compact route (a ramp's first step, and the
// witness) compacts the free set redundantly in every block before its
// rows of B, and the split apply (the witness of the fused one) leaves
// alpha to the caller. Over a row of lanes (a grid's C row, one fold
// transition) each lane takes the same code on its own slice:
// ato_system's blocks are a (rows, lanes) grid, ato_apply runs a block a
// lane, so a lane's outputs do not depend on the other lanes. The LOO
// spills have two routes each. The fused routes are their seeder's whole
// device work from alpha to water_fill's input, one block: avg_spill's
// forms the prologue in registers and runs its 8 rounds with one block
// reduction a round (the sum of the adds with both sides' counts for the
// next round); top_spill's forms the prologue, reads column t of K, and
// finds the order on chip only as far as the walk goes (per-warp sorted
// lists, merged 32 rows at a time by the one warp that walks them). The
// split routes (the witnesses, and TOP past the fused route's size) take
// a prologue and an order formed by plain ops: avg_spill runs its rounds
// with two block reductions each, top_spill has one thread walk the order
// over lo, hi and beta that the block gathered into shared memory. Every
// walk stops where the residual is 0, past which every take is a zero.
//
// Built with -fmad=false (kernels/_build.py): each expression rounds op by
// op as the plain versions (kernels/ref.py) do, the f and alpha updates
// being one fma each as torch.addcmul rounds them. Only sums differ in
// order from torch's (water_fill's, ATO's b and r0, which both ATO routes
// that write them sum in one order); every compare, copy, min and max is
// exact.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

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
// residue added to the freest coordinate. One block. The target is read from
// the device (target_p) or, where that is null, given by value (target_v).
// ---------------------------------------------------------------------------
// A round evaluates the next LV levels of the bisection tree: its 2^LV - 1
// midpoints, each 0.5 * (lo + hi) of the interval its path would reach (node
// q's children: 2q + 1 where the sum is not too big, c_hi = mid; 2q + 2 where
// it is, c_lo = mid). Each thread keeps one partial sum a midpoint over its
// strided rows, in the rows' order, loading each row once a round; the warp
// butterflies of all the midpoints interleave; one barrier, and every thread
// folds the warps' slots in warp order for the midpoints on its path and
// walks the round's outcomes, stopping at the first step that leaves (c_lo,
// c_hi) as they were. So every midpoint on the path is summed in the order of
// the one-level loop (LV = 1, the witness build water_fill_seq) and the
// bisection takes its steps bit for bit. The first `ns` rows are staged in
// shared memory (a box's rows as beta and one bit each), the rest are read
// from L2 each round.
#ifndef WATER_FILL_LEVELS
#define WATER_FILL_LEVELS 0   // 0: the levels the entry is given, or 2
#endif

// clamp_t with no NaN operand: nan_max and nan_min are then one compare and
// select each, bit for bit.
__device__ __forceinline__ double clamp_plain(double x, double lo, double hi) {
  const double a = lo > x ? lo : x;
  return hi < a ? hi : a;
}

template <int LV, int MAXT>
__global__ void __launch_bounds__(MAXT)
water_fill_kernel(const double* __restrict__ beta,
                  const double* __restrict__ lo,
                  const double* __restrict__ hi,
                  const double* __restrict__ target_p, double target_v,
                  double* __restrict__ out, int n, int iters, int room) {
  constexpr int NODES = (1 << LV) - 1;
  extern __shared__ double stage[];
  __shared__ Red red;
  __shared__ double slots[2][NODES][kMaxWarps];
  int par = 0, spar = 0;
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt >> 5, w = tid >> 5;
  // The first pass reads every row from global memory; it also finds
  // whether the rows are an SVM box (lo, hi) = (+0, C) or (-C, +0) with one
  // C > 0, bit for bit.
  double slo = 0.0, shi = 0.0, mn = CUDART_INF, mx = -CUDART_INF;
  double cmin = CUDART_INF, cmax = -CUDART_INF;
  bool finite = true, other = false;   // other: a row outside the box form
  for (int i = tid; i < n; i += nt) {
    const double b = beta[i], l = lo[i], h = hi[i];
    slo += l;
    shi += h;
    mn = nan_min(mn, b - h);
    mx = nan_max(mx, b - l);
    finite = finite && isfinite(b) && isfinite(l) && isfinite(h);
    const bool up = __double_as_longlong(l) == 0;   // (+0, C)
    const double c = up ? h : -l;
    other = other || !(up || __double_as_longlong(h) == 0) ||
            !(c > 0.0) || !isfinite(c);
    cmin = fmin(cmin, c);
    cmax = fmax(cmax, c);
  }
  slo = block_sum(slo, red, par);
  shi = block_sum(shi, red, par);
  mn = block_ext<false>(mn, red, par);
  mx = block_ext<true>(mx, red, par);
  cmin = block_ext<false>(cmin, red, par);
  cmax = block_ext<true>(cmax, red, par);
  const bool box = !__syncthreads_or(other) && cmin == cmax;
  // Stage as many rows as shared memory holds: beta and a bit a row (its
  // box's side) for a box, else beta, lo and hi; the rest stay in L2.
  int ns;
  unsigned* side = nullptr;
  if (box) {
    ns = (int)(((long long)(room - 4) * 32) / (8 * 32 + 4));
    ns = ns < n ? ns : n;
    side = reinterpret_cast<unsigned*>(stage + ns);
    for (int i = tid; i < (ns + 31) / 32; i += nt) side[i] = 0u;
    __syncthreads();
    for (int i = tid; i < ns; i += nt) {
      stage[i] = beta[i];
      if (__double_as_longlong(lo[i]) == 0)
        atomicOr(&side[i >> 5], 1u << (i & 31));
    }
  } else {
    ns = room / 24 < n ? room / 24 : n;
    for (int i = tid; i < ns; i += nt) {
      stage[i] = beta[i];
      stage[ns + i] = lo[i];
      stage[2 * ns + i] = hi[i];
    }
  }
  __syncthreads();
  const double C = cmin, negC = -cmin;
  // f(i, b, l, h) over this thread's rows tid + k nt in order: staged, then
  // L2; a staged box row's (l, h) is (+0, C) or (-C, +0) by its bit
  auto rows = [&](auto&& f) {
    int i = tid;
    if (box) {
      for (; i < ns; i += nt) {
        const bool up = (side[i >> 5] >> (i & 31)) & 1u;
        f(i, stage[i], up ? 0.0 : negC, up ? C : 0.0);
      }
    } else {
      for (; i < ns; i += nt)
        f(i, stage[i], stage[ns + i], stage[2 * ns + i]);
    }
    for (; i < n; i += nt) f(i, beta[i], lo[i], hi[i]);
  };
  const double target =
      nan_min(nan_max(target_p ? *target_p : target_v, slo), shi);
  double c_lo = mn - 1.0, c_hi = mx + 1.0;
  int k = 0;
  bool stop = false;
  while (k < iters && !stop) {
    double mid[NODES], s[NODES];
    {
      double a[NODES], z[NODES];
      a[0] = c_lo;
      z[0] = c_hi;
#pragma unroll
      for (int q = 0; q < NODES; ++q) {
        mid[q] = 0.5 * (a[q] + z[q]);
        s[q] = 0.0;
        if (2 * q + 2 < NODES) {
          a[2 * q + 1] = a[q];
          z[2 * q + 1] = mid[q];
          a[2 * q + 2] = mid[q];
          z[2 * q + 2] = z[q];
        }
      }
    }
    bool plain = finite;
#pragma unroll
    for (int q = 0; q < NODES; ++q) plain = plain && isfinite(mid[q]);
    if (plain) {
      rows([&](int, double b, double l, double h) {
#pragma unroll
        for (int q = 0; q < NODES; ++q) s[q] += clamp_plain(b - mid[q], l, h);
      });
    } else {
      rows([&](int, double b, double l, double h) {
#pragma unroll
        for (int q = 0; q < NODES; ++q) s[q] += clamp_t(b - mid[q], l, h);
      });
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < NODES; ++q) s[q] += __shfl_xor_sync(kFull, s[q], off);
    if (nw > 1) {
      if ((tid & 31) == 0) {
#pragma unroll
        for (int q = 0; q < NODES; ++q) slots[spar][q][w] = s[q];
      }
      __syncthreads();
    } else {
      __syncwarp();
    }
    int q = 0;
    for (int lv = 0; lv < LV && k < iters; ++lv) {
      double sum;
      if (nw > 1) {
        sum = 0.0;
        for (int x = 0; x < nw; ++x) sum += slots[spar][q][x];
      } else {
#pragma unroll
        for (int qq = 0; qq < NODES; ++qq)
          if (qq == q) sum = s[qq];
      }
      const double c = 0.5 * (c_lo + c_hi);   // == mid[q]
      const bool too_big = sum > target;
      const double nlo = too_big ? c : c_lo, nhi = too_big ? c_hi : c;
      if (same_bits(nlo, c_lo) && same_bits(nhi, c_hi)) {
        stop = true;
        break;
      }
      c_lo = nlo;
      c_hi = nhi;
      ++k;
      q = 2 * q + 1 + (too_big ? 1 : 0);
    }
    spar ^= 1;
  }
  const double c = 0.5 * (c_lo + c_hi);
  double s = 0.0;
  rows([&](int i, double b, double l, double h) {
    const double o = clamp_t(b - c, l, h);
    out[i] = o;
    s += o;
  });
  const double resid = target - block_sum(s, red, par);
  double rv = -CUDART_INF;
  int ri = INT_MAX;
  rows([&](int i, double, double l, double h) {
    const double o = out[i];
    const double room = resid >= 0.0 ? h - o : o - l;
    if (better_max(room, i, rv, ri)) {
      rv = room;
      ri = i;
    }
  });
  block_argmax(rv, ri, red, par);
  if (tid == 0) {
    const int j = ri;
    const double o = out[j];
    const double room = resid >= 0.0 ? hi[j] - o : o - lo[j];
    const double sgn = resid > 0.0 ? 1.0 : (resid < 0.0 ? -1.0 : 0.0);
    out[j] = o + sgn * nan_min(fabs(resid), room);
  }
}

// ---------------------------------------------------------------------------
// sir_greedy: for r = 0..m-1, removed row r hands y_T[t] * alpha_R[r] to
// the unused same-label t of largest K[R_idx[r], T_idx[t]] (lowest t on a
// tie, NaN first; found only if that value is above -inf), or, with none,
// to the unused t of largest priority (skip: to none). K is read through
// the indices (null: the identity over an (m, t) block of row stride ld).
// ---------------------------------------------------------------------------
// The pass is sequential only through the used bits; its reads of K are not.
// So it runs as segments of W removed rows, each two launches (and one
// ranking of the fallback's priorities first, under "random"):
//   sir_lists (every SM; the bytes): a warp a removed row of the segment
//     builds the row's top-L candidates (same label, unused when the
//     segment starts, value above -inf) in the argmax's order (NaN first,
//     then the larger value, then the lower index), as ordered 64-bit keys
//     with the index as the tie-break in a sorted list spread over the
//     warp's lanes, and writes the list, the row's count of candidates, of
//     NaN candidates and its label's class;
//   sir_order (random only, once): each t's rank in the fallback's order
//     (NaN first, then the larger priority, then the lower index), by
//     counting;
//   sir_walk (one block; the order): the used bits in shared memory (kept
//     in global memory between segments, with the walk's state), one warp
//     walks the segment's rows, 32 at a time, with the next 32 rows' lists
//     in flight (cp.async into shared memory), so a row is an on-chip
//     check: the pick is the first unused entry of the list (NaN: not
//     found), and a run of rows whose picks differ is taken in one step.
//     Where every entry is used but the row had more than L candidates,
//     the whole block rescans the row (today's per-row reduction); where
//     nothing is found, the fallback takes the first unused t of the
//     priority order (a pointer that only moves forward).
//     A label with no unused t left finds nothing, with no rescan. The
//     segment's picks are scattered into beta_T, and the counts of
//     rescanned and fallback rows added to `stats`.
// A list is built over the t still unused when its segment starts, so it
// runs out only through the picks of its own segment: the kernel block's
// hubs (the t that many rows rank first) are taken in early segments and
// are in no later list. Every decision is taken on the device, and each is
// a compare or a copy, so beta_T is the plain version's bit for bit.
constexpr int kListWarps = 8;   // sir_lists: removed rows a block
constexpr int kListLoads = 8;   // sir_lists: loads of K in flight a lane
constexpr int kOrderWarps = 8;  // sir_order: warps sharing a t's count
constexpr int kWin = 32;        // sir_walk: rows a window, a lane each

// The ascending order of doubles as 64-bit integers, -0.0 as +0.0 and
// every NaN above +inf: a > b as keys exactly where better_max ranks a
// first (with the index as the tie-break, key_better).
__device__ __forceinline__ unsigned long long order_key(double v) {
  if (isnan(v)) return ~0ull;
  const unsigned long long b = __double_as_longlong(v == 0.0 ? 0.0 : v);
  return (b >> 63) ? ~b : (b | (1ull << 63));
}

__device__ __forceinline__ bool key_better(unsigned long long ka, int ia,
                                           unsigned long long kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// The warp's sorted list: position p = s * 32 + lane holds (key[s], idx[s]),
// best first; (ck, ci), better than position L - 1, goes in at its place
// and the tail shifts down by one.
template <int L, int S>
__device__ __forceinline__ void list_insert(unsigned long long (&key)[S],
                                            int (&idx)[S],
                                            unsigned long long ck, int ci,
                                            int lane) {
  int pos = 0;
#pragma unroll
  for (int s = 0; s < S; ++s)
    pos += __popc(__ballot_sync(
        kFull, s * 32 + lane < L && key_better(key[s], idx[s], ck, ci)));
  unsigned long long nk[S];
  int ni[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    unsigned long long up = __shfl_up_sync(kFull, key[s], 1);
    int upi = __shfl_up_sync(kFull, idx[s], 1);
    if (s > 0) {
      const unsigned long long ck2 = __shfl_sync(kFull, key[s - 1], 31);
      const int ci2 = __shfl_sync(kFull, idx[s - 1], 31);
      if (lane == 0) {
        up = ck2;
        upi = ci2;
      }
    }
    const int p = s * 32 + lane;
    nk[s] = p < pos ? key[s] : (p == pos ? ck : up);
    ni[s] = p < pos ? idx[s] : (p == pos ? ci : upi);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    key[s] = nk[s];
    idx[s] = ni[s];
  }
}

__device__ __forceinline__ int label_class(double y) {
  return y == 1.0 ? 0 : (y == -1.0 ? 1 : 2);
}

__device__ __forceinline__ bool is_used(const unsigned* used, int j) {
  return (used[j >> 5] >> (j & 31)) & 1u;
}

// Rows r0 <= r < r1: head[r] = (candidates, min(NaN candidates, L) | class
// << 8); a t marked in `used` (null: none) is no candidate.
template <int L>
__global__ void __launch_bounds__(kListWarps * 32)
sir_lists_kernel(const double* __restrict__ K, long long ld,
                 const long long* __restrict__ R_idx,
                 const long long* __restrict__ T_idx,
                 const double* __restrict__ y_R,
                 const double* __restrict__ y_T, int r0, int r1, int t,
                 const unsigned* __restrict__ used,
                 int* __restrict__ lists, int2* __restrict__ head) {
  constexpr int S = (L + 31) / 32;
  constexpr int U = kListLoads;
  const int lane = threadIdx.x & 31;
  const int r = r0 + blockIdx.x * kListWarps + (threadIdx.x >> 5);
  if (r >= r1) return;
  const double yr = y_R[r];
  const double* row = K + (R_idx ? R_idx[r] : (long long)r) * ld;
  unsigned long long key[S];
  int idx[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    key[s] = 0ull;   // below every candidate's key
    idx[s] = INT_MAX;
  }
  unsigned long long tk = 0ull;   // position L - 1
  int ti = INT_MAX, cnt = 0, nnan = 0;
  for (int c0 = 0; c0 < t; c0 += 32 * U) {
    double v[U];
    bool same[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = c0 + 32 * u + lane;
      same[u] = j < t && y_T[j] == yr && !(used && is_used(used, j));
      v[u] = same[u] ? row[T_idx ? T_idx[j] : (long long)j] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = c0 + 32 * u + lane;
      const bool cand = same[u] && v[u] != -CUDART_INF;
      cnt += cand ? 1 : 0;
      nnan += (cand && isnan(v[u])) ? 1 : 0;
      const unsigned long long kk = order_key(v[u]);
      unsigned want = __ballot_sync(kFull, cand && key_better(kk, j, tk, ti));
      while (want) {
        const int src = __ffs(want) - 1;
        list_insert<L, S>(key, idx, __shfl_sync(kFull, kk, src),
                          __shfl_sync(kFull, j, src), lane);
        tk = __shfl_sync(kFull, key[(L - 1) / 32], (L - 1) % 32);
        ti = __shfl_sync(kFull, idx[(L - 1) / 32], (L - 1) % 32);
        want &= ~(1u << src);
        want &= __ballot_sync(kFull, cand && key_better(kk, j, tk, ti));
      }
    }
  }
  cnt = __reduce_add_sync(kFull, cnt);
  nnan = __reduce_add_sync(kFull, nnan);
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (s * 32 + lane < L) lists[(long long)r * L + s * 32 + lane] = idx[s];
  if (lane == 0)
    head[r] = make_int2(cnt, (nnan < L ? nnan : L) | (label_class(yr) << 8));
}

// order[rank] = t, rank = the number of t' that better_max ranks first:
// a warp's lanes are 32 t's, the block's warps split the t' between them.
__global__ void __launch_bounds__(kOrderWarps * 32)
sir_order_kernel(const double* __restrict__ priority, int t,
                 int* __restrict__ order) {
  __shared__ int part[kOrderWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  const double p = i < t ? priority[i] : 0.0;
  int rank = 0;
  for (int s = w; s < t; s += kOrderWarps)
    rank += better_max(priority[s], s, p, i) ? 1 : 0;
  part[w][lane] = rank;
  __syncthreads();
  if (w == 0 && i < t) {
    int tot = 0;
    for (int x = 0; x < kOrderWarps; ++x) tot += part[x][lane];
    order[tot] = i;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One lane takes t = pick for row r: its used bit, the row's pick, and one
// fewer unused t of its label's class.
__device__ __forceinline__ void sir_take(unsigned* used, int* picks,
                                         int* left, int r, int pick,
                                         int cls) {
  used[pick >> 5] |= 1u << (pick & 31);
  picks[r] = pick;
  if (cls < 2) --left[cls];
}

// The walking warp's fallback for row r: the first unused t of the
// priority order from fp on (every t before fp is used), taken by lane 0;
// skip (ord null) takes none.
__device__ __forceinline__ void sir_fallback(unsigned* used, int* picks,
                                             int* left, const int* ord,
                                             const double* __restrict__ y_T,
                                             int r, int t, int& fp,
                                             int lane) {
  int pick = -1;
  if (ord) {
    while (fp < t) {
      const int j = fp + lane;
      const int o = j < t ? ord[j] : 0;
      const unsigned b = __ballot_sync(kFull, j < t && !is_used(used, o));
      if (b) {
        const int f = __ffs(b) - 1;
        pick = __shfl_sync(kFull, o, f);
        fp += f;
        break;
      }
      fp += 32;
    }
  }
  if (lane == 0) {
    if (pick >= 0)
      sir_take(used, picks, left, r, pick, label_class(y_T[pick]));
    else
      picks[r] = -1;
  }
}

// The walk's state between segments (global memory, beside the used bits):
// the fallback's pointer and the unused t of each label class.
struct SirState {
  int fp, left[2];
};

// Rows r0 <= r < r1 of the walk. The first segment (r0 == 0) starts from
// nothing used and zeroes beta_T; each segment leaves its used bits and
// state in used_g and st for the next.
template <int L>
__global__ void __launch_bounds__(kMaxThreads)
sir_walk_kernel(const double* __restrict__ K, long long ld,
                const long long* __restrict__ R_idx,
                const long long* __restrict__ T_idx,
                const double* __restrict__ y_R,
                const double* __restrict__ y_T,
                const double* __restrict__ alpha_R,
                double* __restrict__ beta_T, int r0, int r1, int t,
                const int* __restrict__ lists, const int2* __restrict__ head,
                int* __restrict__ picks, const int* __restrict__ order,
                int order_in_smem, int cols_in_smem,
                unsigned* __restrict__ used_g,
                SirState* __restrict__ st, long long* __restrict__ stats) {
  // shared: the used bits ((t + 31) / 32 words); then, where they fit, the
  // fallback's order, and for the rescans K's column of each t (T_idx) and
  // the t of each label class as bits
  extern __shared__ unsigned used[];
  const int words = (t + 31) >> 5;
  int* s_order = reinterpret_cast<int*>(used + words);
  int* s_col = s_order + (order_in_smem ? t : 0);
  unsigned* s_pos = reinterpret_cast<unsigned*>(s_col + (cols_in_smem ? t : 0));
  unsigned* s_neg = s_pos + words;
  __shared__ __align__(16) int s_list[2 * kWin][L];
  __shared__ int2 s_head[2 * kWin];
  __shared__ Red red;
  __shared__ int s_row, s_cls, s_left[2];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const bool walker = tid < 32;
  int par = 0, fp = 0;
  if (r0 == 0) {
    if (tid == 0) s_left[0] = s_left[1] = 0;
    for (int i = tid; i < words; i += nt) used[i] = 0u;
    int pos = 0, neg = 0;
    for (int i = tid; i < t; i += nt) {
      beta_T[i] = 0.0;
      const double y = y_T[i];
      pos += y == 1.0 ? 1 : 0;
      neg += y == -1.0 ? 1 : 0;
    }
    pos = __reduce_add_sync(kFull, pos);
    neg = __reduce_add_sync(kFull, neg);
    __syncthreads();   // s_left zeroed
    if (lane == 0) {
      atomicAdd(&s_left[0], pos);
      atomicAdd(&s_left[1], neg);
    }
  } else {
    for (int i = tid; i < words; i += nt) used[i] = used_g[i];
    if (tid == 0) {
      s_left[0] = st->left[0];
      s_left[1] = st->left[1];
    }
    fp = st->fp;
  }
  if (order && order_in_smem)
    for (int i = tid; i < t; i += nt) s_order[i] = order[i];
  const int* ord = order && order_in_smem ? s_order : order;
  if (cols_in_smem) {
    for (int i = tid; i < words; i += nt) {
      unsigned p = 0u, q = 0u;
      for (int b = 0; b < 32 && 32 * i + b < t; ++b) {
        const double y = y_T[32 * i + b];
        p |= (y == 1.0 ? 1u : 0u) << b;
        q |= (y == -1.0 ? 1u : 0u) << b;
      }
      s_pos[i] = p;
      s_neg[i] = q;
    }
    for (int i = tid; i < t; i += nt)
      s_col[i] = T_idx ? (int)T_idx[i] : i;
  }
  // The walker takes the rows a window of kWin at a time, lane i row w + i
  // (its list and head staged a window ahead by cp.async). Each lane
  // proposes its row's first unused entry (a cursor that only moves on:
  // entries behind it are used). Of the rows from a on, the longest run
  // whose proposals are distinct and plain (no NaN, not out of entries)
  // picks them at once: row j's true pick skips only the picks of the rows
  // before it, and its proposal is none of theirs. The walk then goes on
  // from the first row that clashed (it proposes again) or, where that row
  // is the first of the run, decides it alone (a fallback, or the block's
  // rescan).
  auto stage_win = [&](int w) {
    const int q = w + lane;
    if (q < r1) {
      const int slot = q & (2 * kWin - 1);
      for (int p = 0; p < L; p += 4)
        cp_async16(&s_list[slot][p], lists + (long long)q * L + p);
      cp_async8(&s_head[slot], head + q);
    }
    cp_commit();
  };
  int w = r0, a = 0, cur = 0, cnt_l = 0, nn_l = 0, cls_l = 2, cls = 2;
  bool fresh = true;
  int n_rescan = 0, n_fb = 0;
  if (walker) stage_win(r0);
  __syncthreads();   // used and s_left complete
  while (true) {
    if (walker) {
      bool rescan = false;
      while (w < r1) {
        const int rows = r1 - w < kWin ? r1 - w : kWin;
        if (fresh) {   // window w: stage the next, wait for this one
          stage_win(w + kWin);
          cp_wait<1>();
          __syncwarp();
          if (lane < rows) {
            const int2 hd = s_head[(w + lane) & (2 * kWin - 1)];
            cnt_l = hd.x;
            nn_l = hd.y & 0xff;
            cls_l = hd.y >> 8;
          }
          cur = 0;
          a = 0;
          fresh = false;
        }
        while (a < rows) {
          const bool act = lane >= a && lane < rows;
          int c = -1;
          bool special = false;
          if (act) {
            const int* lst = s_list[(w + lane) & (2 * kWin - 1)];
            const int nl = cnt_l < L ? cnt_l : L;
            while (cur < nl && is_used(used, lst[cur])) ++cur;
            if (cur < nl) c = lst[cur];
            special = cur >= nl || cur < nn_l;
          }
          const bool plain = act && !special;
          const unsigned same = __match_any_sync(kFull, plain ? c : -2 - lane);
          const bool clash = plain && (same & ((1u << lane) - 1u)) != 0;
          const unsigned stop = __ballot_sync(kFull, act && (special || clash));
          const int k = stop ? __ffs(stop) - 1 : rows;
          const bool take = lane >= a && lane < k;
          if (take) {
            atomicOr(&used[c >> 5], 1u << (c & 31));
            picks[w + lane] = c;
          }
          const int t0 = __popc(__ballot_sync(kFull, take && cls_l == 0));
          const int t1 = __popc(__ballot_sync(kFull, take && cls_l == 1));
          if (lane == 0) {
            s_left[0] -= t0;
            s_left[1] -= t1;
          }
          __syncwarp();
          if (k > a) {   // rows a..k-1 picked; row k proposes again
            a = k;
            continue;
          }
          // row w + a, first of the run, is special: no plain pick left
          const int r = w + a, cnt = __shfl_sync(kFull, cnt_l, a),
                    pos = __shfl_sync(kFull, cur, a);
          cls = __shfl_sync(kFull, cls_l, a);
          if (pos >= (cnt < L ? cnt : L) && cnt > L &&
              (cls == 2 || s_left[cls] > 0)) {
            if (lane == 0) {   // the block rescans row r
              s_row = r;
              s_cls = cls;
            }
            rescan = true;
            break;
          }
          ++n_fb;
          sir_fallback(used, picks, s_left, ord, y_T, r, t, fp, lane);
          __syncwarp();
          ++a;
        }
        if (rescan) break;
        w += kWin;
        fresh = true;
      }
      if (!rescan && lane == 0) s_row = r1;
    }
    __syncthreads();
    const int rr = s_row;
    if (rr >= r1) break;
    // the rescan: kListLoads columns a thread in flight at once, the
    // labels and K's columns from shared memory where they are staged (a
    // row of class 0 or 1 by its class's bits, else by y_T)
    const double yr = y_R[rr];
    const double* row = K + (R_idx ? R_idx[rr] : (long long)rr) * ld;
    const int rc = s_cls;
    const unsigned* mine = rc == 0 ? s_pos : s_neg;
    const bool bits = cols_in_smem && rc < 2;
    double bv = -CUDART_INF;
    int bi = INT_MAX;
    for (int j0 = tid; j0 < t; j0 += kListLoads * nt) {
      double v[kListLoads];
      bool ok[kListLoads];
#pragma unroll
      for (int u = 0; u < kListLoads; ++u) {
        const int j = j0 + u * nt;
        ok[u] = j < t && !is_used(used, j) &&
                (bits ? is_used(mine, j) : y_T[j] == yr);
        v[u] = !ok[u] ? 0.0
               : row[cols_in_smem ? (long long)s_col[j]
                                  : (T_idx ? T_idx[j] : (long long)j)];
      }
#pragma unroll
      for (int u = 0; u < kListLoads; ++u)
        if (ok[u] && better_max(v[u], j0 + u * nt, bv, bi)) {
          bv = v[u];
          bi = j0 + u * nt;
        }
    }
    block_argmax(bv, bi, red, par);
    if (walker) {
      ++n_rescan;
      if (bv > -CUDART_INF) {
        if (lane == 0) sir_take(used, picks, s_left, rr, bi, cls);
      } else {
        ++n_fb;
        sir_fallback(used, picks, s_left, ord, y_T, rr, t, fp, lane);
      }
      __syncwarp();
      ++a;
    }
    __syncthreads();
  }
  for (int i = tid; i < words; i += nt) used_g[i] = used[i];
  for (int q = r0 + tid; q < r1; q += nt) {
    const int p = picks[q];
    if (p >= 0) beta_T[p] = y_T[p] * alpha_R[q];
  }
  if (tid == 0) {
    st->fp = fp;
    st->left[0] = s_left[0];
    st->left[1] = s_left[1];
    if (stats) {
      atomicAdd(reinterpret_cast<unsigned long long*>(stats),
                (unsigned long long)n_rescan);
      atomicAdd(reinterpret_cast<unsigned long long*>(stats + 1),
                (unsigned long long)n_fb);
    }
  }
}

// ---------------------------------------------------------------------------
// ato_system, route `compact`: the ramp step's masks, bias b, directions v
// and w = y * v, the free set compacted into idx[m_cap] (ascending, padded
// with row 0), lane = j < nf, yM, lam, the bordered KKT matrix
//     B = [[nf > 0 ? 0 : 1, yM^T], [yM, (yM yM^T) * K[idx][:, idx] + diag]]
// (diag: lam on lanes, 1 on padding; lam = 1e-10 (1 + max |diag Q|)) and
// rhs[0] = nf > 0 ? sum(w) : 0, all from the state. Every block compacts
// the free set in shared memory; block 0 writes the vectors; the blocks
// share B's rows. A ramp's first step, standalone calls and the witness
// of the carried route (below) take it.
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
    double* __restrict__ yM_o, double* __restrict__ lam_o,
    double* __restrict__ Bm, double* __restrict__ rhs) {
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
    lam_o += l;
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
    *lam_o = lam;
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
// ato_system, route `carried`: B alone, from the working set that the fused
// ato_apply (below) wrote on the step before (idx, yM, nf and lam a lane),
// so no block compacts or reduces anything before it stores: ~10 dependent
// L2 round trips of the compact route's prologue are gone, and B's bytes
// (8 MB at m_cap = 1,000) are the bound. A warp takes a segment of U x 64
// columns of one row (U = kBUnroll): each lane computes two neighbouring
// entries U times (their idx, yM and K loads all in flight) and
// stores each pair as one 16-byte store (a row whose address is 8 bytes
// off 16 stores its column 0 alone, and its pairs from column 1). Every
// entry is the compact route's expression, so B is its B bit for bit. K
// is read at [idx_i, idx_j] for every (i, j): no symmetry is assumed.
// ---------------------------------------------------------------------------
constexpr int kBWarps = 8;
// pairs of entries in flight a lane: 2 was the fastest at m_cap = 1,000 on
// the H100, one lane and three (4 and 8 were slower; PERF.md)
constexpr int kBUnroll = 2;

__global__ void __launch_bounds__(kBWarps * 32) ato_b_kernel(
    const double* __restrict__ K, int n, int m_cap, int segs,
    const long long* __restrict__ idx, const double* __restrict__ yM,
    const long long* __restrict__ nf_p, const double* __restrict__ lam_p,
    double* __restrict__ Bm) {
  const long long l = blockIdx.y, M1 = (long long)m_cap + 1;
  const long long wg = (long long)blockIdx.x * kBWarps + (threadIdx.x >> 5);
  if (wg >= M1 * segs) return;
  const int r = (int)(wg / segs), seg = (int)(wg % segs);
  const int lane = threadIdx.x & 31;
  constexpr int U = kBUnroll;
  idx += l * m_cap;
  yM += l * m_cap;
  double* row = Bm + l * M1 * M1 + (long long)r * M1;
  const long long nf = nf_p[l];
  const int i = r - 1;   // B's row r >= 1 is the working set's row i
  const double yi = r > 0 ? yM[i] : 0.0;
  const double di = i < nf ? lam_p[l] : 1.0;
  const double* Ki = K + (r > 0 ? idx[i] : 0) * (long long)n;
  const auto val = [&](int c) -> double {
    if (r == 0) return c == 0 ? (nf > 0 ? 0.0 : 1.0) : yM[c - 1];
    if (c == 0) return yi;
    const int j = c - 1;
    return (yi * yM[j]) * Ki[idx[j]] + (i == j ? di : 0.0);
  };
  const int off = (int)((reinterpret_cast<uintptr_t>(row) >> 3) & 1);
  if (off && seg == 0 && lane == 0) row[0] = val(0);
  const int c0 = off + seg * 64 * U + 2 * lane;
  double v0[U], v1[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = c0 + 64 * u;
    v0[u] = c < M1 ? val(c) : 0.0;
    v1[u] = c + 1 < M1 ? val(c + 1) : 0.0;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = c0 + 64 * u;
    if (c + 1 < M1)
      *reinterpret_cast<double2*>(row + c) = make_double2(v0[u], v1[u]);
    else if (c < M1)
      row[c] = v0[u];
  }
}

// ---------------------------------------------------------------------------
// ato_apply, route `split`: eta = min(1, the smallest eta > 1e-12 that
// puts a bound row's f at b), non-finite -> 1; f += eta * g (one fma); R
// rows retire at alpha' <= thresh and T rows graduate by Eq. 5, alpha' =
// clip(alpha + eta (v - Phi), 0, C) being what smo_f_update and the clamp
// then store; step += 1; done = eta >= 1 or step == max_steps or no R or T
// row active. A step that starts done writes eta = 0 and changes nothing.
// One block. Standalone calls and the fused route's witness take it.
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
// ato_apply, route `fused` (the ramp's): the split route's step tail
// (above), plus the alpha update alpha' = clip(fma(eta, v - Phi, alpha), 0,
// C) that the split route leaves to smo_f_update and a clamp, plus the next
// step's working set, built from the rows each thread holds after its
// update: train_now', free', v', w', nf', the free set compacted in
// ascending order into idx / lane / yM (padded with row 0), lam' from K's
// diagonal, b' and r0' = rhs[0]. What the compact route would recompute
// from the state the step leaves, bit for bit: 256 threads take rows tid +
// 256 k as ato_system_kernel does, so b' and r0' are its sums in its order
// (strided partials, butterflies, the warps folded in order); every other
// output is a compare, a copy, a product rounded alone, the one fma or a
// max. Each thread loads its R rows once, before the step size's min, and
// holds them in registers (R = 0: any n, rows read again from memory).
// Two barriers: the min, then the ballots' counts and the sums. The
// working set (train_now, free, v, b) is read and rewritten in place: a
// thread rewrites only its own rows, and b after the last barrier. A
// lane that starts done writes eta = 0 and nothing else.
// ---------------------------------------------------------------------------
constexpr int kApplyThreads = 256;

struct AtoRow {
  double g, f, a, v, phi, y, kd;
  bool tn, fr, ta, ra, s, t;
};

template <int R>
__global__ void __launch_bounds__(kApplyThreads) ato_apply_fused_kernel(
    const double* __restrict__ K, int n, const double* __restrict__ g,
    double* __restrict__ f, double* __restrict__ alpha,
    const double* __restrict__ Phi, const double* __restrict__ y,
    const bool* __restrict__ in_S, const bool* __restrict__ in_T,
    bool* __restrict__ T_act, bool* __restrict__ R_act,
    bool* __restrict__ done, long long* __restrict__ step,
    double* __restrict__ eta_o, const double* __restrict__ Cs,
    const double* __restrict__ b_fallback, double tol, long long max_steps,
    int m_cap, bool* __restrict__ train_now, bool* __restrict__ free_m,
    long long* __restrict__ nf_o, double* __restrict__ b_io,
    double* __restrict__ v_io, double* __restrict__ w_o,
    long long* __restrict__ idx_o, bool* __restrict__ lane_o,
    double* __restrict__ yM_o, double* __restrict__ lam_o,
    double* __restrict__ rhs) {
  constexpr int nt = kApplyThreads, nw = nt / 32;
  const int l = blockIdx.x;
  {
    const long long ln = (long long)l * n, lm = (long long)l * m_cap;
    g += ln;
    f += ln;
    alpha += ln;
    Phi += ln;
    T_act += ln;
    R_act += ln;
    train_now += ln;
    free_m += ln;
    v_io += ln;
    w_o += ln;
    idx_o += lm;
    lane_o += lm;
    yM_o += lm;
    rhs += (long long)l * (m_cap + 1);
  }
  extern __shared__ int wcnt[];   // [tile][warp]: each ballot's free' rows
  __shared__ Red red;
  __shared__ double part[3][nw];  // the warps' sf', sw', lam's max
  __shared__ int any_w[nw];
  int par = 0;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  // the flag is tested after the rows' loads are issued, so its round
  // trip overlaps theirs; a done lane returns before it writes anything
  const bool was_done = done[l];
  const double C = Cs[l];
  const double thresh = 1e-12 * (1.0 > C ? 1.0 : C);   // Python's max(C, 1)
  const double b = b_io[l];
  const double k00 = tid == 0 ? K[0] : 0.0;   // lam's padding term, ahead
  const int tiles = R > 0 ? R : (n + nt - 1) / nt;
  const auto load = [&](int i) {
    AtoRow r;
    r.g = g[i];
    r.f = f[i];
    r.a = alpha[i];
    r.v = v_io[i];
    r.phi = Phi[i];
    r.y = y[i];
    r.kd = K[(long long)i * n + i];
    r.tn = train_now[i];
    r.fr = free_m[i];
    r.ta = T_act[i];
    r.ra = R_act[i];
    r.s = in_S[i];
    r.t = in_T[i];
    return r;
  };
  AtoRow rows[R > 0 ? R : 1];
  double mn = CUDART_INF;
#pragma unroll
  for (int k = 0; k < tiles; ++k) {
    const int i = k * nt + tid;
    if (i < n) {
      const AtoRow r = load(i);
      if (R > 0) rows[k] = r;
      const bool live = fabs(r.g) > 1e-12;
      const bool bound = r.tn && !r.fr;
      double e = (bound && live) ? (b - r.f) / r.g : CUDART_INF;
      e = e > 1e-12 ? e : CUDART_INF;
      mn = nan_min(mn, e);
    }
  }
  if (was_done) {   // (uniform)
    if (tid == 0) eta_o[l] = 0.0;
    return;
  }
  mn = block_ext<false>(mn, red, par);
  double eta = nan_min(mn, 1.0);
  if (!isfinite(eta)) eta = 1.0;
  double sf = 0.0, sw = 0.0, dmax = -CUDART_INF;
  int anyR = 0, anyT = 0;
  unsigned fbits = 0;   // bit k: row k nt + tid is free' (R > 0)
#pragma unroll
  for (int k = 0; k < tiles; ++k) {
    const int i = k * nt + tid;
    bool fr = false;
    if (i < n) {
      const AtoRow r = R > 0 ? rows[k] : load(i);
      const double a = clamp_t(fma(eta, r.v - r.phi, r.a), 0.0, C);
      const double fi = fma(eta, r.g, r.f);
      const bool ra = r.ra && a > thresh;
      const double yi = r.y;
      const bool ok_m = a > 0.0 && a < C && fabs(fi - b) <= tol;
      const bool ok_u = ((yi > 0.0 && a <= 0.0) || (yi < 0.0 && a >= C)) &&
                        fi >= b - tol;
      const bool ok_l = ((yi > 0.0 && a >= C) || (yi < 0.0 && a <= 0.0)) &&
                        fi <= b + tol;
      const bool ta = r.ta && !(ok_m || ok_u || ok_l);
      anyR |= ra;
      anyT |= ta;
      // step s+1's row, as ato_system_kernel computes it from the state
      const bool tn = r.s || (r.t && !ta);
      fr = tn && a > 0.0 && a < C;
      const double v = (ta ? C - a : 0.0) - (ra ? a : 0.0);
      const double w = yi * v;
      sw += w;
      if (fr) sf += fi;
      if (fr) dmax = nan_max(dmax, fabs((yi * yi) * r.kd));
      f[i] = fi;
      alpha[i] = a;
      R_act[i] = ra;
      T_act[i] = ta;
      train_now[i] = tn;
      free_m[i] = fr;
      v_io[i] = v;
      w_o[i] = w;
    }
    const unsigned bal = __ballot_sync(kFull, fr);
    if (lane == 0) wcnt[k * nw + wid] = __popc(bal);
    if (R > 0 && fr) fbits |= 1u << k;
  }
  sf = warp_sum(sf);
  sw = warp_sum(sw);
  dmax = warp_ext<true>(dmax);
  anyR = __any_sync(kFull, anyR);
  anyT = __any_sync(kFull, anyT);
  if (lane == 0) {
    part[0][wid] = sf;
    part[1][wid] = sw;
    part[2][wid] = dmax;
    any_w[wid] = anyR | (anyT << 1);
  }
  __syncthreads();
  // block_sum's fold: 0.0 plus the warps' partials in order
  double SF = 0.0, SW = 0.0, DM = part[2][0];
  int any = 0;
  for (int w = 0; w < nw; ++w) {
    SF += part[0][w];
    SW += part[1][w];
    if (w > 0) DM = nan_max(DM, part[2][w]);
    any |= any_w[w];
  }
  // the free rows' places: the counts of earlier tiles and warps, then the
  // lanes below in the ballot
  int base = 0;
  double dcap = -CUDART_INF;   // lam's max over the placed rows alone
#pragma unroll
  for (int k = 0; k < tiles; ++k) {
    const int i = k * nt + tid;
    const bool fr = R > 0 ? ((fbits >> k) & 1u) != 0
                          : (i < n && free_m[i]);
    const unsigned bal = __ballot_sync(kFull, fr);
    int pre = base, tot = 0;
    for (int w = 0; w < nw; ++w) {
      const int c = wcnt[k * nw + w];
      if (w < wid) pre += c;
      tot += c;
    }
    if (fr) {
      const int pos = pre + __popc(bal & ((1u << lane) - 1u));
      if (pos < m_cap) {
        const double yi = R > 0 ? rows[k].y : y[i];
        idx_o[pos] = i;
        lane_o[pos] = true;
        yM_o[pos] = yi;
        dcap = nan_max(dcap, fabs((yi * yi) *
                                  (R > 0 ? rows[k].kd
                                         : K[(long long)i * n + i])));
      }
    }
    base += tot;
  }
  const int nf = base;
  if (nf > m_cap)   // (uniform) some free rows are not placed: lam over
    DM = block_ext<true>(dcap, red, par);   // the placed ones alone
  for (int j = (nf < m_cap ? nf : m_cap) + tid; j < m_cap; j += nt) {
    idx_o[j] = 0;
    lane_o[j] = false;
    yM_o[j] = 0.0;
  }
  if (tid == 0) {
    if (nf < m_cap) DM = nan_max(DM, fabs((0.0 * 0.0) * k00));   // padding
    eta_o[l] = eta;
    const long long st = step[l] + 1;
    step[l] = st;
    done[l] = eta >= 1.0 || st >= max_steps || any == 0;
    nf_o[l] = nf;
    b_io[l] = nf > 0 ? SF / (double)nf : b_fallback[l];
    lam_o[l] = 1e-10 * (1.0 + DM);
    rhs[0] = nf > 0 ? SW : 0.0;
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

// ---------------------------------------------------------------------------
// The LOO seeders' prologue (ref.loo_start_ref), row j of (y, alpha, C, t)
// from its y_j = yy and alpha_j = a: beta = y alpha (one rounding), the box
// hi = y > 0 ? C : 0 and lo = hi - C (exact: +0.0 or -C), row t closed
// (beta, lo and hi +0.0; its mass y_t alpha_t is the residual), free0 = 0 <
// alpha < C but row t.
// ---------------------------------------------------------------------------
struct LooRow {
  double b, l, h;
  bool free;
};

__device__ __forceinline__ LooRow loo_row(double a, double yy, double C,
                                          int t, int j) {
  LooRow r;
  r.h = yy > 0.0 ? C : 0.0;
  r.l = r.h - C;
  r.b = yy * a;
  r.free = a > 0.0 && a < C && j != t;
  if (j == t) r.b = r.l = r.h = 0.0;
  return r;
}

// ---------------------------------------------------------------------------
// avg_spill, route fused: avg_seed_loo's device work from alpha to
// water_fill's input in one block of threads_for(n, 4) threads: the
// prologue (loo_row), the kAvgRounds rounds, and beta, lo and hi written
// once.
// A thread keeps its rows tid + k nt (the split kernel's map) in registers,
// kAvgRows of them (every row up to n = 4,096), each with its rooms above
// (hi - beta) and below (beta - lo); past that a row's beta lives in shared
// memory as far as it holds them, then in `out` (L2), and its box and free
// bit are formed again from y and alpha each round. One reduction a round:
// round r's pass forms, on the beta it leaves, the rooms and the counts of
// free rows with room above (> 1e-15) and below that round r + 1 reads,
// and the block reduces (sum of the adds, both counts) behind one barrier;
// the next round takes the count on its residual's side. Round 0's counts
// come with the entry loads: 9 reductions where the split kernel takes 16.
// The counts are integers (exact); the sum of the adds keeps block_sum's
// tree (the same rows a thread summed in k order, the same butterfly and
// fold of the warps), so beta is the split kernel's bit for bit. What bounds
// it is the chain of rounds, not bytes (chip_spill_phases.py splits it):
// a round is its pass over the rows (FP64 chains) and its reduction, and a
// residual of 0 skips the division, whose slow path its operand would take.
// ---------------------------------------------------------------------------
constexpr int kAvgRows = 4;
// the reference's rounds (src/repro/core/seeding.py:548)
constexpr int kAvgRounds = 8;

// A warp's slot of a reduction: one 16-byte store and load.
struct __align__(16) AvgSlot {
  double v;
  int up, down;
};

struct AvgRed {
  AvgSlot s[2][kMaxWarps];
};

// The block's (s, up, down), every thread getting them, behind one barrier
// (slots double-buffered by `par`, as block_sum's): with SUM, s is a sum of
// adds, summed in block_sum's order; without, a count the warp already
// shares (exact as a double).
// The slots of up to MW warps are loaded before the fold.
template <bool SUM, int MW>
__device__ __forceinline__ void avg_reduce(double& s, int& up, int& down,
                                           AvgRed& red, int& par) {
  if (SUM) s = warp_sum(s);
  up = __reduce_add_sync(kFull, up);
  down = __reduce_add_sync(kFull, down);
  const int nw = blockDim.x >> 5;
  if (nw == 1) {
    __syncwarp();
    return;
  }
  if ((threadIdx.x & 31) == 0) red.s[par][threadIdx.x >> 5] = {s, up, down};
  __syncthreads();
  double tot = 0.0;
  up = down = 0;
#pragma unroll
  for (int q = 0; q < MW; ++q) {
    if (q >= nw) break;
    const AvgSlot slot = red.s[par][q];
    tot += slot.v;
    up += slot.up;
    down += slot.down;
  }
  s = tot;
  par ^= 1;
}

// A spill whose beta, C and residual start within +-kAvgBig stays finite in
// every round (beta within its box after round 0, the residual within its
// start plus n boxes a round, far below overflow for any n and rounds below
// 2^80): no operand of a clamp is NaN, so clamp_plain is clamp_t bit for
// bit, without its NaN tests.
constexpr double kAvgBig = 1e280;

template <int MAXT>
__global__ void __launch_bounds__(MAXT)
avg_spill_fused_kernel(const double* __restrict__ y,
                       const double* __restrict__ alpha, double C, int t,
                       double* __restrict__ out, double* __restrict__ lo_o,
                       double* __restrict__ hi_o, int n, int room) {
  constexpr int R = kAvgRows;
  extern __shared__ double spill[];   // rows k >= R: [(k - R) nt + tid]
  __shared__ AvgRed red;
  int par = 0;
  const int tid = threadIdx.x, nt = blockDim.x;
  const double a_t = alpha[t], y_t = y[t];
  // a row in registers: beta, its room above (h - b) and below (b - l),
  // whether each exceeds 1e-15, its box's hi and lo, and its free bit
  double b[R], up_r[R], dn_r[R], h[R], l[R];
  bool gu[R], gd[R], fr[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {   // every load in flight at once
    const int j = tid + k * nt;
    b[k] = j < n ? alpha[j] : 0.0;
    h[k] = j < n ? y[j] : 0.0;
  }
  int up = 0, down = 0;
  bool big = false;
  // a row's rooms and counts on beta bb: what round r + 1 reads
  auto rooms = [&](double bb, double ll, double hh, bool f, double& r_up,
                   double& r_dn, bool& g_up, bool& g_dn) {
    r_up = hh - bb;
    r_dn = bb - ll;
    g_up = r_up > 1e-15;
    g_dn = r_dn > 1e-15;
    up += (f && g_up) ? 1 : 0;
    down += (f && g_dn) ? 1 : 0;
  };
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int j = tid + k * nt;
    const LooRow r = loo_row(b[k], h[k], C, t, j);
    b[k] = l[k] = h[k] = up_r[k] = dn_r[k] = 0.0;
    gu[k] = gd[k] = fr[k] = false;
    if (j < n) {
      b[k] = r.b;
      l[k] = r.l;
      h[k] = r.h;
      fr[k] = r.free;
      rooms(r.b, r.l, r.h, r.free, up_r[k], dn_r[k], gu[k], gd[k]);
      big |= !(fabs(r.b) <= kAvgBig);
    }
  }
  for (int j = tid + R * nt, s = tid; j < n; j += nt, s += nt) {
    const LooRow r = loo_row(alpha[j], y[j], C, t, j);
    lo_o[j] = r.l;
    hi_o[j] = r.h;
    (s < room ? spill[s] : out[j]) = r.b;
    double r_up, r_dn;
    bool g_up, g_dn;
    rooms(r.b, r.l, r.h, r.free, r_up, r_dn, g_up, g_dn);
    big |= !(fabs(r.b) <= kAvgBig);
  }
  double resid = y_t * a_t;
  double bigs = __any_sync(kFull, big) ? 1.0 : 0.0;
  avg_reduce<false, MAXT / 32>(bigs, up, down, red, par);
  // the rounds, with the clamp's NaN tests (PLAIN false) or without
  auto spill_rounds = [&](auto plain) {
    for (int rd = 0; rd < kAvgRounds; ++rd) {
      const bool pos = resid >= 0.0;
      const int d = pos ? up : down;
      // 0 / d is resid itself (d >= 1), and skips the division's slow path
      const double share =
          resid == 0.0 ? resid : resid / (d > 1 ? (double)d : 1.0);
      double sum = 0.0;
      up = down = 0;
      // every register row, past n too, without a branch: the four rows'
      // chains interleave. A row past n (all +0.0, not free) adds +0.0, and
      // the sum, which starts at +0.0, is never -0.0: its bits stay.
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const double x = fr[k] && (pos ? gu[k] : gd[k]) ? share : 0.0;
        const double add = decltype(plain)::value
                               ? clamp_plain(x, -dn_r[k], up_r[k])
                               : clamp_t(x, -dn_r[k], up_r[k]);
        b[k] = b[k] + add;
        sum += add;
        rooms(b[k], l[k], h[k], fr[k], up_r[k], dn_r[k], gu[k], gd[k]);
      }
      for (int j = tid + R * nt, s = tid; j < n; j += nt, s += nt) {
        const LooRow r = loo_row(alpha[j], y[j], C, t, j);
        double& bb = s < room ? spill[s] : out[j];
        double r_up = r.h - bb, r_dn = bb - r.l;
        const bool can = r.free && (pos ? r_up : r_dn) > 1e-15;
        const double add = clamp_t(can ? share : 0.0, -r_dn, r_up);
        bb = bb + add;
        sum += add;
        bool g_up, g_dn;
        rooms(bb, r.l, r.h, r.free, r_up, r_dn, g_up, g_dn);
      }
      avg_reduce<true, MAXT / 32>(sum, up, down, red, par);
      resid = resid - sum;
    }
  };
  if (bigs == 0.0 && fabs(C) <= kAvgBig && fabs(resid) <= kAvgBig)
    spill_rounds(std::true_type{});
  else
    spill_rounds(std::false_type{});
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int j = tid + k * nt;
    if (j < n) {
      out[j] = b[k];
      lo_o[j] = l[k];
      hi_o[j] = h[k];
    }
  }
  for (int j = tid + R * nt, s = tid; j < n && s < room; j += nt, s += nt)
    out[j] = spill[s];
}

// ---------------------------------------------------------------------------
// top_spill, route fused: top_seed_loo's device work from alpha to
// water_fill's input in one block: the prologue (loo_row), the order of the
// rows by similarity, found on chip, and the walk. The order is
// torch.argsort(-sim, stable=True) with sim = K[:, t] (column t, read with
// stride ld) and sim[t] = -inf: ascending order_key(-sim) (-0.0 as +0.0,
// NaN last), ties by the lower index. The walk needs the order only until
// the residual is 0 (on LOO's cases within 9 rows), so it is never sorted
// whole: each warp sorts its own 32 R rows (a bitonic network in registers
// and shuffles) into a list in shared memory, and one warp then takes the
// order 32 rows at a time: the next 32 of every list, merged pairwise to
// the 32 least (min with the other list reversed, then a bitonic clean, in
// shuffles), their rooms formed in parallel, the chain of residuals in
// order (each step the split kernel's arithmetic), and the rows visited
// stored. A row the walk does not reach is never gathered. The block's
// copy of beta (with lo and hi) precedes the walker's stores by the
// barrier between them. `walks` gains the walk's length in a
// histogram: 0, 1, 2-3, 4-7, ..., 64 rows and more, then the rows visited
// and the longest walk.
// ---------------------------------------------------------------------------
typedef unsigned long long Key;
constexpr Key kNoKey = ~0ull;        // padding, index INT_MAX: after every row
constexpr int kTopMaxRows = 16384;   // 16 rows a thread at 1,024 threads
constexpr int kWalkBins = 8;

__device__ __forceinline__ bool key_less(Key ka, int ia, Key kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// The entry (k, i) of a compare-exchange pair keeps its partner's (ok, oi)
// where the pair's order wants it: the lower entry of the pair keeps the
// lesser where `up`, the greater where not.
__device__ __forceinline__ void keep(Key& k, int& i, Key ok, int oi,
                                     bool lower, bool up) {
  if (lower == up ? key_less(ok, oi, k, i) : key_less(k, i, ok, oi)) {
    k = ok;
    i = oi;
  }
}

// One stage of a bitonic network over a warp's 32 R entries (entry e =
// lane R + r in (k[r], i[r])): e pairs with e ^ stride, and the pair
// ascends where e has bit `size` clear. Across lanes by shuffles, within a
// lane in registers (size, stride and r are constants once the caller's
// loops unroll).
template <int R>
__device__ __forceinline__ void bitonic_stage(Key (&k)[R], int (&i)[R],
                                              int lane, int size,
                                              int stride) {
  if (stride >= R) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = lane * R + r;
      const Key ok = __shfl_xor_sync(kFull, k[r], stride / R);
      const int oi = __shfl_xor_sync(kFull, i[r], stride / R);
      keep(k[r], i[r], ok, oi, (e & stride) == 0, (e & size) == 0);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r & stride) continue;
      const int e = lane * R + r;
      if (key_less(k[r + stride], i[r + stride], k[r], i[r]) ==
          ((e & size) == 0)) {
        const Key tk = k[r];
        const int ti = i[r];
        k[r] = k[r + stride];
        i[r] = i[r + stride];
        k[r + stride] = tk;
        i[r + stride] = ti;
      }
    }
  }
}

// The warp's 32 R entries sorted ascending.
template <int R>
__device__ __forceinline__ void warp_sort(Key (&k)[R], int (&i)[R],
                                          int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      bitonic_stage<R>(k, i, lane, size, stride);
}

// (k, i) over the lanes and (bk, bi) over the lanes, both ascending: (k, i)
// becomes the 32 least of the two, ascending. min(a, b reversed) holds them
// as a bitonic sequence; a bitonic clean sorts it.
__device__ __forceinline__ void merge32(Key& k, int& i, Key bk, int bi,
                                        int lane) {
  const Key rk = __shfl_sync(kFull, bk, 31 - lane);
  const int ri = __shfl_sync(kFull, bi, 31 - lane);
  if (key_less(rk, ri, k, i)) {
    k = rk;
    i = ri;
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const Key ok = __shfl_xor_sync(kFull, k, s);
    const int oi = __shfl_xor_sync(kFull, i, s);
    keep(k, i, ok, oi, (lane & s) == 0, true);
  }
}

template <int NW, int R>
__global__ void __launch_bounds__(NW * 32)
top_spill_fused_kernel(const double* __restrict__ K, long long ld,
                       const double* __restrict__ y,
                       const double* __restrict__ alpha, double C, int t,
                       double* __restrict__ out, double* __restrict__ lo_o,
                       double* __restrict__ hi_o, int n,
                       unsigned long long* __restrict__ walks) {
  constexpr int NT = NW * 32, L = 32 * R, M = NW * L;
  extern __shared__ Key lists_k[];   // list w: [w L, (w + 1) L); then indices
  int* lists_i = reinterpret_cast<int*>(lists_k + M);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  Key k[R];
  int ix[R];
  double sim[R], av[R], yv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {   // column t and the rows: every load in
    const int j = tid + r * NT;    // flight at once
    sim[r] = j < n && j != t ? K[(long long)j * ld + t] : 0.0;
    av[r] = j < n ? alpha[j] : 0.0;
    yv[r] = j < n ? y[j] : 0.0;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = tid + r * NT;
    const LooRow row = loo_row(av[r], yv[r], C, t, j);
    if (j < n) {
      out[j] = row.b;
      lo_o[j] = row.l;
      hi_o[j] = row.h;
    }
    k[r] = j < n ? order_key(-(j == t ? -CUDART_INF : sim[r])) : kNoKey;
    ix[r] = j < n ? j : INT_MAX;
  }
  warp_sort<R>(k, ix, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lists_k[w * L + lane * R + r] = k[r];
    lists_i[w * L + lane * R + r] = ix[r];
  }
  __syncthreads();
  if (w != 0) return;
  double resid = y[t] * alpha[t];
  const int steps = n - 1;
  int walked = 0, head = 0;   // lane q < NW: list q's entries walked
  while (walked < steps && resid != 0.0) {
    Key ck[NW];
    int ci[NW];
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      const int p = __shfl_sync(kFull, head, q) + lane;
      ck[q] = p < L ? lists_k[q * L + p] : kNoKey;
      ci[q] = p < L ? lists_i[q * L + p] : INT_MAX;
    }
#pragma unroll
    for (int m = NW / 2; m > 0; m >>= 1)
#pragma unroll
      for (int q = 0; q < m; ++q)
        merge32(ck[q], ci[q], ck[q + m], ci[q + m], lane);
    const int j = ci[0];
    double bj = 0.0, up = 0.0, down = 0.0;
    if (walked + lane < steps) {
      const LooRow row = loo_row(alpha[j], y[j], C, t, j);
      bj = row.b;
      up = row.h - bj;
      down = row.l - bj;
    }
    double mine = 0.0;
    int q = 0;
    for (; q < 32 && walked + q < steps && resid != 0.0; ++q) {
      const double ru = __shfl_sync(kFull, up, q);
      const double rd = __shfl_sync(kFull, down, q);
      const double room = resid >= 0.0 ? ru : rd;
      const double take =
          nan_min(nan_max(resid, nan_min(room, 0.0)), nan_max(room, 0.0));
      if (lane == q) mine = take;
      resid = resid - take;
    }
    if (lane < q) out[j] = bj + mine;
    walked += q;
    if (q < 32) break;
    const int own = (j % NT) >> 5;   // each list on by its rows among the 32
#pragma unroll
    for (int p = 0; p < NW; ++p) {
      const unsigned mask = __ballot_sync(kFull, own == p);
      if (lane == p) head += __popc(mask);
    }
  }
  if (lane == 0) {
    const int bin = walked == 0 ? 0 : min(32 - __clz(walked), kWalkBins - 1);
    atomicAdd(walks + bin, 1ull);
    atomicAdd(walks + kWalkBins, (unsigned long long)walked);
    atomicMax(walks + kWalkBins + 1, (unsigned long long)walked);
  }
}

int threads_for(long long n, int per_thread) {
  long long t = (n + per_thread - 1) / per_thread;
  t = (t + 31) / 32 * 32;
  return (int)(t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t));
}

}  // namespace

// the most dynamic shared memory a block may take on sm_90
static constexpr int kMaxDynSmem = 227 * 1024;

namespace {

// The most shared memory a block of `kernel` may take beside its static
// share, set as its dynamic limit once (the card's opt-in maximum).
template <typename F>
int dyn_smem_limit(F kernel, bool& done, int& limit) {
  if (!done) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaFuncAttributes fa;
    cudaFuncGetAttributes(&fa, kernel);
    limit = optin - (int)fa.sharedSizeBytes;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         limit);
    done = true;
  }
  return limit;
}

template <int LV, int MAXT>
int launch_water_fill(const double* beta, const double* lo, const double* hi,
                      const double* target, double target_v, double* out,
                      int n, int iters, int threads, cudaStream_t stream) {
  static bool done = false;
  static int limit = 0;
  const int room = dyn_smem_limit(water_fill_kernel<LV, MAXT>, done, limit);
  const long long want = 24LL * n;   // every row, either staging
  const int dyn = want < room ? (int)want : room;
  water_fill_kernel<LV, MAXT><<<1, threads, (size_t)dyn, stream>>>(
      beta, lo, hi, target, target_v, out, n, iters, dyn);
  return (int)cudaGetLastError();
}

// water_fill's levels a round: 2, the fastest at 800 rows on the H100
// (chip_smoke.py's sweep of 1-5): a round's FP64 work grows as 2^LV - 1
// while its barriers and butterflies fall as 1 / LV
constexpr int kWaterFillLevels = 2;

}  // namespace

extern "C" int water_fill_f64(const double* beta, const double* lo,
                              const double* hi, const double* target,
                              double target_v, double* out, int n, int iters,
                              int levels, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = threads_for(n, 8);
  const int lv = WATER_FILL_LEVELS > 0
                     ? WATER_FILL_LEVELS
                     : (levels > 0 ? levels : kWaterFillLevels);
  const bool small = threads <= 256;
#define WF(LV, T)                                                          \
  return launch_water_fill<LV, T>(beta, lo, hi, target, target_v, out, n, \
                                  iters, threads, stream)
  switch (lv) {
    case 1: WF(1, kMaxThreads);
    case 2: WF(2, kMaxThreads);
    case 3: WF(3, kMaxThreads);
    case 4: if (small) WF(4, 256); WF(4, kMaxThreads);
    case 5: if (small) WF(5, 256); WF(5, kMaxThreads);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WF
}

namespace {

template <int L>
int launch_sir(const double* K, long long ld, const long long* R_idx,
               const long long* T_idx, const double* y_R, const double* y_T,
               const double* alpha_R, const double* priority, double* beta_T,
               int m, int t, int skip, int seg, int* lists, int* head,
               int* picks, int* order, unsigned* used, int* state,
               long long* stats, cudaStream_t stream) {
  static bool done = false;
  static int limit = 0;
  const int room = dyn_smem_limit(sir_walk_kernel<L>, done, limit);
  const long long words = ((long long)t + 31) / 32;
  if (4 * words > room) return (int)cudaErrorInvalidValue;
  if (!skip && m > 0)
    sir_order_kernel<<<(t + 31) / 32, kOrderWarps * 32, 0, stream>>>(
        priority, t, order);
  const int order_in_smem = !skip && 4 * (words + t) <= room;
  const long long base = words + (order_in_smem ? t : 0);
  const int cols_in_smem = 4 * (base + t + 2 * words) <= room;
  const size_t smem = 4 * (size_t)(base + (cols_in_smem ? t + 2 * words : 0));
  const int w = seg > 0 ? seg : (m > 0 ? m : 1);
  for (int r0 = 0; r0 == 0 || r0 < m; r0 += w) {
    const int r1 = r0 + w < m ? r0 + w : m;
    if (r1 > r0)
      sir_lists_kernel<L><<<(r1 - r0 + kListWarps - 1) / kListWarps,
                            kListWarps * 32, 0, stream>>>(
          K, ld, R_idx, T_idx, y_R, y_T, r0, r1, t,
          r0 == 0 ? nullptr : used, lists, reinterpret_cast<int2*>(head));
    sir_walk_kernel<L><<<1, kMaxThreads, smem, stream>>>(
        K, ld, R_idx, T_idx, y_R, y_T, alpha_R, beta_T, r0, r1, t, lists,
        reinterpret_cast<const int2*>(head), picks,
        skip ? nullptr : order, order_in_smem, cols_in_smem, used,
        reinterpret_cast<SirState*>(state), stats);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// SIR's greedy pass over K read through R_idx (m) and T_idx (t) (both null:
// K is the (m, t) block, row stride ld), in segments of `seg` removed rows
// (0: one). Scratch from the caller: lists (m L ints), head (2 m), picks
// (m), order (t; unused by skip), used ((t + 31) / 32), state (3); stats
// (2 int64, or null) gains the rescanned and the fallback rows. L is 8,
// 16, 32 or 64; |T| up to the used bits that shared memory holds (~1.8
// million).
extern "C" int sir_greedy_f64(const double* K, long long ld,
                              const long long* R_idx, const long long* T_idx,
                              const double* y_R, const double* y_T,
                              const double* alpha_R, const double* priority,
                              double* beta_T, int m, int t, int skip,
                              int list_len, int seg, int* lists, int* head,
                              int* picks, int* order, int* used, int* state,
                              long long* stats, cudaStream_t stream) {
  if (t <= 0) return 0;
  if (m < 0 || seg < 0 || (R_idx == nullptr) != (T_idx == nullptr))
    return (int)cudaErrorInvalidValue;
  unsigned* u = reinterpret_cast<unsigned*>(used);
#define SG(L)                                                              \
  return launch_sir<L>(K, ld, R_idx, T_idx, y_R, y_T, alpha_R, priority, \
                       beta_T, m, t, skip, seg, lists, head, picks, order, \
                       u, state, stats, stream)
  switch (list_len) {
    case 8: SG(8);
    case 16: SG(16);
    case 32: SG(32);
    case 64: SG(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SG
}

// sir_greedy's first phase alone (checks): each removed row's top-L list
// (m L ints, INT_MAX past its candidates) and head (2 m ints).
extern "C" int sir_lists_f64(const double* K, long long ld,
                             const long long* R_idx, const long long* T_idx,
                             const double* y_R, const double* y_T, int m,
                             int t, int list_len, int* lists, int* head,
                             cudaStream_t stream) {
  if (m <= 0) return 0;
  if ((R_idx == nullptr) != (T_idx == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (m + kListWarps - 1) / kListWarps;
  int2* h = reinterpret_cast<int2*>(head);
#define SL(L)                                                               \
  sir_lists_kernel<L><<<blocks, kListWarps * 32, 0, stream>>>(              \
      K, ld, R_idx, T_idx, y_R, y_T, 0, m, t, nullptr, lists, h);           \
  break
  switch (list_len) {
    case 8: SL(8);
    case 16: SL(16);
    case 32: SL(32);
    case 64: SL(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SL
  return (int)cudaGetLastError();
}

// the most working-set rows ato_system's shared memory holds (yM + idx)
extern "C" int ato_system_max_m_cap() {
  return (kMaxDynSmem - 4096) / 12;
}

// ato_system (route compact) over `lanes` lanes: alpha, f, T_act, R_act
// (lanes, n), Cs and b_fallback (lanes,); every output has a leading lane
// axis.
extern "C" int ato_system_lanes_f64(
    const double* K, int n, const double* y, const double* alpha,
    const double* f, const double* b_fallback, const bool* in_S,
    const bool* in_T, const bool* T_act, const bool* R_act, const double* Cs,
    int lanes, int m_cap, bool* train_now, bool* free_m, long long* nf,
    double* b, double* v, double* w, long long* idx, bool* lane, double* yM,
    double* lam, double* B, double* rhs, cudaStream_t stream) {
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
      train_now, free_m, nf, b, v, w, idx, lane, yM, lam, B, rhs);
  return (int)cudaGetLastError();
}

// ato_system (route carried) over `lanes` lanes: B (lanes, m_cap + 1,
// m_cap + 1) from idx and yM (lanes, m_cap), nf and lam (lanes,).
extern "C" int ato_system_carried_f64(const double* K, int n, int lanes,
                                      int m_cap, const long long* idx,
                                      const double* yM, const long long* nf,
                                      const double* lam, double* B,
                                      cudaStream_t stream) {
  if (n <= 0 || m_cap <= 0 || lanes <= 0) return 0;
  if (lanes > 65535) return (int)cudaErrorInvalidValue;
  const long long M1 = (long long)m_cap + 1;
  const int segs = (int)((M1 + 64 * kBUnroll - 1) / (64 * kBUnroll));
  const long long blocks = (M1 * segs + kBWarps - 1) / kBWarps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  ato_b_kernel<<<dim3((unsigned)blocks, lanes), kBWarps * 32, 0, stream>>>(
      K, n, m_cap, segs, idx, yM, nf, lam, B);
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

namespace {

template <int R>
int launch_apply_fused(int lanes, size_t smem, cudaStream_t stream,
                       const double* K, int n, const double* g, double* f,
                       double* alpha, const double* Phi, const double* y,
                       const bool* in_S, const bool* in_T, bool* T_act,
                       bool* R_act, bool* done, long long* step, double* eta,
                       const double* Cs, const double* b_fallback, double tol,
                       long long max_steps, int m_cap, bool* train_now,
                       bool* free_m, long long* nf, double* b, double* v,
                       double* w, long long* idx, bool* lane, double* yM,
                       double* lam, double* rhs) {
  static bool done_attr = false;
  static int limit = 0;
  if ((long long)smem > dyn_smem_limit(ato_apply_fused_kernel<R>,
                                       done_attr, limit))
    return (int)cudaErrorInvalidValue;
  ato_apply_fused_kernel<R><<<lanes, kApplyThreads, smem, stream>>>(
      K, n, g, f, alpha, Phi, y, in_S, in_T, T_act, R_act, done, step, eta,
      Cs, b_fallback, tol, max_steps, m_cap, train_now, free_m, nf, b, v, w,
      idx, lane, yM, lam, rhs);
  return (int)cudaGetLastError();
}

}  // namespace

// ato_apply (route fused) over `lanes` lanes, a block each: the split
// route's arrays, alpha updated too, and the working set (train_now, free,
// v, b read and rewritten; nf, w, idx, lane, yM, lam and rhs[0] written)
// for the next step; K (its diagonal), in_S and in_T (n,) and b_fallback
// (lanes,) beside them. 256 threads a lane; rows in registers up to 1,024
// (4 a thread).
extern "C" int ato_apply_fused_f64(
    const double* K, int n, const double* g, double* f, double* alpha,
    const double* Phi, const double* y, const bool* in_S, const bool* in_T,
    bool* T_act, bool* R_act, bool* done, long long* step, double* eta,
    const double* Cs, const double* b_fallback, int lanes, double tol,
    long long max_steps, int m_cap, bool* train_now, bool* free_m,
    long long* nf, double* b, double* v, double* w, long long* idx,
    bool* lane, double* yM, double* lam, double* rhs, cudaStream_t stream) {
  if (n <= 0 || lanes <= 0 || m_cap <= 0) return 0;
  const int per = (n + kApplyThreads - 1) / kApplyThreads;
  const int R = per <= 1 ? 1 : per <= 2 ? 2 : per <= 4 ? 4 : 0;
  const size_t smem =
      sizeof(int) * (size_t)(R > 0 ? R : per) * (kApplyThreads / 32);
#define AF(RR)                                                               \
  return launch_apply_fused<RR>(                                             \
      lanes, smem, stream, K, n, g, f, alpha, Phi, y, in_S, in_T, T_act,     \
      R_act, done, step, eta, Cs, b_fallback, tol, max_steps, m_cap,         \
      train_now, free_m, nf, b, v, w, idx, lane, yM, lam, rhs)
  switch (R) {
    case 1: AF(1);
    case 2: AF(2);
    case 4: AF(4);
    default: AF(0);
  }
#undef AF
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

namespace {

// MAXT: the block's most threads (256: every row in registers without a
// spill up to n = 1,024)
template <int MAXT>
int launch_avg_fused(const double* y, const double* alpha, double C, int t,
                     double* out, double* lo, double* hi, int n, int threads,
                     cudaStream_t stream) {
  static bool done = false;
  static int limit = 0;
  const int room =
      dyn_smem_limit(avg_spill_fused_kernel<MAXT>, done, limit) / 8;
  const long long extra = (long long)n - (long long)kAvgRows * threads;
  const int rows = extra <= 0 ? 0 : (extra < room ? (int)extra : room);
  avg_spill_fused_kernel<MAXT><<<1, threads, 8 * (size_t)rows, stream>>>(
      y, alpha, C, t, out, lo, hi, n, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// avg_spill (route fused): avg_seed_loo from y, alpha (n,), C and t to the
// spilled beta, lo and hi (n,).
extern "C" int avg_spill_fused_f64(const double* y, const double* alpha,
                                   double C, int t, double* out, double* lo,
                                   double* hi, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (t < 0 || t >= n) return (int)cudaErrorInvalidValue;
  const int threads = threads_for(n, 4);
  return threads <= 256
             ? launch_avg_fused<256>(y, alpha, C, t, out, lo, hi, n, threads,
                                     stream)
             : launch_avg_fused<kMaxThreads>(y, alpha, C, t, out, lo, hi, n,
                                             threads, stream);
}

namespace {

template <int NW, int R>
int launch_top_fused(const double* K, long long ld, const double* y,
                     const double* alpha, double C, int t, double* out,
                     double* lo, double* hi, int n,
                     unsigned long long* walks, cudaStream_t stream) {
  static bool done = false;
  static int limit = 0;
  const size_t smem = (size_t)12 * NW * 32 * R;   // the lists
  if ((long long)smem >
      dyn_smem_limit(top_spill_fused_kernel<NW, R>, done, limit))
    return (int)cudaErrorInvalidValue;
  top_spill_fused_kernel<NW, R><<<1, NW * 32, smem, stream>>>(
      K, ld, y, alpha, C, t, out, lo, hi, n, walks);
  return (int)cudaGetLastError();
}

}  // namespace

// top_spill (route fused): top_seed_loo from K (column t, row stride ld),
// y, alpha (n,), C and t to the spilled beta, lo and hi (n,), n up to
// kTopMaxRows (TOP_FUSED_MAX_ROWS in kernels/seeding.py); `walks` (10 int64)
// gains the walk.
// 256 threads up to 1,024 rows (R a thread), then 1,024.
extern "C" int top_spill_fused_f64(const double* K, long long ld,
                                   const double* y, const double* alpha,
                                   double C, int t, double* out, double* lo,
                                   double* hi, int n, long long* walks,
                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  if (t < 0 || t >= n || n > kTopMaxRows) return (int)cudaErrorInvalidValue;
  unsigned long long* wk = reinterpret_cast<unsigned long long*>(walks);
#define TF(NW, R)                                                        \
  return launch_top_fused<NW, R>(K, ld, y, alpha, C, t, out, lo, hi, n, \
                                 wk, stream)
  if (n <= 256) TF(8, 1);
  if (n <= 512) TF(8, 2);
  if (n <= 1024) TF(8, 4);
  if (n <= 2048) TF(32, 2);
  if (n <= 4096) TF(32, 4);
  if (n <= 8192) TF(32, 8);
  TF(32, 16);
#undef TF
}
