// Device helpers shared by the SMO kernels (smo_update.cu, smo_chunk.cu,
// smo_step.cu) and the RBF kernel matrix (rbf.cu).
//
// Every SMO source is compiled with -fmad=false (kernels/_build.py), so
// nvcc contracts nothing on its own: the one fused multiply-add below is
// the rounding the JAX reference gets from XLA-CPU for
// f + delta * (K_i - K_j), and every other expression rounds op by op, as
// the plain PyTorch versions do.
#pragma once

#include <cuda_runtime.h>

#include <climits>

// One fused multiply-add a * b + c in the type's own precision.
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

// The SMO rank-2 indicator update of one element: f + delta * (K_i - K_j),
// with one rounding of the product-sum. Reused as the chunk kernels' tail.
template <typename T>
__device__ __forceinline__ T smo_f_update_elem(T f, T ki, T kj, T delta) {
  return fma_t(delta, ki - kj, f);
}

// NaN-propagating min / max: jnp.minimum / maximum / clip and torch's
// minimum / clamp return NaN when an operand is NaN; CUDA's fmin / fmax drop it.
__device__ __forceinline__ double nan_min(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : (b < a ? b : a);
}

__device__ __forceinline__ double nan_max(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : (b > a ? b : a);
}

// ---------------------------------------------------------------------------
// The WSS selection's block-wide (value, index) reductions. Each min or max
// lets NaN win and the lowest index win a tie, which is exact in any
// reduction order: a lane's choice does not depend on the block's width.
// ---------------------------------------------------------------------------

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
__device__ __forceinline__ void block_reduce(Scratch& s, double v0, int i0,
                                             double v1, int i1, int flags,
                                             bool need_min) {
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

// Order keys. A (value, row) candidate reduces across lanes by an unsigned
// 64-bit key of its value whose integer order is the value's order, -0
// and +0 one key, NaN the smallest key (NaN first); a max reduces by the
// key's complement. Equal keys fall to the lowest row. That is the order of
// better_min / better_max exactly, so the winner is theirs; and two
// warp-wide integer reductions (__reduce_min_sync) and a ballot find it,
// where a shuffle tree takes five levels of float64 compares.
__device__ __forceinline__ unsigned long long order_bits(double v) {
  unsigned long long b = (unsigned long long)__double_as_longlong(v);
  if ((b << 1) == 0) b = 0;  // -0 -> +0
  return (b >> 63) ? ~b : b | 0x8000000000000000ull;
}

__device__ __forceinline__ unsigned long long min_key(double v) {
  return isnan(v) ? 0ull : order_bits(v);
}

__device__ __forceinline__ unsigned long long max_key(double v) {
  return isnan(v) ? 0ull : ~order_bits(v);
}

// The warp's least key, to every lane, and the lane that holds it at the
// lowest row (rows are distinct); `row` is the lane's candidate's row.
__device__ __forceinline__ int warp_least_row(unsigned long long& key,
                                              int row) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned mh = __reduce_min_sync(0xffffffffu, hi);
  const unsigned ml = __reduce_min_sync(0xffffffffu, hi == mh ? lo : ~0u);
  const bool has = hi == mh && lo == ml;
  const unsigned mr =
      __reduce_min_sync(0xffffffffu, has ? (unsigned)row : ~0u);
  const unsigned at = __ballot_sync(0xffffffffu, has && (unsigned)row == mr);
  key = ((unsigned long long)mh << 32) | ml;
  return __ffs(at) - 1;
}

// ---------------------------------------------------------------------------
// A barrier across the blocks of a cooperative launch (smo_chunk.cu's
// multi-block route, smo_step.cu's persistent streaming chunk).
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// Every block of a group (a lane's blocks, or the whole grid) arrives at
// the group's monotonic counter, then waits until it reaches `target` (the
// group's blocks times the barriers so far). Thread 0's arrival is a
// release after the block's barrier (what the block wrote is visible
// first) and its polls are acquires (what the others wrote is visible
// after). A wait of more than two minutes can only be a fault, and traps:
// an error, not a hang, but a sticky one that ends the process's CUDA
// context, so the guard is kept far above any slow but sound wait (a
// preempted block, a debugger).
__device__ __forceinline__ void lane_barrier(unsigned long long* ctr,
                                             unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    // release: this block's picks are visible before its arrival counts
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;\n" ::"l"(ctr)
                 : "memory");
    unsigned long long t0 = 0;
    // acquire: the other blocks' picks are visible once all have arrived
    while (ld_acquire(ctr) < target) {
      if (t0 == 0)
        t0 = now_ns();
      else if (now_ns() - t0 > 120000000000ull)
        __trap();
    }
  }
  __syncthreads();
}

// I_up / I_low membership of one instance (paper Eq. 4).
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

// Pass 1 of every SMO step: the sets, b_up and its argmin i over I_up, b_low
// and its argmax over I_low (the WSS-1 j), and whether both sets are
// non-empty. Every thread of the block returns the same (i, j, gap).
__device__ __forceinline__ double select_pass1(Scratch& s, const double* alpha,
                                               const double* f,
                                               const double* y,
                                               const unsigned char* mask,
                                               double C, int n, int& i,
                                               int& j) {
  double vu = INFINITY, vl = -INFINITY;
  int iu = INT_MAX, il = INT_MAX, fl = 0;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    bool up, low;
    sets(alpha[k], y[k], mask[k] != 0, C, up, low);
    const double fk = f[k];
    const double cu = up ? fk : INFINITY, cl = low ? fk : -INFINITY;
    if (better_min(cu, k, vu, iu)) { vu = cu; iu = k; }
    if (better_max(cl, k, vl, il)) { vl = cl; il = k; }
    fl |= (up ? 1 : 0) | (low ? 2 : 0);
  }
  block_reduce(s, vu, iu, vl, il, fl, true);
  i = s.r_i0;
  j = s.r_i1;
  return s.r_flags == 3 ? s.r_v1 - s.r_v0 : -INFINITY;
}

// The clipped two-variable step from the pair's scalars, alpha_i and alpha_j
// written in the reference's order (j == i sees the new alpha_i). Returns
// delta. Run by one thread.
// The same step from the pair's scalars alone: the new alpha_i and alpha_j
// (alpha_j after alpha_i, so j == i sees the new alpha_i) and delta.
__device__ __forceinline__ double pair_step(double f_i, double f_j,
                                            double a_i, double a_j,
                                            double y_i, double y_j, bool same,
                                            double eta_ij, double C,
                                            double& new_i, double& new_j) {
  double delta = (f_j - f_i) / eta_ij;
  const double hi_i = y_i > 0.0 ? C - a_i : a_i;
  const double hi_j = y_j > 0.0 ? a_j : C - a_j;
  delta = nan_max(nan_min(nan_min(delta, hi_i), hi_j), 0.0);
  new_i = a_i + y_i * delta;
  new_j = (same ? new_i : a_j) + (-y_j) * delta;
  return delta;
}

__device__ __forceinline__ double pair_update(double* alpha, const double* f,
                                              const double* y, int i, int j,
                                              double eta_ij, double C) {
  double new_i, new_j;
  const double delta = pair_step(f[i], f[j], alpha[i], alpha[j], y[i], y[j],
                                 i == j, eta_ij, C, new_i, new_j);
  alpha[i] = new_i;
  alpha[j] = new_j;
  return delta;
}

// ---------------------------------------------------------------------------
// Asynchronous copies into shared memory, and the FP64 tensor cores' product
// (smo_step.cu's and rbf.cu's staged slabs). The m16n8k4 product rounds
// each output like a chain of fmas in order of k on every input tried; the
// witness builds (smo_step_fma, and rbf.cu's FMA kernel) hold a card to it.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// c0 += a . b for rows g and c1 for rows g + 8 of a 16 x 8 tile, one k-step
// of 4 on the FP64 tensor cores (A 16 x 4 row-major, B 4 x 8 column-major;
// a0 = A[g][t], a1 = A[g + 8][t], b = B[t][g], c = C[row][2 t .. 2 t + 1];
// g = lane / 4, t = lane % 4).
__device__ __forceinline__ void dmma16(double (&c0)[2], double (&c1)[2],
                                       double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c0[0]), "+d"(c0[1]), "+d"(c1[0]), "+d"(c1[1])
      : "d"(a0), "d"(a1), "d"(b));
}
