// The matrix-free persistent streaming chunk, redesigned for Hopper: route
// "cluster" of kernels/smo_chunk.py::smo_stream_chunk.
//
// It runs what smo_step.cu's smo_stream_kernel (route "persistent", kept
// there as the bitwise witness) runs: up to 16 lanes of WSS-1 SMO over one
// X (n, d) float64, all n_iters iterations in ONE launch, each iteration
// the reference's streaming step (src/repro/svm/engine.py::_step, WSS-1,
// whose kernel rows the Pallas kernel src/repro/kernels/smo_step.py::
// fused_smo_step computes on a TPU), stopping on the device when every
// lane is done. Each block owns a slice of at most one tile of rows for the
// whole launch. Same arithmetic, same order, so alpha, f, n_iter and done
// are bitwise the persistent and the pair routes':
//   * every dot product X[r] . x_p is one chain of fmas in order of k, on
//     the FP64 tensor cores (mma.m16n8k4, four features a step) or, built
//     with -DSMO_STEP_TENSOR_F64=0, on the FMA pipes;
//   * the same rbf_from_dot, pair_step, clip and sets, and K[i, j]'s cross
//     product summed by one thread in order of k;
//   * the pick is the NaN-first, lowest-row rule, exact in any reduction
//     order, so the cluster level below changes no pick.
//
// Bound: the products, 4 b n d FP64 operations an iteration (2.39 us at n
// = 32,560, d = 123, ten lanes on an H100's 67 TFLOP/s); the bytes a chunk
// must move (X once, the lanes' state in and out) are far below that an
// iteration. What holds the loop back is a chain of latencies an iteration
// (PERF.md §6, chip_stream_phases.py), which this design cuts:
//   * the exchange goes through thread-block clusters of C blocks (2..8,
//     the portable sizes): each block reduces its lanes' candidates into
//     its shared memory, one cluster barrier, and the cluster's first block
//     reduces the C blocks' candidates through distributed shared memory
//     and publishes ONE record a lane a cluster (a 16-byte key and a
//     32-byte row), then arrives at the grid's counter (one arrival a
//     cluster). After the grid barrier block rank r of each cluster takes
//     the lanes l = r (mod C), a warp a lane: m / C keys in one round of
//     loads, the winners' rows, and the picks into every block of the
//     cluster, one cluster barrier;
//   * the pair rows are fetched once a cluster: block rank r loads the
//     rows w = r (mod C) of the live lanes' 2 G and stores them into every
//     block of the cluster (distributed shared memory), one cluster barrier;
//   * X stays in shared memory as far as it fits: each thread keeps its
//     cells' f and alpha (the cells its mma fragments own in the f-update)
//     in registers, which frees the lane state's shared memory, so R of the
//     slice's ceil(d / 4) k-steps are loaded once a launch and the others
//     stream by TMA through a ring of S slabs of sixteen features: the
//     first slabs are prefetched during the previous iteration's tail, the
//     rest land while the resident k-steps are multiplied; the warp that
//     finishes a stage last issues its next slab, so no warp waits to copy
//     (layout(); PERF.md §6 says how much stays);
//   * a slab's (or four resident k-steps') products are unrolled, so that
//     their loads, products and K[i, j] chain steps overlap (a product's
//     result is ready ~150 cycles after it starts; a k-step at a time, the
//     loop's other work ran between them one after another);
//   * eight warps only: the cross products' chains run in the compute
//     warps (slot s in warp s % 8), and the k-step loop waits on no block
//     barrier;
//   * the candidates of the next iteration come out of the f-update cell
//     by cell, reduced a lane block at a time; a lane's pick (the live
//     lanes' slots) is one warp's ballot.
// A lane that stops (or the chunk's end) writes its cells back to f and
// alpha in device memory; when a lane stops, the others' cells are written
// back and read again at their new slots (at most once a lane a launch).
//
// Residency: every block of the grid must run at once (a spin barrier). The
// launch carries the cluster dimension and the cooperative attribute
// together (the H100 takes both in one cudaLaunchKernelExC), and
// kernels/smo_chunk.py::stream_cluster_plan places only as many clusters
// as cudaOccupancyMaxActiveClusters says the card holds at once. A wait of
// more than two minutes at the barrier can only be a fault, and traps
// (lane_barrier's guard in smo_common.cuh, kept here).
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; no libcuda link
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"   // the tensor-map encoder
#include "smo_common.cuh"

namespace cg = cooperative_groups;

namespace {

// Eight warps, two to each of the SM's four schedulers: a ninth warp
// would cut every thread's registers from 255 to 168 (a scheduler's 16K
// registers over three warps), and the cells, the products and the
// candidates then spill.
constexpr int kWarps = 8;              // warps over the tile's rows
constexpr int kThreads = kWarps * 32;  // a block
constexpr int kLanes = 16;                   // lanes a launch at most
constexpr int kSlab = 16;                    // a pair row's rounding
constexpr int kMaxCluster = 8;               // the portable cluster sizes
#ifndef SMO_STEP_TENSOR_F64
#define SMO_STEP_TENSOR_F64 1
#endif
constexpr bool kTensorF64 = SMO_STEP_TENSOR_F64 != 0;

// A tile of RB row blocks of 8 a warp, and one k-step of it (four features
// of every row) in the mma fragments' order: row w 8 RB + 8 rb + g's
// features 4 ks + t at (w RB + rb) 32 + 4 g + t, so a warp's fragment load
// is 32 consecutive doubles (no bank conflict, no pad).
template <int RB>
__host__ __device__ constexpr int tile_rows() {
  return kWarps * 8 * RB;
}
template <int RB>
__host__ __device__ constexpr int kstep_doubles() {
  return tile_rows<RB>() * 4;
}

// A staged pair row's stride (as smo_step.cu's): d rounded up to whole
// slabs (zeros past d), plus 4 doubles (a B fragment's rows on distinct
// banks).
__host__ __device__ inline int pair_stride(int d) {
  return (d + kSlab - 1) / kSlab * kSlab + 4;
}

__host__ __device__ inline int ceil4(int b) { return (b + 3) / 4 * 4; }

// K[r, p] from the dot product c = X[r] . p and the norms (smo_step.cu's).
__device__ __forceinline__ double rbf_from_dot(double xr2, double sn,
                                               double c, double neg_gamma) {
  double d2 = xr2 + sn - 2.0 * c;
  d2 = d2 < 0.0 ? 0.0 : d2;  // max(d2, 0), NaN kept
  return exp(neg_gamma * d2);
}

// A candidate for one lane's b_up (argmin) or b_low (argmax): its value
// (f at the row), row (INT_MAX: none), the OR of the set flags under it,
// and what the scalar step needs of its row (alpha, y, |x|^2 from the
// table sn, and xn). In device memory a cluster's record is two parts:
// its key (value, row, flags: 16 bytes, which every reader loads) and its
// row's fields (32 bytes, which only the winner's reader loads).
struct __align__(16) Rec {
  double v;
  int i, flags;
  double a, y, sn, xn;
};

__device__ __forceinline__ Rec load_rec(const Rec* p) {
  const double2* q = reinterpret_cast<const double2*>(p);
  const double2 u = q[0], v = q[1], w = q[2];
  Rec r;
  r.v = u.x;
  r.i = __double2loint(u.y);
  r.flags = __double2hiint(u.y);
  r.a = v.x;
  r.y = v.y;
  r.sn = w.x;
  r.xn = w.y;
  return r;
}

__device__ __forceinline__ void store_rec(Rec* p, const Rec& r) {
  double2* q = reinterpret_cast<double2*>(p);
  q[0] = make_double2(r.v, __hiloint2double(r.flags, r.i));
  q[1] = make_double2(r.a, r.y);
  q[2] = make_double2(r.sn, r.xn);
}

// (value, row, alpha) over the lanes of a warp whose lane ids differ in
// the bits lo_mask .. hi_mask (xor), every lane ending with the best: the
// max's rule where `mx`, else the min's (a lane's own choice; every lane
// takes the same shuffles).
__device__ __forceinline__ void xor_best(bool mx, double& v, int& i,
                                         double& a, int lo_mask,
                                         int hi_mask) {
#pragma unroll
  for (int mask = lo_mask; mask <= hi_mask; mask <<= 1) {
    const double ov = __shfl_xor_sync(0xffffffffu, v, mask);
    const int oi = __shfl_xor_sync(0xffffffffu, i, mask);
    const double oa = __shfl_xor_sync(0xffffffffu, a, mask);
    if (mx ? better_max(ov, oi, v, i) : better_min(ov, oi, v, i)) {
      v = ov;
      i = oi;
      a = oa;
    }
  }
}

__device__ __forceinline__ int xor_or(int x, int lo_mask, int hi_mask) {
#pragma unroll
  for (int mask = lo_mask; mask <= hi_mask; mask <<= 1)
    x |= __shfl_xor_sync(0xffffffffu, x, mask);
  return x;
}

// The resident k-steps [ks0, ks0 + nk) of the slice's rows [lo, lo + cnt)
// into `dst`, k-step j at dst + j KD in fragment order, once a launch by
// every thread: eight threads copy a row's 128 bytes, 16 a copy (two
// features; X's rows ldx apart on 16-byte boundaries, a zero column past
// an odd d); features past d are zeros (the tensor cores take four at a
// time), rows past the slice are left as they are (their products are read
// by nobody). The caller commits and waits.
template <int RB>
__device__ __forceinline__ void stage_resident(double* dst,
                                               const double* __restrict__ X,
                                               int ldx, int lo, int cnt,
                                               int d, int ks0, int nk) {
  constexpr int TILE = tile_rows<RB>(), KD = kstep_doubles<RB>();
  for (int c = threadIdx.x; c < 2 * TILE * nk; c += kThreads) {
    const int j = c / (2 * TILE), r = (c >> 1) % TILE, h = c & 1;
    const int k = 4 * (ks0 + j) + 2 * h;
    const int w = r / (8 * RB), rb = (r >> 3) % RB, g = r & 7;
    double* o = dst + j * KD + (w * RB + rb) * 32 + g * 4 + 2 * h;
    if (k >= d) {
      o[0] = 0.0;
      o[1] = 0.0;
    } else if (r < cnt) {
      cp_async<16>(o, X + (size_t)(lo + r) * ldx + k);
    }
  }
}

// A streamed slab (sixteen features of TILE rows) lands by TMA as 128-byte
// rows with the 128-byte swizzle: feature f of row r at double r 16 + 2
// ((f / 2) ^ (r % 8)) + f % 2, so that a fragment load (eight rows, four
// features) takes two wavefronts, and the TMA zero-fills the features past
// d and the rows past n.
__device__ __forceinline__ int swz(int r, int f) {
  return r * 16 + ((((f >> 1) ^ (r & 7)) << 1) | (f & 1));
}

__device__ __forceinline__ void tma_slab(double* dst, const CUtensorMap* map,
                                         unsigned long long* bar, int col,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// The ring's barriers (mbarriers in shared memory): a slab's bytes landed.
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of parity `parity` has completed (two minutes:
// a fault, and a trap, as lane_barrier's guard).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  unsigned long long t0 = 0;
  for (;;) {
    unsigned ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (ok) return;
    if (t0 == 0)
      t0 = now_ns();
    else if (now_ns() - t0 > 120000000000ull)
      __trap();
  }
}

// How the dynamic shared memory of a block is cut for d features, b lanes
// and tiles of RB: a ring of S slabs (sixteen features of every row, by
// TMA, 1,024-byte aligned), R resident k-steps of X (four features, in
// fragment order), the pair rows and the rows' y, xn and sn (S = 0: every
// k-step resident). The streamed k-steps are P slabs before the resident
// ones ([0, 4 P): prefetched during the previous iteration's tail) and the
// rest after them ([4 P + R, nks): issued as the first slabs are used,
// landing while the resident ones are multiplied).
struct Layout {
  int nks, R, S;
  size_t pairs, rows;  // doubles
};

constexpr int kRingSlabs = 3;

template <int RB>
__host__ __device__ constexpr size_t slab_bytes() {
  return (size_t)tile_rows<RB>() * 16 * sizeof(double);
}

template <int RB>
bool layout(int d, int b, size_t smem, Layout& L) {
  L.nks = (d + 3) / 4;
  L.pairs = (size_t)2 * ceil4(b) * pair_stride(d);
  L.rows = (size_t)3 * tile_rows<RB>();
  const size_t fixed = (L.pairs + L.rows) * sizeof(double) + 1024;
  const size_t ks = (size_t)kstep_doubles<RB>() * sizeof(double);
  if (smem < fixed + 2 * slab_bytes<RB>()) return false;
  if (fixed + L.nks * ks <= smem) {
    L.R = L.nks;
    L.S = 0;
    return true;
  }
  L.S = (int)min((size_t)kRingSlabs, (smem - fixed) / slab_bytes<RB>());
  L.R = (int)((smem - fixed - L.S * slab_bytes<RB>()) / ks);
  return true;
}

template <int RB, int NVB>
__global__ void __launch_bounds__(kThreads, 1)
smo_stream_cluster_kernel(
    const double* __restrict__ X, const double* __restrict__ xn,
    const double* __restrict__ sn, const double* __restrict__ y,
    const unsigned char* __restrict__ masks, const double* __restrict__ Cs,
    double tol, const long long* __restrict__ it_caps, long long n_iters,
    double neg_gamma, double* alphas, double* fs, long long* n_iter,
    unsigned char* done_flags, int n, int d, int ldx, int b, int slice,
    int R, int S, unsigned long long* counter, int4* keys, double2* rows,
    const __grid_constant__ CUtensorMap xmap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE = tile_rows<RB>(), KD = kstep_doubles<RB>();
  constexpr int SLAB = TILE * 16;  // a ring stage's doubles
  const int pst = pair_stride(d), nks = (d + 3) / 4;
  double* ring = reinterpret_cast<double*>(
      smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024));  // [S][SLAB]
  double* xres = ring + (size_t)S * SLAB;             // [R][KD]
  double* ps = xres + (size_t)R * KD;                 // [2 ceil4(b)][pst]
  double* y_s = ps + (size_t)2 * ceil4(b) * pst;      // [TILE]
  double* xn_s = y_s + TILE;                          // [TILE]
  double* pn_s = xn_s + TILE;                         // [TILE]
  // per lane: C, cap, n_iter, done, and this iteration's pick
  __shared__ double l_C[kLanes], l_fi[kLanes], l_fj[kLanes];
  __shared__ Rec l_ri[kLanes], l_rj[kLanes];
  __shared__ long long l_it[kLanes], l_cap[kLanes];
  __shared__ int l_done[kLanes], l_i[kLanes], l_j[kLanes];
  // per slot (the live lanes in order): lane, pair, C, the step's results
  __shared__ int s_lane[kLanes], s_i[kLanes], s_j[kLanes];
  __shared__ double s_C[kLanes], s_sni[kLanes], s_snj[kLanes],
      s_delta[kLanes], s_newi[kLanes], s_newj[kLanes];
  __shared__ int s_live;
  // each compute warp's candidates per slot ([0] up, [1] low), then the
  // block's per lane and parity, read across the cluster
  __shared__ double w_v[2][kWarps][kLanes], w_a[2][kWarps][kLanes];
  __shared__ int w_i[2][kWarps][kLanes], w_fg[kWarps][kLanes];
  __shared__ Rec c_slot[2][kLanes][2];
  // the ring's stages: landed, and the warps done with each
  __shared__ unsigned long long full_bar[kRingSlabs];
  __shared__ int stage_done[kRingSlabs];

  const cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int ncl = (int)gridDim.x / C, cid = (int)blockIdx.x / C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;  // row and lane in a tile's cell
  const int lo = (int)blockIdx.x * slice;
  const int cnt = max(0, min(n - lo, slice));
  // a compute warp with rows in the slice (uniform over the warp)
  const bool rows_here = warp * 8 * RB < cnt;

  if (tid < b) {
    l_C[tid] = Cs[tid];
    l_cap[tid] = it_caps[tid];
    l_it[tid] = n_iter[tid];
    l_done[tid] = done_flags[tid] != 0;
  }
  for (int k = tid; k < TILE; k += kThreads) {
    const bool in = k < cnt;
    y_s[k] = in ? y[lo + k] : 0.0;
    xn_s[k] = in ? xn[lo + k] : 0.0;
    pn_s[k] = in ? sn[lo + k] : 0.0;
  }
  for (int e = tid; e < 2 * ceil4(b) * pst; e += kThreads) ps[e] = 0.0;

  // X (layout()): the streamed slabs, P before the resident k-steps
  // [4 P, 4 P + R) (which sit at slot ks - 4 P) and the rest after them,
  // pass in order through the ring's S stages, the same slabs every
  // iteration: slab j < P starts at k-step 4 j, the others at 4 j + R.
  // Thread 0 issues the first S; the warp that finishes a stage last
  // issues into it the slab S later (one TMA instruction: no warp waits to
  // copy). The consumers' place: slab js of the iteration's Qs, in stage
  // st at phase parity ph.
  const int Q = nks - R, P = S > 0 ? min(S, Q / 4) : 0, R0 = 4 * P;
  const int Qs = S > 0 ? P + (Q - R0 + 3) / 4 : 0;
  auto issue = [&](int j, int st) {
    mbar_expect_tx(&full_bar[st], (unsigned)(SLAB * sizeof(double)));
    tma_slab(ring + (size_t)st * SLAB, &xmap, &full_bar[st],
             4 * (j < P ? 4 * j : 4 * j + R), lo);
  };
  if (tid == 0)
    for (int st = 0; st < kRingSlabs; ++st) {
      mbar_init(&full_bar[st], 1);
      stage_done[st] = 0;
    }
  if (R > 0)
    stage_resident<RB>(xres, X, ldx, lo, cnt, d, R0, R);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();  // the barriers' init, before any use
  int st = 0, ph = 0;
  if (tid == 0) {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < S; ++it) issue(it % Qs, it);
  }

  // the live lanes' slots: one warp's ballot, in lane order
  auto pick = [&]() {
    if (warp == 0) {
      const bool live = lane < b && !l_done[lane];
      const unsigned ball = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int s = __popc(ball & ((1u << lane) - 1));
        s_lane[s] = lane;
        s_i[s] = l_i[lane];
        s_j[s] = l_j[lane];
        s_C[s] = l_C[lane];
        s_sni[s] = l_ri[lane].sn;
        s_snj[s] = l_rj[lane].sn;
      }
      if (lane == 0) s_live = __popc(ball);
    }
    __syncthreads();
    return s_live;
  };

  // This thread's cells: rows warp 8 RB + 8 rb + gq of the slice, slots
  // 4 vb + tq of the live lanes; their f, alpha and mask bit, and the lane
  // each slot held when they were read.
  double cf[RB][NVB], ca[RB][NVB];
  unsigned mbits = 0;
  int lane_of[NVB];
  auto cell_row = [&](int rb) { return warp * 8 * RB + rb * 8 + gq; };
  auto load_cells = [&](int G) {
    mbits = 0;
#pragma unroll
    for (int vb = 0; vb < NVB; ++vb) {
      const int s = vb * 4 + tq;
      lane_of[vb] = s < G ? s_lane[s] : -1;
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const int r = cell_row(rb);
        cf[rb][vb] = ca[rb][vb] = 0.0;
        if (r < cnt && lane_of[vb] >= 0) {
          const size_t o = (size_t)lane_of[vb] * n + lo + r;
          cf[rb][vb] = fs[o];
          ca[rb][vb] = alphas[o];
          if (masks[o]) mbits |= 1u << (rb * NVB + vb);
        }
      }
    }
  };
  auto store_cells = [&]() {
#pragma unroll
    for (int vb = 0; vb < NVB; ++vb)
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const int r = cell_row(rb);
        if (r < cnt && lane_of[vb] >= 0) {
          const size_t o = (size_t)lane_of[vb] * n + lo + r;
          fs[o] = cf[rb][vb];
          alphas[o] = ca[rb][vb];
        }
      }
  };

  // This thread's candidates over its cells of one lane block (4 slots),
  // reduced at once over the 8 threads of its warp that share its slot
  // into the warp's slots: one lane block's candidates are live at a time.
  struct Best {
    double vu, vl, au, al;
    int iu, il, fg;
  };
  auto add_cand = [&](Best& c, int rb, int vb, double C_s) {
    const int r = cell_row(rb), row = lo + r;
    bool up, low;
    sets(ca[rb][vb], y_s[r], (mbits >> (rb * NVB + vb)) & 1u, C_s, up, low);
    const double fk = cf[rb][vb];
    const double cu = up ? fk : INFINITY, cl = low ? fk : -INFINITY;
    if (better_min(cu, row, c.vu, c.iu)) {
      c.vu = cu;
      c.iu = row;
      c.au = ca[rb][vb];
    }
    if (better_max(cl, row, c.vl, c.il)) {
      c.vl = cl;
      c.il = row;
      c.al = ca[rb][vb];
    }
    c.fg |= (up ? 1 : 0) | (low ? 2 : 0);
  };
  auto warp_slots = [&](Best c, int vb, int G) {
    xor_best(false, c.vu, c.iu, c.au, 4, 16);
    xor_best(true, c.vl, c.il, c.al, 4, 16);
    c.fg = xor_or(c.fg, 4, 16);
    const int s = vb * 4 + tq;
    if (gq == 0 && s < G) {
      w_v[0][warp][s] = c.vu;
      w_i[0][warp][s] = c.iu;
      w_a[0][warp][s] = c.au;
      w_v[1][warp][s] = c.vl;
      w_i[1][warp][s] = c.il;
      w_a[1][warp][s] = c.al;
      w_fg[warp][s] = c.fg;
    }
  };

  // The block's candidates of parity `set` from the warps' slots (8
  // threads a slot and kind) into c_slot; one cluster barrier; the
  // cluster's rank 0 reduces its C blocks' records through distributed
  // shared memory, publishes one a lane and arrives at the grid's counter.
  auto publish = [&](int set, int G) {
    __syncthreads();
    {
      const int s = tid >> 4, kind = (tid >> 3) & 1, w = tid & 7;
      const bool in = s < G;
      double v = kind ? -INFINITY : INFINITY, a = 0.0;
      int i = INT_MAX, fg = 0;
      if (in) {
        v = w_v[kind][w][s];
        i = w_i[kind][w][s];
        a = w_a[kind][w][s];
        fg = w_fg[w][s];
      }
      xor_best(kind != 0, v, i, a, 1, 4);
      fg = xor_or(fg, 1, 4);
      if (in && w == 0) {
        Rec r = {v, i, fg, a, 0.0, 0.0, 0.0};
        if (i != INT_MAX) {
          const int k = i - lo;
          r.y = y_s[k];
          r.sn = pn_s[k];
          r.xn = xn_s[k];
        }
        store_rec(&c_slot[set][s_lane[s]][kind], r);
      }
    }
    cluster.sync();
    if (rank == 0) {
      if (tid < 2 * b && !l_done[tid >> 1]) {
        const int l = tid >> 1, kind = tid & 1;
        Rec best = load_rec(cluster.map_shared_rank(&c_slot[set][l][kind], 0));
        int fg = best.flags;
        for (int c = 1; c < C; ++c) {
          const Rec o =
              load_rec(cluster.map_shared_rank(&c_slot[set][l][kind], c));
          fg |= o.flags;
          if (kind ? better_max(o.v, o.i, best.v, best.i)
                   : better_min(o.v, o.i, best.v, best.i))
            best = o;
        }
        const size_t o = ((size_t)(set * b + l) * 2 + kind) * ncl + cid;
        __stcg(keys + o, make_int4(__double2loint(best.v),
                                   __double2hiint(best.v), best.i, fg));
        __stcg(rows + 2 * o, make_double2(best.a, best.y));
        __stcg(rows + 2 * o + 1, make_double2(best.sn, best.xn));
      }
      __syncthreads();
      // release: the cluster's records are visible before its arrival
      if (tid == 0)
        asm volatile("red.release.gpu.global.add.u64 [%0], 1;\n" ::"l"(
                         counter)
                     : "memory");
    }
  };

  // Every block waits until all clusters arrived for iteration t
  // (lane_barrier's wait, with its two-minute trap).
  auto grid_wait = [&](long long t) {
    if (tid == 0) {
      const unsigned long long target = (unsigned long long)(t + 1) * ncl;
      unsigned long long t0 = 0;
      while (ld_acquire(counter) < target) {
        if (t0 == 0)
          t0 = now_ns();
        else if (now_ns() - t0 > 120000000000ull)
          __trap();
      }
    }
    __syncthreads();
  };

  // The lanes' picks of parity `set`: block rank r of a cluster takes the
  // lanes l = r (mod C), a warp a lane: each thread loads its share of the
  // lane's ncl keys (the same in every cluster) at once, the warp reduces
  // them, and lane 0 loads the winners' rows, tests the lane's stop or
  // records its pick, in every block of the cluster (distributed shared
  // memory); one cluster barrier hands them round. Each block so reads
  // b / C lanes' keys, not b, in one round of loads.
  auto reduce = [&](int set) {
    const int l = rank + warp * C;
    if (l >= b || l_done[l]) return;  // uniform over the warp
    const size_t base = (size_t)(set * b + l) * 2 * ncl;
    double vu = INFINITY, vl = -INFINITY, pu = 0.0, pl = 0.0;
    int iu = INT_MAX, il = INT_MAX, fg = 0;
    auto take = [&](int p, const int4& ku, const int4& kl) {
      const double u = __hiloint2double(ku.y, ku.x);
      const double w = __hiloint2double(kl.y, kl.x);
      fg |= ku.w | kl.w;
      if (better_min(u, ku.z, vu, iu)) {
        vu = u;
        iu = ku.z;
        pu = p;
      }
      if (better_max(w, kl.z, vl, il)) {
        vl = w;
        il = kl.z;
        pl = p;
      }
    };
    int4 ku[3], kl[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int p = lane + 32 * j;
      if (p < ncl) {
        ku[j] = __ldcg(keys + base + p);
        kl[j] = __ldcg(keys + base + ncl + p);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (lane + 32 * j < ncl) take(lane + 32 * j, ku[j], kl[j]);
    for (int p = lane + 96; p < ncl; p += 32)
      take(p, __ldcg(keys + base + p), __ldcg(keys + base + ncl + p));
    xor_best(false, vu, iu, pu, 1, 16);
    xor_best(true, vl, il, pl, 1, 16);
    fg = xor_or(fg, 1, 16);
    if (lane != 0) return;
    const double gap = fg == 3 ? vl - vu : -INFINITY;
    const bool stop = (gap <= tol) || (l_it[l] >= l_cap[l]) || isnan(gap);
    Rec ri = {vu, iu, fg, 0.0, 0.0, 0.0, 0.0};
    Rec rj = {vl, il, fg, 0.0, 0.0, 0.0, 0.0};
    if (!stop) {
      const double2* ru = rows + 2 * (base + (int)pu);
      const double2* rl = rows + 2 * (base + ncl + (int)pl);
      const double2 u0 = __ldcg(ru), u1 = __ldcg(ru + 1);
      const double2 w0 = __ldcg(rl), w1 = __ldcg(rl + 1);
      ri.a = u0.x;
      ri.y = u0.y;
      ri.sn = u1.x;
      ri.xn = u1.y;
      rj.a = w0.x;
      rj.y = w0.y;
      rj.sn = w1.x;
      rj.xn = w1.y;
    }
    for (int c = 0; c < C; ++c) {
      if (stop) {
        *cluster.map_shared_rank(&l_done[l], c) = 1;
      } else {
        *cluster.map_shared_rank(&l_i[l], c) = iu;
        *cluster.map_shared_rank(&l_j[l], c) = il;
        // f_i: i is in I_up, so its candidate value is f
        *cluster.map_shared_rank(&l_fi[l], c) = vu;
        *cluster.map_shared_rank(&l_fj[l], c) = vl;
        store_rec(cluster.map_shared_rank(&l_ri[l], c), ri);
        store_rec(cluster.map_shared_rank(&l_rj[l], c), rj);
      }
    }
  };

  int G = pick();
  load_cells(G);
#pragma unroll
  for (int vb = 0; vb < NVB; ++vb) {
    if (vb >= (G + 3) / 4) continue;  // uniform
    const int s = vb * 4 + tq;
    Best c = {INFINITY, -INFINITY, 0.0, 0.0, INT_MAX, INT_MAX, 0};
    if (rows_here && s < G)
#pragma unroll
      for (int rb = 0; rb < RB; ++rb)
        if (cell_row(rb) < cnt) add_cand(c, rb, vb, s_C[s]);
    warp_slots(c, vb, G);
  }
  publish(0, G);
  bool clip_all = true;
  for (long long t = 0; t < n_iters; ++t) {
    const int set = (int)(t & 1);
    grid_wait(t);
    reduce(set);
    cluster.sync();
    const int G_new = pick();
    if (G_new < G) {  // a lane stopped: its cells to memory, the rest move
      store_cells();
      __syncthreads();
      G = G_new;
      load_cells(G);
    }
    if (G == 0) break;  // uniform: every block reduced the same picks
    const int nvb = (G + 3) / 4;

    // the pair rows, fetched once a cluster: rank r the rows w = r mod C,
    // every load of the block issued before its stores
    {
      const int half = (d + 1) / 2, rows_w = 2 * G;
      const int mine = rank < rows_w ? (rows_w - rank + C - 1) / C : 0;
      constexpr int kPer = 4;  // loads a thread in flight
      for (int e0 = tid; e0 < mine * half; e0 += kPer * kThreads) {
        double2 v[kPer];
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int e = e0 + u * kThreads;
          if (e < mine * half) {
            const int w = rank + (e / half) * C, k = 2 * (e % half);
            const int row = (w & 1) ? s_j[w >> 1] : s_i[w >> 1];
            v[u] = __ldcg(
                reinterpret_cast<const double2*>(X + (size_t)row * ldx + k));
          }
        }
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int e = e0 + u * kThreads;
          if (e < mine * half) {
            const int w = rank + (e / half) * C, k = 2 * (e % half);
            for (int c = 0; c < C; ++c)
              *reinterpret_cast<double2*>(cluster.map_shared_rank(ps, c) +
                                          (size_t)w * pst + k) = v[u];
          }
        }
      }
      cluster.sync();
    }

    // the products in order of k, in groups of up to four k-steps that
    // share their source (a streamed slab, or resident k-steps), each
    // group's k-steps unrolled so that their loads, products and chain
    // steps overlap (a product's result is ready ~150 cycles after it
    // starts); thread (warp s % 8, lane s / 8) meanwhile sums slot s's
    // K[i, j] cross product x_j . x_i in the same order (one chain, as
    // smo_select_kernel's)
    double acc[RB][NVB][2];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int vb = 0; vb < NVB; ++vb) acc[rb][vb][0] = acc[rb][vb][1] = 0.0;
    const int my_s = warp + kWarps * lane;  // the slot of this thread's chain
    const bool chain = lane < 2 && my_s < G;
    // every lane runs the chain's instructions (no branch, so that they
    // interleave with the products); a lane without a chain of its own sums
    // slot 0's pair and nobody reads its sum
    const double* xi_c = ps + (chain ? (size_t)2 * my_s * pst : 0);
    double cross = 0.0;
    int js = 0;  // this iteration's streamed slabs so far
    for (int ks = 0; ks < nks;) {
      const bool streamed = ks < R0 || ks >= R0 + R;
      const int nk = min(4, (streamed ? nks : R0 + R) - ks);
      const double* src;
      if (streamed) {
        mbar_wait(&full_bar[st], ph);
        src = ring + (size_t)st * SLAB;
      } else {
        src = xres + (size_t)(ks - R0) * KD;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nk) break;  // uniform
        const int k4 = 4 * (ks + j);
        if (rows_here) {
          // feature f of this k-step of the thread's row block rb
          auto x_at = [&](int rb, int f) {
            return streamed
                       ? src[swz(warp * 8 * RB + rb * 8 + gq, 4 * j + f)]
                       : src[(size_t)j * KD + (warp * RB + rb) * 32 + gq * 4 +
                             f];
          };
          if constexpr (kTensorF64) {
            double a[RB], bv[NVB];
#pragma unroll
            for (int rb = 0; rb < RB; ++rb) a[rb] = x_at(rb, tq);
            const double* pb = ps + gq * pst + k4 + tq;
#pragma unroll
            for (int vb = 0; vb < NVB; ++vb)
              bv[vb] = vb < nvb ? pb[vb * 8 * pst] : 0.0;
#pragma unroll
            for (int vb = 0; vb < NVB; ++vb) {
              if (vb < nvb) {
#pragma unroll
                for (int rb = 0; rb < RB; rb += 2)
                  dmma16(acc[rb][vb], acc[rb + 1][vb], a[rb], a[rb + 1],
                         bv[vb]);
              }
            }
          } else {
            const int kw = min(4, d - k4);
            for (int k = 0; k < kw; ++k) {
              double x[RB];
#pragma unroll
              for (int rb = 0; rb < RB; ++rb) x[rb] = x_at(rb, k);
#pragma unroll
              for (int vb = 0; vb < NVB; ++vb) {
                if (vb < nvb) {
                  const double* pp =
                      ps + (size_t)(vb * 8 + 2 * tq) * pst + k4 + k;
                  const double pi = pp[0], pj = pp[pst];
#pragma unroll
                  for (int rb = 0; rb < RB; ++rb) {
                    acc[rb][vb][0] = fma(x[rb], pi, acc[rb][vb][0]);
                    acc[rb][vb][1] = fma(x[rb], pj, acc[rb][vb][1]);
                  }
                }
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (k4 + u < d)  // uniform
            cross = fma(xi_c[pst + k4 + u], xi_c[k4 + u], cross);
      }
      if (streamed) {
        // the last warp done with the stage issues the slab S later into it
        __syncwarp();
        if (lane == 0) {
          __threadfence_block();
          if (atomicAdd(&stage_done[st], 1) == kWarps - 1) {
            stage_done[st] = 0;
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            issue((js + S) % Qs, st);
          }
        }
        ++js;
        if (++st == S) {
          st = 0;
          ph ^= 1;
        }
      }
      ks += nk;
    }
    // the cells' K, over their dot products (no branches between the
    // cells, so that their exps overlap; a cell past the slice or the live
    // lanes computes a value nobody reads), and each chain's scalar step
    if (rows_here) {
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const double xr2 = xn_s[cell_row(rb)];
#pragma unroll
        for (int vb = 0; vb < NVB; ++vb) {
          if (vb < nvb) {  // uniform
            const int s = vb * 4 + tq;
            acc[rb][vb][0] =
                rbf_from_dot(xr2, s_sni[s], acc[rb][vb][0], neg_gamma);
            acc[rb][vb][1] =
                rbf_from_dot(xr2, s_snj[s], acc[rb][vb][1], neg_gamma);
          }
        }
      }
    }
    if (chain) {
      const int l = s_lane[my_s], i = s_i[my_s], j = s_j[my_s];
      const Rec ri = l_ri[l], rj = l_rj[l];
      double d2 = rj.xn + ri.sn - 2.0 * cross;
      d2 = d2 < 0.0 ? 0.0 : d2;
      const double kij = exp(neg_gamma * d2);
      const double eta_ij = nan_max(1.0 + 1.0 - 2.0 * kij, kTau);
      double new_i, new_j;
      s_delta[my_s] = pair_step(l_fi[l], l_fj[l], ri.a, rj.a, ri.y, rj.y,
                                i == j, eta_ij, s_C[my_s], new_i, new_j);
      s_newi[my_s] = new_i;
      s_newj[my_s] = new_j;
      l_it[l] += 1;
    }
    __syncthreads();  // delta and the pair's alphas, before the f-update

    // the f-update and the owners' new alphas (j after i), clipped, and
    // cell by cell the candidates of the next iteration
#pragma unroll
    for (int vb = 0; vb < NVB; ++vb) {
      if (vb >= nvb) continue;  // uniform
      const int s = vb * 4 + tq;
      Best c = {INFINITY, -INFINITY, 0.0, 0.0, INT_MAX, INT_MAX, 0};
      if (rows_here && s < G) {
        const double dl = s_delta[s], Cl = s_C[s];
        const int i = s_i[s], j = s_j[s];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          const int r = cell_row(rb), row = lo + r;
          if (r >= cnt) continue;
          cf[rb][vb] = smo_f_update_elem(cf[rb][vb], acc[rb][vb][0],
                                         acc[rb][vb][1], dl);
          double ak = ca[rb][vb];
          if (row == i) ak = s_newi[s];
          if (row == j) ak = s_newj[s];
          if (clip_all || row == i || row == j) ak = clip(ak, Cl);
          ca[rb][vb] = ak;
          add_cand(c, rb, vb, Cl);
        }
      }
      warp_slots(c, vb, G);
    }
    clip_all = false;
    if (t + 1 == n_iters) break;
    publish(set ^ 1, G);
  }
  // the slabs still in flight (the S after the last one used) land
  // before the block leaves
  if (tid == 0)
    for (int j = 0; j < S; ++j)
      mbar_wait(&full_bar[(st + j) % S], st + j < S ? ph : ph ^ 1);
  store_cells();
  if (blockIdx.x == 0 && tid < b) {
    n_iter[tid] = l_it[tid];
    done_flags[tid] = l_done[tid] ? 1 : 0;
  }
  cluster.sync();  // no block leaves while another may read its records
}

// The kernel for tiles of RB row blocks a warp and NVB lane blocks of 4.
template <int RB>
const void* kernel_nvb(int nvb) {
  switch (nvb) {
    case 1: return (const void*)smo_stream_cluster_kernel<RB, 1>;
    case 2: return (const void*)smo_stream_cluster_kernel<RB, 2>;
    case 3: return (const void*)smo_stream_cluster_kernel<RB, 3>;
    default: return (const void*)smo_stream_cluster_kernel<RB, 4>;
  }
}

// RB 2 (tiles of 128 rows) for slices of at most 128 rows, else 4 (256).
int slice_rb(int slice) { return slice <= tile_rows<2>() ? 2 : 4; }

const void* cluster_kernel(int rb, int b) {
  const int nvb = (b + 3) / 4;
  return rb == 2 ? kernel_nvb<2>(nvb) : kernel_nvb<4>(nvb);
}

// The dynamic shared memory a block takes: all the card lets it, less the
// kernel's static arrays; and the layout of it for d, b at tiles of rb.
cudaError_t block_smem(const void* kernel, size_t& smem) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  smem = ((size_t)optin - fa.sharedSizeBytes) & ~(size_t)15;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool layout_rb(int rb, int d, int b, size_t smem, Layout& L) {
  return rb == 2 ? layout<2>(d, b, smem, L) : layout<4>(d, b, smem, L);
}

// The launch of m blocks in clusters of C over b lanes at tiles of rb.
cudaError_t config(int m, int C, int rb, int d, int b,
                   cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                   Layout& L, cudaStream_t stream) {
  if (C < 2 || C > kMaxCluster || m < C || m % C != 0 || b < 1 ||
      b > kLanes || d < 1)
    return cudaErrorInvalidValue;
  const void* kernel = cluster_kernel(rb, b);
  size_t smem = 0;
  const cudaError_t e = block_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  if (!layout_rb(rb, d, b, smem, L)) return cudaErrorInvalidValue;
  cfg = {};
  cfg.gridDim = dim3(m);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaSuccess;
}

// X (n, d), rows ldx apart, as boxes of 16 features x `rows` rows with the
// 128-byte swizzle; features past d and rows past n read as zeros.
int x_tensor_map(CUtensorMap* map, const double* X, int n, int d, int ldx,
                 int rows) {
  const hopper::EncodeTiled enc = hopper::encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)ldx * sizeof(double)};
  const cuuint32_t box[2] = {16, (cuuint32_t)rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 2,
                         const_cast<double*>(X), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// Clusters of C blocks (2..8) the current device runs at once for d
// features and b lanes at tiles of rb (2: 128 rows, 4: 256), every block
// with the shared memory the kernel takes (cudaOccupancyMaxActiveClusters,
// which knows how the GPCs hold clusters); 0 where the layout cannot hold a
// block.
extern "C" int smo_stream_cluster_capacity(int d, int b, int C, int rb,
                                           int* clusters) {
  *clusters = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  Layout L;
  const cudaError_t e = config(C, C, rb, d, b, cfg, attr, L, 0);
  if (e == cudaErrorInvalidValue) return 0;
  if (e != cudaSuccess) return (int)e;
  cfg.numAttrs = 1;  // the query takes the cluster dimension alone
  return (int)cudaOccupancyMaxActiveClusters(clusters, cluster_kernel(rb, b),
                                             &cfg);
}

// How a block holds X for d features and b lanes at tiles of rb: k-steps
// of four features in all (ksteps), resident (resident), streamed through
// a ring of `stages`, and its dynamic shared memory in bytes.
extern "C" int smo_stream_cluster_layout(int d, int b, int rb, int* ksteps,
                                         int* resident, int* stages,
                                         long long* smem_bytes) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  Layout L;
  const cudaError_t e = config(2, 2, rb, d, b, cfg, attr, L, 0);
  if (e != cudaSuccess) return (int)e;
  *ksteps = L.nks;
  *resident = L.R;
  *stages = L.S;
  *smem_bytes = (long long)cfg.dynamicSmemBytes;
  return 0;
}

// Up to n_iters streaming WSS-1 iterations over b lanes of one X, as
// smo_stream_persistent_f64 (smo_step.cu), on m blocks of `slice` rows in
// clusters of C (kernels/smo_chunk.py::stream_cluster_plan: every block
// resident at once, slice <= 256). X's rows are ldx apart, an even stride
// on 16-byte boundaries (a zero column past an odd d). `workspace` holds
// the grid's barrier counter (16 bytes, zeroed), then the records' keys
// (16 bytes each) and rows (32 bytes each), each [2 parities][b lanes][2
// kinds][m / C clusters] (kernels/smo_chunk.py::stream_cluster_workspace).
extern "C" int smo_stream_cluster_f64(
    const double* X, const double* xn, const double* sn, const double* y,
    const unsigned char* masks, const double* Cs, double tol,
    const long long* it_caps, long long n_iters, double gamma, double* alphas,
    double* fs, long long* n_iter, unsigned char* done, int n, int d,
    int ldx, int b, int m, int C, int slice, void* workspace,
    cudaStream_t stream) {
  if (n <= 0 || b <= 0 || n_iters <= 0) return (int)cudaGetLastError();
  if (ldx < d + (d & 1) || ldx % 2 != 0 ||
      reinterpret_cast<uintptr_t>(X) % 16 != 0 || slice < 1 ||
      slice > tile_rows<4>() || (long long)m * slice < n)
    return (int)cudaErrorInvalidValue;
  const int rb = slice_rb(slice);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  Layout L;
  cudaError_t e = config(m, C, rb, d, b, cfg, attr, L, stream);
  if (e != cudaSuccess) return (int)e;
  const void* kernel = cluster_kernel(rb, b);
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return (int)e;
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  unsigned long long* counter = reinterpret_cast<unsigned long long*>(ws);
  const size_t nrec = (size_t)2 * b * 2 * (m / C);
  int4* keys = reinterpret_cast<int4*>(ws + 16);
  double2* rows = reinterpret_cast<double2*>(ws + 16 + nrec * sizeof(int4));
  CUtensorMap xmap;
  const int te = x_tensor_map(&xmap, X, n, d, ldx,
                              rb == 2 ? tile_rows<2>() : tile_rows<4>());
  if (te) return te;
  const double neg_gamma = -gamma;
  int R = L.R, S = L.S;
  void* args[] = {&X,      &xn,     &sn,      &y,       &masks,
                  &Cs,     &tol,    &it_caps, &n_iters,
                  const_cast<double*>(&neg_gamma), &alphas, &fs, &n_iter,
                  &done,   &n,      &d,       &ldx,     &b,
                  &slice,  &R,      &S,       &counter, &keys,   &rows,
                  &xmap};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
