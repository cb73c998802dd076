// Matrix-free SMO step over lanes: the fused kernel-row pair + rank-2
// f-update, the WSS-1 selection that feeds it, and the persistent streaming
// chunk that runs both for many iterations in one launch.
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
// Design: a persistent grid (one block of 8 compute warps and a side warp
// per SM, sized by the occupancy calculator) walks tiles of 256 rows. Past
// 16 lanes the lanes split into even lane blocks, one a grid row (y), so
// that they run side by side, not one after another. A block stages its
// live lanes' pair rows in shared memory once per launch. Each tile streams through a three-stage cp.async
// ring of 16-feature slabs, so the next slabs' loads overlap this slab's
// products. A compute warp owns 32 rows of the tile and computes their dot
// products with every pair row as 8 x 8 tiles on the FP64 tensor cores
// (mma.m16n8k4): each value read from shared memory feeds 8 products, where
// the FMA pipes, at one shared value an fma, are bound by shared memory's
// 128 bytes a cycle. Each output is a chain of fmas in order of k, bitwise
// the FMA path's (chip_smoke.py holds the two builds equal on the card), so
// every output's dot product runs k = 0 .. d-1 in order whatever the tile,
// the grid or the lanes beside it. The side warp sums the pair norms in
// order of k, slab by slab, as before. A lane's f is bitwise the same alone
// or packed. float32 runs the same tiles on the FMA pipes, accumulating in
// f32 as the TPU kernel does.
//
// Bound: bytes. Per launch X (8 n d bytes) is read once, f read and written
// per lane (16 b n) and the norms read (8 n); the products are 4 b n d
// operations, about a fifth of the bytes' time at the FP64 tensor rate at d
// = 123 and 10 lanes. X (32 MB at the paper's n = 32,560) fits the card's
// 50 MB L2, so back-to-back launches can beat the HBM bound.
//
// smo_select_kernel is the rest of the reference's streaming SMO step
// (src/repro/svm/engine.py::_step, WSS-1 branch with a streaming source): one
// block per lane picks the maximal violating pair, evaluates K[i, j] by the
// same expression and the same order as the fused kernel's row j (the
// reference's interpret-mode kij, engine.py:452-454), clips delta, updates
// alpha_i and alpha_j, and writes (pair rows, delta, done) for the fused
// launch. Its bound is bytes (a lane's alpha, f and mask once, ~17 n
// bytes), far below the latency of what it must do in order: one pass over
// the rows, a block-wide reduction, the pair rows' round trip to memory and
// the d-long chain of K[i, j]. So its design cuts the serial path: 256
// threads of strided rows, one barrier (integer key reductions per warp,
// then every warp reduces the slots), the winners' alpha and y carried in
// the slots, one chain (|x_i|^2 comes from the table sn, summed in the same
// order), read from shared memory, while the other warps write the pair
// rows. smo_stream_chunk_f64 (the "pair" route) issues up to n_iters
// (select, fused) pairs from one host call and stops soon after every lane
// is done; the lanes' state stays in device memory throughout.
//
// smo_stream_kernel (the "persistent" route) runs the same iterations in
// ONE cooperative launch: each block owns a slice of about 128 rows for the
// whole launch and keeps its lanes' f, alpha and mask there in shared
// memory. An iteration is: ONE barrier across the grid; every block reduces
// all blocks' WSS-1 candidates itself with the NaN-first, lowest-index rule
// (exact in any order: the one-block kernel's picks), the winners' alpha, y
// and norms coming with them (|x|^2 from the same table sn the selection
// kernel reads); it stages the pair rows and runs the fused
// kernel's tile loop over its slice, the side warp meanwhile taking K[i, j]
// and delta as smo_select_kernel does; the f-update and the owners' new
// alphas; and, cell by cell from the f it has just written, the block's
// candidates for the next iteration. So the route is bitwise the pair
// route. A slice of at most 128 rows runs 16 rows a warp (half the cells a
// thread, so half its serial exps). It stops on the device when every lane
// is done or n_iters are spent.
//
// Lanes with their own operands (the shrinking scheduler's compact lanes,
// src/repro/svm/engine.py::chunk_batched_sources_jit): the entries take
// element strides between the lanes' X, x_lane, and between their norms
// and labels, v_lane (0: one X for every lane), and the persistent entry a
// count of groups (a lane a group). The selection kernel reads lane l's
// operands at l times the strides; the fused kernel then stages one lane a
// lane block (each block streams that lane's own rows of X); the
// persistent kernel runs the lanes as independent groups of blocks in one
// cooperative launch, each group a one-lane launch over its own X with its
// own barrier counter and candidates. Every output is computed by the same
// chain in the same order as in a one-lane launch, so a lane is bitwise
// its solo launch.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "smo_common.cuh"

namespace {

constexpr int kWarps = 8;                    // warps over a tile's rows
constexpr int kSideWarp = kWarps;            // and one for the serial sums
constexpr int kThreads = (kWarps + 1) * 32;  // a block
constexpr int kRB = 4;                       // row blocks of 8 a warp carries
constexpr int kTile = kWarps * 8 * kRB;      // rows of a tile
constexpr int kSlab = 16;                    // features per staged slab
constexpr int kStages = 3;                   // slabs in flight
constexpr int kLanes = 16;                   // lanes staged at once
constexpr int kVB = kLanes / 4;              // lane blocks of 4 (8 pair rows)
constexpr int kGroup = 16;                   // threads that reduce one lane
constexpr int kBlockRows = 128;              // rows a persistent block aims at
// float64 dot products on the FP64 tensor cores (m16n8k4), each output a
// chain of fmas in order of k like the FMA path; float32 stays on the FMA
// pipes. Built with -DSMO_STEP_TENSOR_F64=0, float64 takes the FMA path
// too: the witness build that chip_smoke.py holds bitwise equal on the card.
#ifndef SMO_STEP_TENSOR_F64
#define SMO_STEP_TENSOR_F64 1
#endif
constexpr bool kTensorF64 = SMO_STEP_TENSOR_F64 != 0;

// A staged row's stride: 16 features and a pad that keeps the fragment
// loads (f64: 4 rows x 4 features a half-warp) and the row loads (f32: 8
// rows a warp) off each other's banks.
template <typename T>
__host__ __device__ constexpr int x_stride() {
  return sizeof(T) == 8 ? kSlab + 4 : kSlab + 2;
}

// A staged pair row's stride: d rounded up to whole slabs (zeros past d),
// plus 4 doubles (a half-warp's 4 rows x 4 features of a B fragment on
// distinct banks).
__host__ __device__ inline int pair_stride(int d) {
  return (d + kSlab - 1) / kSlab * kSlab + 4;
}

// The rows of a tile whose warps carry RB row blocks of 8.
template <int RB>
__host__ __device__ constexpr int tile_rows() {
  return kWarps * 8 * RB;
}

template <typename T, int TILE = kTile>
size_t ring_bytes() {
  return (size_t)kStages * TILE * x_stride<T>() * sizeof(T);
}

// The pair rows of b lanes, padded to whole lane blocks.
__host__ __device__ inline size_t pairs_bytes(int d, int b, size_t elem) {
  return 2 * (size_t)((b + 3) / 4 * 4) * pair_stride(d) * elem;
}

template <typename T>
__device__ __forceinline__ T exp_t(T x);
template <>
__device__ __forceinline__ double exp_t<double>(double x) { return exp(x); }
template <>
__device__ __forceinline__ float exp_t<float>(float x) { return expf(x); }

// Rows [row0, row0 + rows) and features [k0, k0 + kw) of X (rows ldx
// apart) into a ring stage laid out [row][x_stride], as one cp.async group
// of VEC elements a copy (VEC = 2, 16 bytes, needs rows at 16-byte
// boundaries and a zero column past an odd d). The compute warps copy: a
// thread takes the same VEC features of every (TILE / (16 / VEC))-th row,
// so neighbouring threads read one row's 16 features (coalesced) and a
// copy costs an add and the cp.async. A ragged last slab is zero-filled to
// 16 features (the tensor cores step 4 at a time). Every thread
// commits.
template <typename T, int VEC, int TILE = kTile>
__device__ __forceinline__ void stage_slab(T* xs, const T* __restrict__ X,
                                           size_t ldx, int row0, int rows,
                                           int k0, int kw) {
  constexpr int XS = x_stride<T>(), kPer = kSlab / VEC;
  constexpr int kStep = TILE / kPer;  // rows a pass of the block copies
  if (threadIdx.x < TILE) {
    const int r = threadIdx.x / kPer, k = threadIdx.x % kPer * VEC;
    T* dst = xs + r * XS + k;
    if (k >= kw) {
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int v = 0; v < VEC; ++v) dst[i * kStep * XS + v] = T(0);
    } else {
      const T* src = X + (size_t)(row0 + r) * ldx + k0 + k;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (r + i * kStep < rows)
          cp_async<sizeof(T) * VEC>(dst + i * kStep * XS,
                                    src + (size_t)i * kStep * ldx);
    }
  }
  cp_async_commit();
}

// The pair rows of G lanes into ps [2 * slot + {0, 1}][pair_stride(d)] as
// one cp.async group (row(w) is pair row w's source), zeros past d and in
// the pad rows up to a whole lane block; the caller waits. One flat loop
// over every element, each block starting at another one (every block
// reads the same rows).
template <typename T, typename Row>
__device__ __forceinline__ void stage_pairs(T* ps, int d, int G, Row row) {
  const int pst = pair_stride(d), rows = 2 * ((G + 3) / 4 * 4);
  const int total = rows * pst, start = blockIdx.x % rows * pst;
  for (int e0 = threadIdx.x; e0 < total; e0 += kThreads) {
    const int e = (e0 + start) % total, w = e / pst, k = e - w * pst;
    if (w < 2 * G && k < d)
      cp_async<sizeof(T)>(ps + e, row(w) + k);
    else
      ps[e] = T(0);
  }
  cp_async_commit();
}

// One slab of a compute warp's dot products: its 8 RB rows of the tile
// (row blocks rb of 8) with the pair rows of nvb lane blocks (vb of 4
// lanes), over features k0 .. k0 + kw - 1, into acc[rb][vb] = (x . x_i,
// x . x_j) of row warp * 8 RB + 8 rb + g and lane slot 4 vb + t (g = lane
// / 4, t = lane % 4: the tensor cores' accumulator layout). Every sum is a
// chain of fmas in order of k, on either path. f64: on the tensor cores,
// operands loaded as fragments (a k-step's 16 x 8 x 4 tile reuses each
// value 8 times; the FMA pipes read one shared value an fma and are bound
// by shared memory's 128 bytes a cycle); f32: on the FMA pipes.
template <typename T, int RB = kRB>
__device__ __forceinline__ void tile_dots(const T* xs, const T* ps, int pst,
                                          int k0, int kw, int nvb, int warp,
                                          int lane,
                                          T (&acc)[RB][kVB][2]) {
  constexpr int XS = x_stride<T>();
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, double>::value && kTensorF64) {
    const double* xa = xs + (warp * 8 * RB + g) * XS + t;
    const double* pb = ps + g * pst + k0 + t;
#pragma unroll
    for (int k = 0; k < kSlab; k += 4) {
      if (k < kw) {
        double a[RB];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) a[rb] = xa[rb * 8 * XS + k];
#pragma unroll
        for (int vb = 0; vb < kVB; ++vb) {
          if (vb < nvb) {
            const double bv = pb[vb * 8 * pst + k];
#pragma unroll
            for (int rb = 0; rb < RB; rb += 2)
              dmma16(acc[rb][vb], acc[rb + 1][vb], a[rb], a[rb + 1], bv);
          }
        }
      }
    }
  } else {
    for (int k = 0; k < kw; ++k) {
      T x[RB];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb)
        x[rb] = xs[(warp * 8 * RB + rb * 8 + g) * XS + k];
#pragma unroll
      for (int vb = 0; vb < kVB; ++vb) {
        if (vb < nvb) {
          const T* p = ps + (size_t)(vb * 8 + 2 * t) * pst + k0 + k;
          const T pi = p[0], pj = p[pst];
#pragma unroll
          for (int rb = 0; rb < RB; ++rb) {
            acc[rb][vb][0] = fma_t(x[rb], pi, acc[rb][vb][0]);
            acc[rb][vb][1] = fma_t(x[rb], pj, acc[rb][vb][1]);
          }
        }
      }
    }
  }
}

template <typename T, int RB>
__device__ __forceinline__ void zero_acc(T (&acc)[RB][kVB][2]) {
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
#pragma unroll
    for (int vb = 0; vb < kVB; ++vb) acc[rb][vb][0] = acc[rb][vb][1] = T(0);
}

// K[r, p] from the dot product c = X[r] . p and the norms.
template <typename T>
__device__ __forceinline__ T rbf_from_dot(T xr2, T sn, T c, T neg_gamma) {
  T d2 = xr2 + sn - T(2) * c;
  d2 = d2 < T(0) ? T(0) : d2;  // max(d2, 0), NaN kept
  return exp_t<T>(neg_gamma * d2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_smo_step_kernel(T* __restrict__ f, const T* __restrict__ X,
                      const T* __restrict__ xn, const T* __restrict__ xij,
                      const T* __restrict__ delta,
                      const unsigned char* __restrict__ done, int n, int d,
                      int b, int lane_block, T neg_gamma, long long x_lane,
                      long long v_lane) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int XS = x_stride<T>();
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* ps = ring + kStages * kTile * XS;
  __shared__ T sn2[2 * kLanes];
  __shared__ T dl[kLanes];
  __shared__ int live[kLanes];
  __shared__ int s_live;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int pst = pair_stride(d);
  const int nslabs = (d + kSlab - 1) / kSlab;
  const int ntiles = (n + kTile - 1) / kTile;
  const int my_tiles = (int)blockIdx.x < ntiles
                           ? (ntiles - 1 - (int)blockIdx.x) / gridDim.x + 1
                           : 0;
  const int Q = my_tiles * nslabs;  // this block's slabs per lane block

  for (int l0 = (int)blockIdx.y * lane_block; l0 < b;
       l0 += lane_block * (int)gridDim.y) {
    const int nl = min(lane_block, b - l0);
    // the lane block's X and norms (one lane a block where they are its own)
    const T* __restrict__ Xl = X + l0 * x_lane;
    const T* __restrict__ xnl = xn + l0 * v_lane;
    __syncthreads();  // the last lane block is done with ps and the ring
    if (tid < nl) live[tid] = done != nullptr && done[l0 + tid];  // flags
    __syncthreads();
    if (tid == 0) {
      int G = 0;
      for (int p = 0; p < nl; ++p)
        if (!live[p]) live[G++] = l0 + p;
      s_live = G;
    }
    __syncthreads();
    const int G = s_live;
    if (G == 0 || Q == 0) continue;  // uniform over the block
    const int nvb = (G + 3) / 4;
    if (tid < G) dl[tid] = delta[live[tid]];
    stage_pairs(ps, d, G, [&](int w) {
      return xij + ((size_t)2 * live[w >> 1] + (w & 1)) * d;
    });
    auto issue = [&](int q) {
      if (q < Q) {
        const int row0 = ((int)blockIdx.x + (q / nslabs) * (int)gridDim.x) *
                         kTile;
        const int k0 = (q % nslabs) * kSlab;
        stage_slab<T, 1>(ring + (q % kStages) * kTile * XS, Xl, d, row0,
                         min(kTile, n - row0), k0, min(kSlab, d - k0));
      } else {
        cp_async_commit();  // keep the group count in step
      }
    };
    for (int q = 0; q < kStages - 1; ++q) issue(q);
    cp_async_wait<kStages - 1>();  // the pair rows (the oldest group)
    __syncthreads();
    T acc[kRB][kVB][2];
    T sn = T(0);  // the side warp: pair row `lane`'s norm, slab by slab
    for (int q = 0; q < Q; ++q) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // slab q landed; slab q - 1's stage is free
      issue(q + kStages - 1);
      const int ks = q % nslabs, k0 = ks * kSlab, kw = min(kSlab, d - k0);
      if (warp < kWarps) {
        if (ks == 0) zero_acc(acc);
        tile_dots<T>(ring + (q % kStages) * kTile * XS, ps, pst, k0, kw, nvb,
                     warp, lane, acc);
      } else if (q < nslabs && lane < 2 * G) {
        const T* p = ps + (size_t)lane * pst;
        for (int k = k0; k < k0 + kw; ++k) sn = sn + p[k] * p[k];
        if (q == nslabs - 1) sn2[lane] = sn;
      }
      if (ks != nslabs - 1) continue;
      if (q == nslabs - 1) __syncthreads();  // the norms, once
      const int row0 = ((int)blockIdx.x + (q / nslabs) * (int)gridDim.x) *
                       kTile + warp * 32 + g;
      // the side warp, and a warp whose rows are all past n
      if (warp == kSideWarp || row0 - g >= n) continue;
      // a row block's f first (its loads in flight at once) and its K
      // without branches between its cells, so that their exps overlap
      // (a cell past n or the live lanes computes a value nobody reads)
#pragma unroll
      for (int rb = 0; rb < kRB; ++rb) {
        const int row = row0 + rb * 8;
        T fv[kVB], kiv[kVB], kjv[kVB];
#pragma unroll
        for (int vb = 0; vb < kVB; ++vb) {
          const int s = vb * 4 + t;
          if (row < n && vb < nvb && s < G)
            fv[vb] = f[(size_t)live[s] * n + row];
        }
        const T xr2 = xnl[min(row, n - 1)];
#pragma unroll
        for (int vb = 0; vb < kVB; ++vb) {
          if (vb < nvb) {  // uniform
            const int s = vb * 4 + t;
            kiv[vb] = rbf_from_dot(xr2, sn2[2 * s], acc[rb][vb][0], neg_gamma);
            kjv[vb] =
                rbf_from_dot(xr2, sn2[2 * s + 1], acc[rb][vb][1], neg_gamma);
          }
        }
        if (row >= n) continue;
#pragma unroll
        for (int vb = 0; vb < kVB; ++vb) {
          const int s = vb * 4 + t;
          if (vb >= nvb || s >= G) continue;
          f[(size_t)live[s] * n + row] =
              smo_f_update_elem<T>(fv[vb], kiv[vb], kjv[vb], dl[s]);
        }
      }
    }
    cp_async_wait_all();
  }
}

// The current device's SM count and opt-in shared memory per block.
cudaError_t card(int& sms, int& optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return e;
}

// The fused launch's lanes staged at once, shared memory and resident
// blocks for d features and b lanes on the current device; worked out once
// per (device, d, b) and kept, since the pair route launches it every
// iteration.
template <typename T>
cudaError_t fused_plan(int d, int b, int& lb, size_t& smem, int& blocks) {
  static int c_dev = -1, c_d = -1, c_b = -1, c_lb = 0, c_blocks = 0;
  static size_t c_smem = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != c_dev || d != c_d || b != c_b) {
    int sms = 0, optin = 0;
    e = card(sms, optin);
    cudaFuncAttributes attr;
    if (e == cudaSuccess)
      e = cudaFuncGetAttributes(&attr, fused_smo_step_kernel<T>);
    if (e != cudaSuccess) return e;
    const long long room = (long long)optin - (long long)attr.sharedSizeBytes -
                           (long long)ring_bytes<T>();
    int l = min(b, kLanes);
    while (l > 0 && (long long)pairs_bytes(d, l, sizeof(T)) > room) --l;
    if (l < 1) return cudaErrorInvalidValue;  // d too large to stage a lane
    const size_t bytes = ring_bytes<T>() + pairs_bytes(d, l, sizeof(T));
    e = cudaFuncSetAttribute(fused_smo_step_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    int per_sm = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_smo_step_kernel<T>, kThreads, bytes);
    if (e != cudaSuccess) return e;
    c_dev = dev;
    c_d = d;
    c_b = b;
    c_lb = l;
    c_smem = bytes;
    c_blocks = max(1, per_sm) * sms;
  }
  lb = c_lb;
  smem = c_smem;
  blocks = c_blocks;
  return cudaSuccess;
}

template <typename T>
int launch_fused(T* f, const T* X, const T* xn, const T* xij, const T* delta,
                 const unsigned char* done, int n, int d, int b, double gamma,
                 long long x_lane, long long v_lane, cudaStream_t stream) {
  if (n <= 0 || b <= 0) return (int)cudaGetLastError();
  int lb = 0, blocks = 0;
  size_t smem = 0;
  const cudaError_t e = fused_plan<T>(d, b, lb, smem, blocks);
  if (e != cudaSuccess) return (int)e;
  // lane blocks as even as the staging room allows, each a grid row; lanes
  // with their own X take a grid row each
  if (x_lane != 0 || v_lane != 0) lb = 1;
  const int rows = (b + lb - 1) / lb, per_row = (b + rows - 1) / rows;
  const dim3 grid(min((n + kTile - 1) / kTile, max(1, blocks / rows)), rows);
  fused_smo_step_kernel<T><<<grid, kThreads, smem, stream>>>(
      f, X, xn, xij, delta, done, n, d, b, per_row, T(-gamma), x_lane,
      v_lane);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// The WSS-1 selection: one block of kSelThreads a lane.
// ------------------------------------------------------------------------

constexpr int kSelThreads = 256;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kSelBatch = 4;  // rows a thread loads before it compares

// A warp's candidate of one reduction, in shared memory: its order key
// (min_key / max_key), value and row, and the row's alpha and y, which
// the scalar step needs, so that no thread reads them again.
struct SelSlot {
  unsigned long long key;
  double v, a, y;
  int row;
};

// The slot with the least key, the lowest row on a tie (a warp's rows are
// strided over the block, so the slots do not rise with the rows), found
// by a warp's integer reductions: lane q < kSelWarps holds slot q.
__device__ __forceinline__ int least_slot(const SelSlot* s, int wl) {
  unsigned long long key = wl < kSelWarps ? s[wl].key : ~0ull;
  const int row = wl < kSelWarps ? s[wl].row : INT_MAX;
  return warp_least_row(key, row);
}

// One selection step of a lane. Pass 1 strides the rows over the block
// (coalesced loads, kSelBatch rows a thread in flight); a thread keeps its
// best rows by one float64 compare each (a NaN first, a tie to the lower
// row, as better_min / better_max); each warp reduces its keys by integer
// reductions (warp_least_row) and publishes its winners with their alpha
// and y; ONE barrier; every warp then reduces the slots itself, by the
// same reductions, lane q taking slot q. Warp 0
// stages x_i and x_j in shared memory and its lane 0 runs the one serial
// chain, x_j . x_i in order of k (the fused kernel's row j, and so K[i, j]
// bitwise), with |x_i|^2 from the table sn summed in the same order; the
// other warps meanwhile write the pair rows for the fused launch and, on a
// chunk's first step, clip the other rows of alpha.
__global__ void __launch_bounds__(kSelThreads)
smo_select_kernel(const double* __restrict__ X, const double* __restrict__ xn,
                  const double* __restrict__ sn, const double* __restrict__ y,
                  const unsigned char* __restrict__ masks,
                  const double* __restrict__ Cs, double tol,
                  const long long* __restrict__ it_caps, double* alphas,
                  const double* __restrict__ fs, long long* n_iter,
                  unsigned char* done_flags, double* xij,
                  double* __restrict__ deltas, int n, int d, double neg_gamma,
                  int clip_all, long long x_lane, long long v_lane) {
  extern __shared__ double pair_s[];  // x_i, then x_j
  __shared__ SelSlot up_s[kSelWarps], low_s[kSelWarps];
  __shared__ int flags_s[kSelWarps];
  const int lane = blockIdx.x;
  if (done_flags[lane]) return;  // uniform over the block
  X += lane * x_lane;
  xn += lane * v_lane;
  sn += lane * v_lane;
  y += lane * v_lane;
  const int tid = threadIdx.x, warp = tid / 32, wl = tid % 32;
  const unsigned char* mask = masks + (size_t)lane * n;
  double* alpha = alphas + (size_t)lane * n;
  const double* f = fs + (size_t)lane * n;
  const double C = Cs[lane];
  const long long it = n_iter[lane], cap = it_caps[lane];

  double vu = INFINITY, vl = -INFINITY, au = 0.0, yu = 0.0, al = 0.0,
         yl = 0.0;
  int iu = INT_MAX, il = INT_MAX, fl = 0;
  for (int k0 = tid; k0 < n; k0 += kSelBatch * kSelThreads) {
    double a[kSelBatch], yk[kSelBatch], fk[kSelBatch];
    bool m[kSelBatch];
#pragma unroll
    for (int r = 0; r < kSelBatch; ++r) {
      const int k = k0 + r * kSelThreads;
      const bool in = k < n;
      a[r] = in ? alpha[k] : 0.0;
      yk[r] = in ? y[k] : 0.0;
      fk[r] = in ? f[k] : 0.0;
      m[r] = in && mask[k] != 0;
    }
#pragma unroll
    for (int r = 0; r < kSelBatch; ++r) {
      bool up, low;
      sets(a[r], yk[r], m[r], C, up, low);
      const double cu = up ? fk[r] : INFINITY, cl = low ? fk[r] : -INFINITY;
      const bool tu = (isnan(cu) & !isnan(vu)) | (cu < vu);
      const bool tl = (isnan(cl) & !isnan(vl)) | (cl > vl);
      const int k = k0 + r * kSelThreads;
      vu = tu ? cu : vu;
      iu = tu ? k : iu;
      au = tu ? a[r] : au;
      yu = tu ? yk[r] : yu;
      vl = tl ? cl : vl;
      il = tl ? k : il;
      al = tl ? a[r] : al;
      yl = tl ? yk[r] : yl;
      fl |= (up ? 1 : 0) | (low ? 2 : 0);
    }
  }
  // the warp's winners, to its slots
  unsigned long long ku = min_key(vu), kl = max_key(vl);
  const int wu = warp_least_row(ku, iu), wlo = warp_least_row(kl, il);
  fl = __reduce_or_sync(0xffffffffu, fl);
  if (wl == wu) up_s[warp] = {ku, vu, au, yu, iu};
  if (wl == wlo) low_s[warp] = {kl, vl, al, yl, il};
  if (wl == 0) flags_s[warp] = fl;
  __syncthreads();
  // every warp reduces the slots itself
  int flags = 0;
#pragma unroll
  for (int q = 0; q < kSelWarps; ++q) flags |= flags_s[q];
  const SelSlot su = up_s[least_slot(up_s, wl)];
  const SelSlot sl = low_s[least_slot(low_s, wl)];
  const double gap = flags == 3 ? sl.v - su.v : -INFINITY;
  if ((gap <= tol) || (it >= cap) || isnan(gap)) {
    if (tid == 0) done_flags[lane] = 1;
    return;
  }
  // i is in I_up and j in I_low here (gap > tol), so their candidates'
  // values are f_i and f_j
  const int i = su.row, j = sl.row;
  const double* xi = X + (size_t)i * d;
  const double* xj = X + (size_t)j * d;
  if (warp == 0) {  // the pair rows, then the chain
    double xnj = 0.0, sni = 0.0;
    if (wl == 0) {
      xnj = xn[j];
      sni = sn[i];
    }
    for (int e = wl; e < d; e += 32) {
      pair_s[e] = xi[e];
      pair_s[d + e] = xj[e];
    }
    __syncwarp();
    if (wl == 0) {
      double cross = 0.0;
#pragma unroll 8
      for (int k = 0; k < d; ++k)
        cross = fma(pair_s[d + k], pair_s[k], cross);
      double d2 = xnj + sni - 2.0 * cross;
      d2 = d2 < 0.0 ? 0.0 : d2;
      const double kij = exp(neg_gamma * d2);
      const double eta_ij = nan_max(1.0 + 1.0 - 2.0 * kij, kTau);  // diag = 1
      double new_i, new_j;
      deltas[lane] = pair_step(su.v, sl.v, su.a, sl.a, su.y, sl.y, i == j,
                               eta_ij, C, new_i, new_j);
      alpha[i] = clip(new_i, C);  // j after i: j == i keeps new_j
      alpha[j] = clip(new_j, C);
      n_iter[lane] = it + 1;
    }
  } else {  // the pair rows for the fused launch, beside the chain
    double* out = xij + (size_t)lane * 2 * d;
    for (int e = tid - 32; e < 2 * d; e += kSelThreads - 32)
      out[e] = e < d ? xi[e] : xj[e - d];
  }
  if (clip_all) {  // the other rows (clip is idempotent: write what moves)
    for (int k0 = tid; k0 < n; k0 += kSelBatch * kSelThreads) {
      double a[kSelBatch];
#pragma unroll
      for (int r = 0; r < kSelBatch; ++r) {
        const int k = k0 + r * kSelThreads;
        a[r] = k < n ? alpha[k] : 0.0;
      }
#pragma unroll
      for (int r = 0; r < kSelBatch; ++r) {
        const int k = k0 + r * kSelThreads;
        const double c = clip(a[r], C);
        if (k < n && k != i && k != j && !(c == a[r])) alpha[k] = c;
      }
    }
  }
  // end of the selection
}

int launch_select(const double* X, const double* xn, const double* sn,
                  const double* y, const unsigned char* masks,
                  const double* Cs, double tol, const long long* it_caps,
                  double gamma, double* alphas, const double* fs,
                  long long* n_iter, unsigned char* done, double* xij,
                  double* delta, int n, int d, int b, int clip_all,
                  long long x_lane, long long v_lane, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)d * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        smo_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  smo_select_kernel<<<b, kSelThreads, smem, stream>>>(
      X, xn, sn, y, masks, Cs, tol, it_caps, alphas, fs, n_iter, done, xij,
      delta, n, d, -gamma, clip_all, x_lane, v_lane);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// Persistent route: the streaming chunk in one cooperative launch.
// ------------------------------------------------------------------------

// A block's candidate for one lane's b_up (argmin) or b_low (argmax): the
// value (f at the row), the row (INT_MAX: none) and the OR of the slice's
// set flags; 16 bytes, one load for a reader.
struct __align__(16) Cand {
  double v;
  int i;
  int flags;
};

__device__ __forceinline__ void put_cand(Cand* c, double v, int i,
                                         int flags) {
  __stcg(reinterpret_cast<int4*>(c),
         make_int4(__double2loint(v), __double2hiint(v), i, flags));
}

// What the scalar step needs of a candidate's row beside its f: alpha, y
// and the norm (the table sn's); of b_low's (the WSS-1 j), xn too.
struct __align__(16) CandRow {
  double a, y, sn, xn;
};

__device__ __forceinline__ void put_row(CandRow* p, const CandRow& r) {
  __stcg(reinterpret_cast<double2*>(p), make_double2(r.a, r.y));
  __stcg(reinterpret_cast<double2*>(p) + 1, make_double2(r.sn, r.xn));
}

__device__ __forceinline__ CandRow get_row(const CandRow* p) {
  const double2 u = __ldcg(reinterpret_cast<const double2*>(p));
  const double2 v = __ldcg(reinterpret_cast<const double2*>(p) + 1);
  return {u.x, u.y, v.x, v.y};
}

// (value, index, block) reduction over the 16 threads of a group; the
// group's thread 0 ends with the best.
template <bool MAX>
__device__ __forceinline__ void group_best(double& v, int& i, int& p) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    const double ov = __shfl_down_sync(0xffffffffu, v, off, kGroup);
    const int oi = __shfl_down_sync(0xffffffffu, i, off, kGroup);
    const int op = __shfl_down_sync(0xffffffffu, p, off, kGroup);
    if (MAX ? better_max(ov, oi, v, i) : better_min(ov, oi, v, i)) {
      v = ov;
      i = oi;
      p = op;
    }
  }
}

// The same over the 8 threads of a warp that share lane % 4 (a lane
// slot's cells), every thread ending with the best.
template <bool MAX>
__device__ __forceinline__ void xor_best(double& v, int& i) {
#pragma unroll
  for (int mask = 4; mask < 32; mask <<= 1) {
    const double ov = __shfl_xor_sync(0xffffffffu, v, mask);
    const int oi = __shfl_xor_sync(0xffffffffu, i, mask);
    if (MAX ? better_max(ov, oi, v, i) : better_min(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ int xor_or(int x) {
#pragma unroll
  for (int mask = 4; mask < 32; mask <<= 1)
    x |= __shfl_xor_sync(0xffffffffu, x, mask);
  return x;
}

__device__ __forceinline__ int group_or(int x) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    x |= __shfl_down_sync(0xffffffffu, x, off, kGroup);
  return x;
}

// Workspace of the persistent route for `groups` groups of b lanes over m
// blocks each: the groups' barrier counters (16 bytes each), the
// candidates [groups][2 parities][b][2: up, low][m], then their rows'
// records [groups][2][b][2][m].
size_t stream_rows_offset(int b, int m, int groups = 1) {
  return 16 * (size_t)groups + (size_t)groups * 2 * b * 2 * m * sizeof(Cand);
}
size_t stream_workspace(int b, int m, int groups = 1) {
  return stream_rows_offset(b, m, groups) +
         (size_t)groups * 2 * b * 2 * m * sizeof(CandRow);
}

template <int RB>
__global__ void __launch_bounds__(kThreads, 1)
smo_stream_kernel(const double* __restrict__ X, const double* __restrict__ xn,
                  const double* __restrict__ sn, const double* __restrict__ y,
                  const unsigned char* __restrict__ masks,
                  const double* __restrict__ Cs, double tol,
                  const long long* __restrict__ it_caps, long long n_iters,
                  double neg_gamma, double* alphas, double* fs,
                  long long* n_iter, unsigned char* done_flags, int n, int d,
                  int ldx, int b, int slice, unsigned long long* counter,
                  Cand* cands, CandRow* cand_rows, long long x_lane,
                  long long v_lane, int groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int XS = x_stride<double>(), TILE = tile_rows<RB>();
  const int pst = pair_stride(d);
  double* ring = reinterpret_cast<double*>(smem_raw);
  double* ps = ring + kStages * TILE * XS;
  double* f_s = ps + pairs_bytes(d, b, 8) / 8;   // [b][slice]
  double* a_s = f_s + (size_t)b * slice;         // [b][slice]
  double* y_s = a_s + (size_t)b * slice;         // [slice]
  double* xn_s = y_s + slice;                    // [slice]
  double* pn_s = xn_s + slice;                   // [slice]
  unsigned char* m_s = reinterpret_cast<unsigned char*>(pn_s + slice);
  // per lane: C, cap, n_iter, done, and this iteration's pick
  __shared__ double l_C[kLanes], l_fi[kLanes], l_fj[kLanes];
  __shared__ CandRow l_ri[kLanes], l_rj[kLanes];
  __shared__ long long l_it[kLanes], l_cap[kLanes];
  __shared__ int l_done[kLanes], l_i[kLanes], l_j[kLanes];
  // per slot (the live lanes in order): lane, pair, C, delta, pair norms
  __shared__ int s_lane[kLanes], s_i[kLanes], s_j[kLanes];
  __shared__ double s_C[kLanes], s_delta[kLanes], s_sni[kLanes],
      s_snj[kLanes];
  __shared__ int s_live;
  // per lane: this block's candidates, to publish; and each compute
  // warp's, on the way
  __shared__ double p_vu[kLanes], p_vl[kLanes];
  __shared__ CandRow p_ru[kLanes], p_rl[kLanes];
  __shared__ int p_iu[kLanes], p_il[kLanes], p_fg[kLanes];
  __shared__ double w_vu[kWarps][kLanes], w_vl[kWarps][kLanes];
  __shared__ int w_iu[kWarps][kLanes], w_il[kWarps][kLanes],
      w_fg[kWarps][kLanes];

  // the grid is `groups` independent launches of m blocks over b lanes
  // each (groups > 1: a lane a group, over its own X); group grp's lanes,
  // operands, barrier counter and candidates
  const int tid = threadIdx.x, m = gridDim.x / groups;
  const int grp = blockIdx.x / m, blk = blockIdx.x % m;
  X += grp * x_lane;
  xn += grp * v_lane;
  sn += grp * v_lane;
  y += grp * v_lane;
  masks += (size_t)grp * b * n;
  alphas += (size_t)grp * b * n;
  fs += (size_t)grp * b * n;
  Cs += grp * b;
  it_caps += grp * b;
  n_iter += grp * b;
  done_flags += grp * b;
  counter += 2 * grp;
  cands += (size_t)grp * 4 * b * m;
  cand_rows += (size_t)grp * 4 * b * m;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;  // row and lane in a tile's cell
  const int lo = blk * slice, cnt = min(n - lo, slice);  // >= 1 (the plan)
  const int g = tid / kGroup, gl = tid % kGroup;
  const int gl_lane = min(g, b - 1);  // groups past b mirror the last lane

  for (int l = 0; l < b; ++l)
    for (int k = tid; k < cnt; k += kThreads) {
      const size_t o = (size_t)l * n + lo + k, q = (size_t)l * slice + k;
      f_s[q] = fs[o];
      a_s[q] = alphas[o];
      m_s[q] = masks[o];
    }
  for (int k = tid; k < cnt; k += kThreads) {
    y_s[k] = y[lo + k];
    xn_s[k] = xn[lo + k];
    pn_s[k] = sn[lo + k];
  }
  if (tid < b) {
    l_C[tid] = Cs[tid];
    l_cap[tid] = it_caps[tid];
    l_it[tid] = n_iter[tid];
    l_done[tid] = done_flags[tid] != 0;
  }

  // the slice's slabs, in the same order every iteration
  const int nslabs = (d + kSlab - 1) / kSlab;
  const int ntiles = (cnt + TILE - 1) / TILE;
  const int period = ntiles * nslabs;
  auto issue = [&](long long q) {
    const int qq = (int)(q % period);
    const int row0 = lo + (qq / nslabs) * TILE, k0 = (qq % nslabs) * kSlab;
    stage_slab<double, 2, TILE>(ring + (int)(q % kStages) * TILE * XS, X,
                                ldx, row0, min(TILE, lo + cnt - row0), k0,
                                min(kSlab, d - k0));
  };
  long long q = 0;  // the next slab to use
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  __syncthreads();

  // lane l's candidate row (in the slice, or INT_MAX: none) as published
  auto row_record = [&](int l, int row) {
    CandRow r = {0.0, 0.0, 0.0, 0.0};
    if (row != INT_MAX) {
      const int k = row - lo;
      r = {a_s[(size_t)l * slice + k], y_s[k], pn_s[k], xn_s[k]};
    }
    return r;
  };

  // The first selection: each group of 16 threads scans the slice for one
  // lane's candidates (later ones come out of the f-update, cell by cell).
  auto scan = [&]() {
    const int l = gl_lane;
    const double C = l_C[l];
    const double* fl = f_s + (size_t)l * slice;
    const double* al = a_s + (size_t)l * slice;
    const unsigned char* ml = m_s + (size_t)l * slice;
    double vu = INFINITY, vl = -INFINITY;
    int iu = INT_MAX, il = INT_MAX, fg = 0, pu = 0, pl = 0;
    for (int k = gl; k < cnt; k += kGroup) {
      bool up, low;
      sets(al[k], y_s[k], ml[k] != 0, C, up, low);
      const double fk = fl[k];
      const double cu = up ? fk : INFINITY, cl = low ? fk : -INFINITY;
      if (better_min(cu, lo + k, vu, iu)) { vu = cu; iu = lo + k; }
      if (better_max(cl, lo + k, vl, il)) { vl = cl; il = lo + k; }
      fg |= (up ? 1 : 0) | (low ? 2 : 0);
    }
    group_best<false>(vu, iu, pu);
    group_best<true>(vl, il, pl);
    fg = group_or(fg);
    if (gl == 0 && g < b) {
      p_vu[g] = vu;
      p_vl[g] = vl;
      p_iu[g] = iu;
      p_il[g] = il;
      p_fg[g] = fg;
      p_ru[g] = row_record(g, iu);
      p_rl[g] = row_record(g, il);
    }
  };

  // The threads l < b store this block's candidates of live lane l for
  // iteration parity `set`; thread 0's arrival at the barrier (a release,
  // after the block's barrier) then orders them before the other blocks
  // read.
  auto store = [&](int set) {
    __syncthreads();
    if (tid < b && !l_done[tid]) {
      const int l = tid;
      Cand* c = cands + (size_t)(set * b + l) * 2 * m;
      put_cand(c + blk, p_vu[l], p_iu[l], p_fg[l]);
      put_cand(c + m + blk, p_vl[l], p_il[l], p_fg[l]);
      CandRow* r = cand_rows + ((size_t)(set * b + l) * 2) * m;
      put_row(r + blk, p_ru[l]);
      put_row(r + m + blk, p_rl[l]);
    }
  };

  // Each group reduces one lane's candidates from every block (the same
  // in every block), then tests the lane's stop or records its pick.
  auto reduce = [&](int set) {
    const int l = gl_lane;
    const Cand* cu = cands + (size_t)(set * b + l) * 2 * m;
    const Cand* cl = cu + m;
    double vu = INFINITY, vl = -INFINITY;
    int iu = INT_MAX, il = INT_MAX, pu = 0, pl = 0, fg = 0;
    if (!l_done[l]) {
#pragma unroll 4
      for (int p0 = gl; p0 < m; p0 += kGroup) {
        // every block reads every block's keys: each starts at its own
        const int p = (p0 + blk) % m;
        const int4 ku = __ldcg(reinterpret_cast<const int4*>(cu + p));
        const int4 kl = __ldcg(reinterpret_cast<const int4*>(cl + p));
        const double v = __hiloint2double(ku.y, ku.x);
        fg |= ku.w;
        if (better_min(v, ku.z, vu, iu)) { vu = v; iu = ku.z; pu = p; }
        const double w = __hiloint2double(kl.y, kl.x);
        if (better_max(w, kl.z, vl, il)) { vl = w; il = kl.z; pl = p; }
      }
    }
    group_best<false>(vu, iu, pu);
    group_best<true>(vl, il, pl);
    fg = group_or(fg);
    if (gl == 0 && g < b && !l_done[g]) {
      const double gap = fg == 3 ? vl - vu : -INFINITY;
      if ((gap <= tol) || (l_it[g] >= l_cap[g]) || isnan(gap)) {
        l_done[g] = 1;
      } else {
        const CandRow* r = cand_rows + ((size_t)(set * b + g) * 2) * m;
        l_i[g] = iu;
        l_j[g] = il;
        l_fi[g] = vu;  // f_i: i is in I_up, so its candidate value is f
        l_fj[g] = vl;
        l_ri[g] = get_row(r + pu);
        l_rj[g] = get_row(r + m + pl);
      }
    }
  };

  scan();
  store(0);
  bool clip_all = true;
  for (long long t = 0; t < n_iters; ++t) {
    const int set = (int)(t & 1);
    lane_barrier(counter, (unsigned long long)(t + 1) * m);
    reduce(set);
    __syncthreads();
    if (tid == 0) {
      int G = 0;
      for (int l = 0; l < b; ++l)
        if (!l_done[l]) {
          s_lane[G] = l;
          s_i[G] = l_i[l];
          s_j[G] = l_j[l];
          s_C[G] = l_C[l];
          s_sni[G] = l_ri[l].sn;
          s_snj[G] = l_rj[l].sn;
          ++G;
        }
      s_live = G;
    }
    __syncthreads();
    const int G = s_live;
    if (G == 0) break;  // uniform: every block reduced the same picks
    stage_pairs(ps, d, G, [&](int w) {
      return X + (size_t)((w & 1) ? s_j[w >> 1] : s_i[w >> 1]) * ldx;
    });
    cp_async_wait_all();
    __syncthreads();
    // row pass; the side warp meanwhile sums K[i, j]'s cross product slab
    // by slab (in order of k, as smo_select_kernel does) and, after the
    // first tile's dot products, takes smo_select_kernel's scalar step
    const int nvb = (G + 3) / 4;
    double cross = 0.0;  // the side warp: slot `lane`'s x_j . x_i
    // this thread's candidates over its cells of the new state, per lane
    // block: the scan's (value, row) pairs, without a second pass
    double cvu[kVB], cvl[kVB];
    int ciu[kVB], cil[kVB], cfg[kVB];
#pragma unroll
    for (int vb = 0; vb < kVB; ++vb) {
      cvu[vb] = INFINITY;
      cvl[vb] = -INFINITY;
      ciu[vb] = cil[vb] = INT_MAX;
      cfg[vb] = 0;
    }
    for (int tile = 0; tile < ntiles; ++tile) {
      double acc[RB][kVB][2];
      zero_acc(acc);
      for (int ks = 0; ks < nslabs; ++ks, ++q) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        issue(q + kStages - 1);
        const int k0 = ks * kSlab, kw = min(kSlab, d - k0);
        if (warp < kWarps) {
          tile_dots<double, RB>(ring + (int)(q % kStages) * TILE * XS, ps,
                                pst, k0, kw, nvb, warp, lane, acc);
        } else if (tile == 0 && lane < G) {
          const double* xi = ps + (size_t)2 * lane * pst;
          const double* xj = xi + pst;
          for (int k = k0; k < k0 + kw; ++k) cross = fma(xj[k], xi[k], cross);
        }
      }
      // the cells' K, over their dot products: they need only the norms,
      // so the compute warps take their exps (no branches between the
      // cells, so that they overlap; a cell past the slice or the live
      // lanes computes a value nobody reads) while the side warp takes the
      // scalar step
      const bool rows_here =
          warp < kWarps && tile * TILE + warp * 8 * RB < cnt;
      if (rows_here) {
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          const double xr2 =
              xn_s[min(tile * TILE + warp * 8 * RB + rb * 8 + gq, cnt - 1)];
#pragma unroll
          for (int vb = 0; vb < kVB; ++vb) {
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
      if (tile == 0) {
        if (warp == kSideWarp && lane < G) {
          const int l = s_lane[lane], i = s_i[lane], j = s_j[lane];
          const CandRow ri = l_ri[l], rj = l_rj[l];
          double d2 = rj.xn + ri.sn - 2.0 * cross;
          d2 = d2 < 0.0 ? 0.0 : d2;
          const double kij = exp(neg_gamma * d2);
          const double eta_ij = nan_max(1.0 + 1.0 - 2.0 * kij, kTau);
          double new_i, new_j;
          s_delta[lane] = pair_step(l_fi[l], l_fj[l], ri.a, rj.a, ri.y, rj.y,
                                    i == j, eta_ij, s_C[lane], new_i, new_j);
          if (i >= lo && i < lo + cnt) a_s[(size_t)l * slice + i - lo] = new_i;
          if (j >= lo && j < lo + cnt) a_s[(size_t)l * slice + j - lo] = new_j;
          l_it[l] += 1;
        }
        __syncthreads();  // delta and the owners' alphas, before the f-update
      }
      if (!rows_here) continue;
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const int kr = tile * TILE + warp * 8 * RB + rb * 8 + gq;
        if (kr >= cnt) continue;
        const int row = lo + kr;
#pragma unroll
        for (int vb = 0; vb < kVB; ++vb) {
          const int s = vb * 4 + tq;
          if (vb >= nvb || s >= G) continue;
          const size_t o = (size_t)s_lane[s] * slice + kr;
          const double fk = smo_f_update_elem(f_s[o], acc[rb][vb][0],
                                              acc[rb][vb][1], s_delta[s]);
          f_s[o] = fk;
          double ak = a_s[o];
          if (clip_all || row == s_i[s] || row == s_j[s]) {
            ak = clip(ak, s_C[s]);
            a_s[o] = ak;
          }
          bool up, low;
          sets(ak, y_s[kr], m_s[o] != 0, s_C[s], up, low);
          const double cu = up ? fk : INFINITY, cl = low ? fk : -INFINITY;
          if (better_min(cu, row, cvu[vb], ciu[vb])) {
            cvu[vb] = cu;
            ciu[vb] = row;
          }
          if (better_max(cl, row, cvl[vb], cil[vb])) {
            cvl[vb] = cl;
            cil[vb] = row;
          }
          cfg[vb] |= (up ? 1 : 0) | (low ? 2 : 0);
        }
      }
    }
    clip_all = false;
    if (t + 1 == n_iters) break;
    // the next selection: over the 8 threads of a warp that share a lane,
    // then over the warps
    if (warp < kWarps) {
#pragma unroll
      for (int vb = 0; vb < kVB; ++vb) {
        if (vb >= nvb) continue;  // uniform
        xor_best<false>(cvu[vb], ciu[vb]);
        xor_best<true>(cvl[vb], cil[vb]);
        cfg[vb] = xor_or(cfg[vb]);
        const int s = vb * 4 + tq;
        if (gq == 0 && s < G) {
          w_vu[warp][s] = cvu[vb];
          w_vl[warp][s] = cvl[vb];
          w_iu[warp][s] = ciu[vb];
          w_il[warp][s] = cil[vb];
          w_fg[warp][s] = cfg[vb];
        }
      }
    }
    __syncthreads();
    if (tid < G) {
      double vu = INFINITY, vl = -INFINITY;
      int iu = INT_MAX, il = INT_MAX, fg = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (better_min(w_vu[w][tid], w_iu[w][tid], vu, iu)) {
          vu = w_vu[w][tid];
          iu = w_iu[w][tid];
        }
        if (better_max(w_vl[w][tid], w_il[w][tid], vl, il)) {
          vl = w_vl[w][tid];
          il = w_il[w][tid];
        }
        fg |= w_fg[w][tid];
      }
      const int l = s_lane[tid];
      p_vu[l] = vu;
      p_vl[l] = vl;
      p_iu[l] = iu;
      p_il[l] = il;
      p_fg[l] = fg;
      p_ru[l] = row_record(l, iu);
      p_rl[l] = row_record(l, il);
    }
    store(set ^ 1);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int l = 0; l < b; ++l)
    for (int k = tid; k < cnt; k += kThreads) {
      const size_t o = (size_t)l * n + lo + k, q2 = (size_t)l * slice + k;
      fs[o] = f_s[q2];
      alphas[o] = a_s[q2];
    }
  if (blk == 0 && tid < b) {
    n_iter[tid] = l_it[tid];
    done_flags[tid] = l_done[tid] ? 1 : 0;
  }
}

// The persistent route's row blocks a warp for slices of `slice` rows: 4
// (tiles of 256 rows) or, for at most 128 rows, 2 (one tile of 128: a
// thread's f-update has half the cells, and so half the serial exps).
int stream_rb(int slice) { return slice <= tile_rows<2>() ? 2 : 4; }

// Dynamic shared memory of the persistent route for slices of `slice`
// rows: the ring, the pair rows of b lanes, and the lanes' f, alpha and
// mask, y and the two norms at the slice.
size_t stream_smem(int slice, int d, int b) {
  const size_t ring = stream_rb(slice) == 2 ? ring_bytes<double, 128>()
                                            : ring_bytes<double, 256>();
  const size_t bytes = ring + pairs_bytes(d, b, 8) +
                       (size_t)slice * (16 * (size_t)b + 24 + b);
  return (bytes + 15) & ~(size_t)15;
}

// The kernel for slices of `slice` rows.
const void* stream_kernel(int slice) {
  return stream_rb(slice) == 2 ? (const void*)smo_stream_kernel<2>
                               : (const void*)smo_stream_kernel<4>;
}

// The persistent route's blocks and slice for b lanes over n rows of d
// features: about 128 rows a block (a row pass's chains are as long at
// any slice, its exps and f-updates shorter on fewer rows; n = 32,560
// takes every SM), all blocks resident at once, the
// slice's state, the ring and the pair rows in one block's shared memory.
// m = 0 when it cannot place them (more than 16 lanes, or too little
// shared memory), and the wrapper takes the pair route.
//
// `groups` such launches side by side (a lane a group, b = 1: lanes with
// their own X) take m blocks each: all groups' blocks resident at once.
int stream_plan(int n, int d, int b, int& m, int& slice, int groups = 1) {
  m = slice = 0;
  if (n < 1 || d < 1 || b < 1 || b > kLanes || groups < 1) return 0;
  int sms = 0, optin = 0;
  cudaError_t e = card(sms, optin);
  if (e != cudaSuccess) return (int)e;
  int want = (n + kBlockRows - 1) / kBlockRows;
  for (int tries = 0; tries < 4 && want >= 1; ++tries) {
    const int s = (n + want - 1) / want;
    const int mm = (n + s - 1) / s;  // every block gets rows
    const void* kernel = stream_kernel(s);
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    const size_t smem = stream_smem(s, d, b);
    if (smem + attr.sharedSizeBytes > (size_t)optin) return 0;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    int per_sm = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if ((long long)per_sm * sms >= (long long)mm * groups) {
      m = mm;
      slice = s;
      return 0;
    }
    want = per_sm * sms / groups;  // fewer, larger slices
  }
  return 0;
}

}  // namespace

// f (b, n) updated in place; xij (b, 2, d); delta (b,); done (b,) or null.
extern "C" int fused_smo_step_f64(double* f, const double* X,
                                  const double* xn, const double* xij,
                                  const double* delta,
                                  const unsigned char* done, int n, int d,
                                  int b, double gamma, cudaStream_t stream) {
  return launch_fused<double>(f, X, xn, xij, delta, done, n, d, b, gamma, 0,
                              0, stream);
}

extern "C" int fused_smo_step_f32(float* f, const float* X, const float* xn,
                                  const float* xij, const float* delta,
                                  const unsigned char* done, int n, int d,
                                  int b, double gamma, cudaStream_t stream) {
  return launch_fused<float>(f, X, xn, xij, delta, done, n, d, b, gamma, 0,
                             0, stream);
}

// One selection step over b lanes: alphas, n_iter and done updated in
// place; the pair rows and delta of each lane that steps written to xij
// (b, 2, d) and delta (b,). sn (n,) holds each row's |x|^2 summed in order
// of k, op by op; clip_all 1 clips the whole of alpha (a chunk's first
// step, and the plain step's every step), 0 the pair's two alone.
extern "C" int smo_select_f64(const double* X, const double* xn,
                              const double* sn, const double* y,
                              const unsigned char* masks, const double* Cs,
                              double tol, const long long* it_caps,
                              double gamma, double* alphas, const double* fs,
                              long long* n_iter, unsigned char* done,
                              double* xij, double* delta, int n, int d, int b,
                              int clip_all, cudaStream_t stream) {
  if (n <= 0 || b <= 0) return (int)cudaGetLastError();
  return launch_select(X, xn, sn, y, masks, Cs, tol, it_caps, gamma, alphas,
                       fs, n_iter, done, xij, delta, n, d, b, clip_all, 0, 0,
                       stream);
}

// Up to n_iters streaming WSS-1 iterations over b lanes of one X: each is one
// selection launch (one block per lane) and one fused launch over all lanes.
// masks, alphas, fs (b, n); Cs, it_caps, n_iter, done (b,); sn (n,) as for
// smo_select_f64; xij (b, 2, d) and delta (b,) are scratch. *issued gets the
// number of iterations launched. Lane l reads its X (n, d) at X + l * x_lane
// and its xn, sn and y at l * v_lane (elements; 0: one X for every lane).
//
// Like the reference's any(~done) loop, the chunk stops once every lane is
// done, without draining the stream: every kPoll iterations the done flags
// are copied to pinned host memory behind an event, and the host reads the
// copy made kPoll iterations earlier, so at most 2 kPoll no-op iterations
// are launched past the last lane's stop while kPoll stay queued. A stream
// being captured into a graph launches all n_iters.
extern "C" int smo_stream_chunk_f64(
    const double* X, const double* xn, const double* sn, const double* y,
    const unsigned char* masks, const double* Cs, double tol,
    const long long* it_caps, long long n_iters, double gamma, double* alphas,
    double* fs, long long* n_iter, unsigned char* done, double* xij,
    double* delta, int n, int d, int b, long long x_lane, long long v_lane,
    cudaStream_t stream, long long* issued) {
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
    err = launch_select(X, xn, sn, y, masks, Cs, tol, it_caps, gamma, alphas,
                        fs, n_iter, done, xij, delta, n, d, b, t == 0 ? 1 : 0,
                        x_lane, v_lane, stream);
    if (!err)
      err = launch_fused<double>(fs, X, xn, xij, delta, done, n, d, b, gamma,
                                 x_lane, v_lane, stream);
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

// The persistent route's plan for `groups` groups of b lanes over n rows of
// d features (groups > 1: b = 1, a lane a group over its own X): m blocks
// of `slice` rows a group (m = 0: the route cannot place them), and the
// bytes of the workspace the launch needs, whose first 16 a group it needs
// zeroed.
extern "C" int smo_stream_plan(int n, int d, int b, int groups, int* m,
                               int* slice, long long* workspace_bytes) {
  const int e = stream_plan(n, d, b, *m, *slice, groups);
  *workspace_bytes =
      *m > 0 ? (long long)stream_workspace(b, *m, groups) : 0;
  return e;
}

// As smo_stream_chunk_f64, in one cooperative launch of smo_stream_plan's
// m blocks of `slice` rows for each of `groups` groups of b lanes
// (cudaLaunchKernelExC with the cooperative attribute, which stream capture
// takes into a CUDA graph): it fails rather than start blocks that cannot
// all be resident. X's rows are ldx apart, an even stride on 16-byte
// boundaries (a zero column past an odd d), for 16-byte copies. sn (n,) is
// smo_select_f64's table. `workspace` holds smo_stream_plan's bytes, the
// first 16 a group zeroed. Group g runs lanes g b .. g b + b - 1 over the X
// at X + g * x_lane (an even stride) and the xn, sn and y at g * v_lane
// (0: one X for every group); every group has its own barrier counter and
// candidates, so a group is bitwise its own one-group launch.
extern "C" int smo_stream_persistent_f64(
    const double* X, const double* xn, const double* sn, const double* y,
    const unsigned char* masks, const double* Cs, double tol,
    const long long* it_caps, long long n_iters, double gamma, double* alphas,
    double* fs, long long* n_iter, unsigned char* done, int n, int d,
    int ldx, int b, int m, int slice, void* workspace, long long x_lane,
    long long v_lane, int groups, cudaStream_t stream) {
  if (n <= 0 || b <= 0 || n_iters <= 0) return (int)cudaGetLastError();
  if (ldx < d + (d & 1) || ldx % 2 != 0 || x_lane % 2 != 0 ||
      reinterpret_cast<uintptr_t>(X) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = stream_smem(slice, d, b);
  const void* kernel = stream_kernel(slice);
  const cudaError_t a = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (a != cudaSuccess) return (int)a;
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  unsigned long long* counter = reinterpret_cast<unsigned long long*>(ws);
  Cand* cands = reinterpret_cast<Cand*>(ws + 16 * (size_t)groups);
  CandRow* cand_rows =
      reinterpret_cast<CandRow*>(ws + stream_rows_offset(b, m, groups));
  const double neg_gamma = -gamma;
  void* args[] = {&X,       &xn,     &sn,     &y,      &masks,
                  &Cs,      &tol,    &it_caps, &n_iters,
                  const_cast<double*>(&neg_gamma), &alphas, &fs, &n_iter,
                  &done,    &n,      &d,      &ldx,    &b,
                  &slice,   &counter, &cands, &cand_rows,
                  &x_lane,  &v_lane, &groups};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m * groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelExC(&cfg, kernel, args);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
