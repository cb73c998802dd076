// Causal / sliding-window flash attention, forward, with grouped kv heads:
//   o[b, h, s] = sum_t softmax_t(q[b, h, s] . k[b, hk, t] * scale) v[b, hk, t]
// over the keys t that the mask lets q row s see (t < T; t <= s if causal;
// t > s - window if windowed), hk = h / (H / KV), scale = 1 / sqrt(DQK).
// float32 and bfloat16. q and k have head dim DQK, v and o head dim DV:
// the pairs built are (D, D) and, for DeepSeek's MLA prefill (q and k are
// 128 nope + 64 rope columns, v 128), (192, 128) on the wgmma and float32
// routes.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel). It computes what that kernel computes,
// not how: the TPU grid walks (B*H, S/bq, T/bk) in order and carries m, l
// and the accumulator in VMEM from one kv step to the next; here one block
// owns a (b, h, q tile) and runs the kv loop itself, with the running
// max m, normaliser l and accumulator in registers, all float32, and
// out = acc / max(l, 1e-30). Scores are q.k in float32 times the scale, the
// mask writes -1e30, the probabilities are rounded to the input dtype before
// the product with v (the TPU kernel's p.astype(v.dtype)); l sums them
// unrounded.
//
// Three routes, picked by the wrapper (kernels/flash_attention.py::route):
// * bf16, D = 64, 128, 256 and (DQK, DV) = (192, 128): FlashAttention-3's
//   shape on wgmma + TMA
//   (namespace wg below): a producer warp keeps a ring of K/V tiles full
//   through TMA and mbarriers, two consumer warpgroups of 64 q rows each
//   run S = Q K^T and O += P V on wgmma; 128 q rows per block.
// * bf16, D = 16 and 32 (the SMOKE configs and the reference's sweep):
//   mma.sync m16n8k16 (namespace mma_route), where the exps, not the
//   FLOPs, set the floor: 128 q rows a block (4 warps of 32), kv tiles of
//   128 keys in a three-stage cp.async ring, one FFMA and one ex2 a score,
//   the mask only on the tiles that cross it. wgmma's depth is 16 and a
//   tile's
//   128-byte swizzled panel is 64 columns, so a head narrower than a panel
//   gains nothing from the wgmma route.
// * float32: FMA on the CUDA cores (tensor cores would round to TF32):
//   thread (rg, cg) owns 4 rows, 8 keys of a tile and D / 8 output columns,
//   the probabilities go through shared memory (flash_fwd_kernel).
// kv tiles wholly above the diagonal (causal) or wholly before the window
// are never visited; blocks are launched longest causal tile first.
//
// Layout: q, k, v and o are read and written through their (b, h, s)
// strides with d contiguous, so the model's (B, S, H, D) activations need
// no transposed copy (the wrapper checks 16-byte alignment of every row).
//
// Bound: operations. 4 D FLOPs per (query, visible key) pair and head
// against the bytes of q, k, v and o once; at granite-8b's prefill shape
// (B=2, H=32, KV=8, S=4096, D=128, causal) 2.75e11 FLOP, 0.278 ms at the
// card's 989 TFLOP/s dense bf16, against 0.034 ms for its 113 MB. Only
// wgmma reaches that rate on Hopper, so the bf16 route for the model's
// head dims is built around it: operands straight from TMA-written
// shared memory, no thread spends an instruction on a copy, and the mask
// and exp2 work per score is one compare-free fma on interior tiles. At
// D = 16 and 32 the exps bound it instead: one ex2 a score on the SFU, 16 a
// clock an SM, is 0.128 ms for granite's shape at D = 32 (5.37e8 exps, 132
// SMs at 1,980 MHz), above its 0.0695 ms of FLOPs.
#include <cstdint>

#include <cuda.h>   // CUtensorMap and its enums; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int NT = 128;       // threads per block
constexpr int RPT = 4;        // q rows per thread
constexpr int CG = 8;         // column groups (threads per row group)
constexpr int PP = BK + 1;    // row pitch of the probability tile (floats)
constexpr float NEG = -1e30f;

struct Strides {              // element strides of (b, h, s); d is contiguous
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// ------------------------------------------------------------- float32 ----
// Stage rows r0 .. r0 + 63 of a (n, D) slab (row stride rs elements) into
// shared memory with row pitch D + 1; rows past n become zeros. Each thread
// moves 16 bytes at a time.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long rs, int r0, int n) {
  constexpr int PER_ROW = D / 4;
  for (int e = threadIdx.x; e < BK * PER_ROW; e += NT) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < n)
      x = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * rs + c);
    float* d = dst + r * (D + 1) + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// The FMA route's shared memory at (DQK, DV): the q tile, one K or V tile
// (pitch of the wider), the probability tile
template <int DQK, int DV>
constexpr int f32_smem() {
  return (int)sizeof(float) *
         (BQ * (DQK + 1) + BK * ((DQK > DV ? DQK : DV) + 1) + BQ * PP);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int G, int S, int Tk, Strides st, float scale, int causal,
                 int window) {
  constexpr int PQ = DQK + 1;  // row pitch of the q and K tiles (floats)
  constexpr int PV = DV + 1;   // row pitch of the V tile
  constexpr int DC = DV / CG;  // output columns per thread
  extern __shared__ float smem[];
  float* qt = smem;                 // BQ x PQ
  float* kv = smem + BQ * PQ;       // the K tile (BK x PQ), then V (BK x PV)
  float* pt = kv + BK * (PQ > PV ? PQ : PV);  // BQ x PP: probabilities

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / G;
  const int rg = threadIdx.x / CG, cg = threadIdx.x % CG;
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + hk * st.kh;
  const float* vp = v + b * st.vb + hk * st.vh;

  load_tile<DQK>(qt, qp, st.qs, q0, S);

  float m[RPT], l[RPT], acc[RPT][DC];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = NEG;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.0f;
  }

  int kv_hi = Tk, kv_lo = 0;
  if (causal) kv_hi = min(Tk, q0 + BQ);
  if (window > 0) kv_lo = max(0, q0 - window + 1) / BK * BK;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();  // q staged; the last tile's P and V no longer read
    load_tile<DQK>(kv, kp, st.ks, k0, Tk);
    __syncthreads();

    float s[RPT][CG];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < CG; ++j) s[r][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
      float qa[RPT], kb[CG];
#pragma unroll
      for (int r = 0; r < RPT; ++r) qa[r] = qt[(rg * RPT + r) * PQ + d];
#pragma unroll
      for (int j = 0; j < CG; ++j) kb[j] = kv[(cg + CG * j) * PQ + d];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < CG; ++j) s[r][j] = fmaf(qa[r], kb[j], s[r][j]);
    }

    // mask, then the online softmax of each row over this tile
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int qpos = q0 + rg * RPT + r;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        const int kpos = k0 + cg + CG * j;
        const bool ok = kpos < Tk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[r][j] = ok ? s[r][j] * scale : NEG;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int w = 1; w < CG; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        s[r][j] = expf(s[r][j] - m_new);
        sum += s[r][j];
      }
#pragma unroll
      for (int w = 1; w < CG; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }

    __syncthreads();  // every thread is done with the K tile
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < CG; ++j) pt[(rg * RPT + r) * PP + cg + CG * j] = s[r][j];
    load_tile<DV>(kv, vp, st.vs, k0, Tk);
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float pa[RPT], vb[DC];
#pragma unroll
      for (int r = 0; r < RPT; ++r) pa[r] = pt[(rg * RPT + r) * PP + t];
#pragma unroll
      for (int c = 0; c < DC; ++c) vb[c] = kv[t * PV + cg + CG * c];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pa[r], vb[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = q0 + rg * RPT + r;
    if (row >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* orow = o + b * st.ob + h * st.oh + (long long)row * st.os;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[cg + CG * c] = acc[r][c] / den;
  }
}

// ---------------------------------------------------------------- bf16 ----
// bf16 on mma.sync m16n8k16 (bf16 operands, float32 accumulators): the
// route of head dims 16 and 32, which `_route="mma"` also runs at 64, 128
// and 256. At D = 32 a score costs 128 tensor-core FLOPs and one exp: at
// the card's dense bf16 rate the FLOPs take less time than the exps on
// the SFU (16 a clock an SM), so the exps set the floor, and the design
// spends as little as it can beside each exp:
// * p = 2^(s c - m c) with c = scale * log2(e): one FFMA and one
//   ex2.approx a score; m and l live in that domain; a row's max and sum
//   over a tile are trees, not chains;
// * the mask's compares run only on the tiles that cross T, the diagonal
//   or the window's edge, per warp; every other tile takes none;
// * 128 q rows a block and, at D <= 32, kv tiles of 128 keys, so one
//   barrier is paid per 128 keys; a ring of STAGES K/V tiles staged by
//   cp.async, the copies of the tiles ahead in flight while one is
//   computed;
// * l sums the unrounded p per thread, across the row's four threads once
//   after the loop; p is rounded to bf16 in registers as the A operand of
//   P V, as the plain version rounds probs.to(q.dtype).
// mma.sync runs at well under wgmma's rate on Hopper, and a warp's
// tensor-core work and its exps alternate, so the route stays above its
// exp floor (PERF.md). q (in registers at D <= 64), K and V are bf16 rows
// of pitch D + 8 in shared memory (conflict-free ldmatrix), fragments
// loaded by ldmatrix (transposed for V, whose rows are keys).
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// 2^x on the SFU in one instruction (exp2f adds range handling for
// subnormal results, which the softmax flushes to 0 anyway)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The offset a tile's p are taken against (p = 2^(x c - mc)): mx c rounded
// once, by __fmul_rn so that nvcc contracts it into no fma (0 for a row
// that has seen only masked keys).
__device__ __forceinline__ float offset(float mx, float c) {
  return mx == NEG ? 0.0f : __fmul_rn(mx, c);
}

// The factor a row's running sums take when a tile moves its max from m to
// mx: 2^(the earlier tiles' offset - this tile's), the difference of the
// two offsets as rounded, so exactly 1 while the max holds. (2^(m c - mc)
// by one fma is 2^(m c's rounding residual) there, a factor that
// compounded tile by tile to 2% over 32k keys of scores in the thousands;
// and each move of the max carried it.) 0 for a row that had seen only
// masked keys, whose sums are 0.
__device__ __forceinline__ float rescale(float m, float mc, float c) {
  return ex2_ftz(__fmul_rn(m, c) - mc);
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b for one 16 x 8 x 16 tile (a row-major, b column-major)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

namespace mma_route {

// The block shape at head dim D: warps, 16-row m-tiles a warp, keys a kv
// tile, K/V ring stages, and the blocks an SM its registers are bounded
// for. At D <= 32, 4 warps of 32 rows (each K and V fragment feeds two
// m-tiles) and kv tiles of 128 keys: the fastest of the shapes
// chip_flash_shapes.py times on the card (8 warps of 16 rows, tiles of 64
// keys, 2 or 4 stages, one block an SM). The head dims of the wgmma route
// keep 8 warps of 16 rows.
template <int D>
struct Cfg {
  static constexpr int NW = D <= 32 ? 4 : 8;           // warps a block
  static constexpr int MT = D <= 32 ? 2 : 1;           // m-tiles a warp
  static constexpr int BK = D <= 32 ? 128 : 64;        // keys per kv tile
  static constexpr int STAGES = D == 256 ? 2 : 3;      // K/V ring depth
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;   // registers
  static constexpr int NT = 32 * NW;                   // threads a block
  static constexpr int BQ = 16 * MT * NW;              // q rows a block
  static constexpr int PQ = D + 8;                     // bf16 row pitch
  static constexpr int TILE = BK * PQ;                 // one K or V tile
  static constexpr int SMEM = 2 * (BQ * PQ + 2 * STAGES * TILE);
};

// Issue the copies of rows r0 .. r0 + ROWS - 1 of a (n, D) bf16 slab into
// shared memory (row pitch D + 8), 16 bytes each, by the block's NT
// threads; rows past n are zero-filled.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src,
                                           long long rs, int r0, int n) {
  constexpr int PER_ROW = D / 8;
  for (int e = threadIdx.x; e < ROWS * PER_ROW; e += NT) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * 8;
    const bool in = r0 + r < n;
    const bf16* g = in ? src + (long long)(r0 + r) * rs + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * (D + 8) + c)),
                 "l"(g), "r"(in ? 16 : 0));
  }
}

// The N values' max (or sum), pairwise: a tree of depth log2 N, not a
// chain of N dependent instructions
template <int N, bool SUM>
__device__ __forceinline__ float tree(const float (&t)[N]) {
  if constexpr (N == 1) {
    return t[0];
  } else {
    float h[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j)
      h[j] = SUM ? t[j] + t[j + N / 2] : fmaxf(t[j], t[j + N / 2]);
    return tree<N / 2, SUM>(h);
  }
}

// Each warp owns MT m-tiles of 16 q rows. A tile's work is q k^T on the
// tensor cores, then the mask and the online softmax on the FP32 pipes and
// the SFU, then P V on the tensor cores. One barrier a tile: the copies of
// the tiles STAGES - 1 ahead are in flight meanwhile.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::NT, Cfg<D>::MIN_BLOCKS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                     int G, int S, int Tk, Strides st, float scale, int causal,
                     int window) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, STAGES = C::STAGES, PQ = C::PQ, TILE = C::TILE;
  constexpr int MT = C::MT, BQ = C::BQ, NT = C::NT;
  constexpr int NS = BK / 8;    // score fragments (16 x 8) per m-tile
  constexpr int NO = D / 8;     // output fragments per m-tile
  constexpr int KQ = D / 16;    // k-steps of q k^T
  constexpr bool QREG = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x PQ
  bf16* ks = qs + BQ * PQ;                       // STAGES x (BK x PQ)
  bf16* vs = ks + STAGES * TILE;                 // STAGES x (BK x PQ)

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3, r0 = warp * 16 * MT;
  const int r_lo = q0 + r0;     // the warp's rows: r_lo .. r_lo + 16 MT - 1
  const bf16* qp = q + b * st.qb + h * st.qh;
  const bf16* kp = k + b * st.kb + hk * st.kh;
  const bf16* vp = v + b * st.vb + hk * st.vh;
  const float c = scale * 1.4426950408889634f;   // scale * log2(e)

  int kv_hi = Tk, kv_lo = 0;
  if (causal) kv_hi = min(Tk, q0 + BQ);
  if (window > 0) kv_lo = max(0, q0 - window + 1) / BK * BK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  // q and the first STAGES - 1 tiles, one commit group each (tile t's
  // group is the t-th)
  stage_async<D, BQ, NT>(qs, qp, st.qs, q0, S);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) {
      stage_async<D, BK, NT>(ks + t * TILE, kp, st.ks, kv_lo + t * BK, Tk);
      stage_async<D, BK, NT>(vs + t * TILE, vp, st.vs, kv_lo + t * BK, Tk);
    }
    cp_async_commit();
  }

  float m[MT][2], l[MT][2], acc[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mt][i] = NEG;
      l[mt][i] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
  }
  uint32_t qf[MT][QREG ? KQ : 1][4];

  // s = q k^T for the warp's rows and tile t's BK keys; each K fragment
  // feeds the warp's MT m-tiles
  auto qk = [&](float (&s)[MT][NS][4], int t) {
    const bf16* kt = ks + (t % STAGES) * TILE;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = qf[mt][QREG ? kk : 0][e];
        } else {
          ldsm_x4(a[mt], qs + (r0 + 16 * mt + (lane & 15)) * PQ + kk * 16 +
                             (lane >> 4) * 8);
        }
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, kt + ((j + (lane >> 4)) * 8 + (lane & 7)) * PQ + kk * 16 +
                        ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(s[mt][j], a[mt], bb[0], bb[1]);
          mma16816(s[mt][j + 1], a[mt], bb[2], bb[3]);
        }
      }
    }
  };

  // tile t's mask, online softmax and acc += p v
  auto softmax_pv = [&](float (&s)[MT][NS][4], int t) {
    const int k0 = kv_lo + t * BK;
    // the mask, on the warp's tiles that cross T, the diagonal or the
    // window's edge only
    if (k0 + BK > Tk || (causal && k0 + BK - 1 > r_lo) ||
        (window > 0 && k0 + window <= r_lo + 16 * MT - 1)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qpos = r_lo + 16 * mt + g + 8 * i;
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = k0 + j * 8 + tq * 2 + e;
              const bool ok = kpos < Tk && (!causal || kpos <= qpos) &&
                              (window <= 0 || kpos > qpos - window);
              if (!ok) s[mt][j][2 * i + e] = NEG;
            }
        }
    }

    // the online softmax of rows g (i = 0) and g + 8 (i = 1) of each
    // m-tile, in exp2
#pragma unroll
    for (int mi = 0; mi < 2 * MT; ++mi) {
      const int mt = mi / 2, i = mi % 2;
      float t2[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        t2[j] = fmaxf(s[mt][j][2 * i], s[mt][j][2 * i + 1]);
      float mx = fmaxf(m[mt][i], tree<NS, false>(t2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row that has seen only masked keys keeps m = NEG and takes p = 0
      // (not 2^(NEG c - NEG c), whose rounding is no small number)
      const float mc = offset(mx, c);
      const float alpha = rescale(m[mt][i], mc, c);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float& x0 = s[mt][j][2 * i];
        float& x1 = s[mt][j][2 * i + 1];
        x0 = ex2_ftz(__fmaf_rn(x0, c, -mc));
        x1 = ex2_ftz(__fmaf_rn(x1, c, -mc));
        t2[j] = x0 + x1;
      }
      const float sum = tree<NS, true>(t2);
      // l is this thread's share of the row's keys, summed across the
      // row's four threads after the loop
      l[mt][i] = alpha * l[mt][i] + sum;
      m[mt][i] = mx;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[mt][j][2 * i] *= alpha;
        acc[mt][j][2 * i + 1] *= alpha;
      }
    }

    // acc += p v, p rounded to bf16 in the A fragments, 16 keys a step;
    // each V fragment feeds the warp's MT m-tiles
    const bf16* vt = vs + (t % STAGES) * TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * PQ +
                          (j + (lane >> 4)) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(acc[mt][j], a[mt], bb[0], bb[1]);
          mma16816(acc[mt][j + 1], a[mt], bb[2], bb[3]);
        }
      }
    }
  };

  float s[MT][NS][4];
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t (and q) landed for this thread...
    __syncthreads();  // ...and for every thread, and tile t - 1 is free
    {  // the tile STAGES - 1 ahead, into tile t - 1's stage
      const int ta = t + STAGES - 1;
      if (ta < n_tiles) {
        stage_async<D, BK, NT>(ks + (ta % STAGES) * TILE, kp, st.ks,
                               kv_lo + ta * BK, Tk);
        stage_async<D, BK, NT>(vs + (ta % STAGES) * TILE, vp, st.vs,
                               kv_lo + ta * BK, Tk);
      }
      cp_async_commit();
    }
    if (QREG && t == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < (QREG ? KQ : 0); ++kk)
          ldsm_x4(qf[mt][kk], qs + (r0 + 16 * mt + (lane & 15)) * PQ +
                                  kk * 16 + (lane >> 4) * 8);
    }
    qk(s, t);
    softmax_pv(s, t);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mt][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int row = r_lo + 16 * mt + g + 8 * i;
      if (row >= S) continue;
      const float den = fmaxf(li, 1e-30f);
      bf16* orow = o + b * st.ob + h * st.oh + (long long)row * st.os;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + tq * 2) = pack_bf16(
            acc[mt][j][2 * i] / den, acc[mt][j][2 * i + 1] / den);
    }
}

}  // namespace mma_route

// ------------------------------------------------------- bf16, wgmma ----
// FlashAttention-3's shape for D = 64, 128 and 256 on Hopper. A block of
// three warpgroups owns 128 q rows of one (b, h):
// * warpgroup 0 is the producer: after `setmaxnreg` lowers its registers,
//   one thread issues TMA loads, the q tile once and then every K/V tile
//   into a ring of STAGES stages guarded by full/empty mbarriers;
// * warpgroups 1 and 2 are consumers of 64 q rows each. S = Q K^T is one
//   wgmma chain with both operands in shared memory; the online softmax
//   runs on the score accumulators in registers, in exp2 with
//   scale * log2(e) folded into one fma; P, rounded to bf16 in registers,
//   is the A operand of O += P V, whose B operand is the V tile read
//   through the transposed (MN-major) descriptor. While one warpgroup
//   runs its softmax the other's wgmma keeps the tensor cores busy.
// Tiles are 128-byte-swizzled panels of 64 columns (a D=128 row is two
// panels), exactly as TMA writes them with CU_TENSOR_MAP_SWIZZLE_128B, so
// the wgmma descriptors read them in place. The tensor maps run over the
// (B, H, S, D) views' own strides (d innermost), and TMA's zero fill of
// rows past S or T replaces the ragged-edge loads; the mask arithmetic
// runs only on tiles that cross the diagonal, the window's edge or T.
namespace wg {

constexpr int NT = 384;      // producer warpgroup + two consumer warpgroups
constexpr int BQ = 128;      // q rows per block, 64 per consumer
constexpr int STAGES = 2;    // K/V ring depth

// At (DQK, DV) = (192, 128) a stage holds 3 K panels and 2 V panels:
// q 48 KB, K 2 x 48 KB, V 2 x 32 KB, 209 KB in all at 128 keys a tile.
template <int DQK, int DV>
struct Cfg {
  static constexpr int BK = DQK == 256 ? 64 : 128;  // keys per kv tile
  static constexpr int QK_PANELS = DQK / 64;        // 128-byte columns of q, k
  static constexpr int V_PANELS = DV / 64;          // ... and of v
  static constexpr int Q_PANEL = BQ * 128;          // bytes of a q panel
  static constexpr int KV_PANEL = BK * 128;         // bytes of a k/v panel
  static constexpr int Q_BYTES = QK_PANELS * Q_PANEL;
  static constexpr int K_BYTES = QK_PANELS * KV_PANEL;   // one K stage
  static constexpr int V_BYTES = V_PANELS * KV_PANEL;    // one V stage
  // 1024 bytes of slack align the tiles to the swizzle's 1024-byte atom
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES) +
                              8 * (1 + 2 * STAGES);
  static_assert(SMEM <= 232448, "a block takes at most 227 KB");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// spin until the phase of parity `parity` has completed; a wait of more
// than two minutes can only be a fault, and traps: an error, not a hang, but
// a sticky one that ends the process's CUDA context, so the guard is kept far
// above any slow but sound wait (a preempted block, a debugger)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  unsigned long long t0 = 0;
  for (;;) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if (t0 == 0)
      t0 = now_ns();
    else if (now_ns() - t0 > 120000000000ull)
      __trap();
  }
}

// one box of a 4-d tensor map (d, s, h, b) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile at shared address `addr`:
// lbo / sbo in bytes (sbo: the next 8-row group, 1024; lbo: the next
// 64-column panel of an MN-major operand, unused for K-major)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads across the wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) = [d +] A (64 x 16, shared) B (N x 16, shared), K-major
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc);
// d (64 x N) += A (64 x 16, registers) B (16 x N, shared, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The mask (only on tiles that cross T, the diagonal or the window) and
// the online softmax of one tile's raw scores, rows row0 (i = 0) and
// row0 + 8 (i = 1) of a consumer, in exp2: p = 2^(x c - m c) with
// c = scale * log2(e), one fma per score. Leaves p in `sc`, updates m and
// the thread's share of l, and returns in `alpha` the factor the
// accumulator's rows take before p v is added.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2],
                                             float (&l_part)[2],
                                             float (&alpha)[2], int k0,
                                             int r_lo, int row0, int tq4,
                                             int Tk, int causal, int window,
                                             float scale_log2) {
  if (k0 + BK > Tk || (causal && k0 + BK - 1 > r_lo) ||
      (window > 0 && k0 + window <= r_lo + 63)) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * j + 2 * tq4 + e;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qpos = row0 + 8 * i;
          const bool ok = kpos < Tk && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos + window > qpos);
          if (!ok) sc[4 * j + 2 * i + e] = NEG;
        }
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row that has seen only masked keys keeps m = NEG and takes p = 0
    // (not 2^(NEG c - NEG c), whose rounding is no small number)
    const float mc = offset(mx, scale_log2);
    alpha[i] = rescale(m[i], mc, scale_log2);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * i + e];
        x = ex2_ftz(__fmaf_rn(x, scale_log2, -mc));
        psum += x;
      }
    // l is kept per thread (its quarter of the row's keys) and summed
    // across the four threads of the row once, after the kv loop
    l_part[i] = alpha[i] * l_part[i] + psum;
    m[i] = mx;
  }
}

// s = q k^T for one consumer: raw f32 scores of 64 rows x BK keys from
// the DQK / 64 q panels at qa and the K stage at ka, issued as one wgmma
// group
template <int DQK, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t qa,
                                         uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;   // 16 columns a step
    wgmma_ss<BK>(sc, desc_sw128(qa + (kk / 4) * (BQ * 128) + col, 16),
                 desc_sw128(ka + (kk / 4) * (BK * 128) + col, 16), kk > 0);
  }
  wg_commit();
}

template <int DQK, int DV>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, int H, int G, int S, int Tk,
                       long long ob, long long oh, long long os,
                       float scale_log2, int causal, int window) {
  using C = Cfg<DQK, DV>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;          // q panels
  const uint32_t sk = sq + C::Q_BYTES;                 // K stages
  const uint32_t sv = sk + STAGES * C::K_BYTES;        // V stages
  const uint32_t q_full = sv + STAGES * C::V_BYTES;    // mbarriers
  const uint32_t full = q_full + 8, empty = full + 8 * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / G;
  int kv_hi = Tk, kv_lo = 0;
  if (causal) kv_hi = min(Tk, q0 + BQ);
  if (window > 0) kv_lo = max(0, q0 - window + 1) / BK * BK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int p = 0; p < C::QK_PANELS; ++p)
        tma_load(sq + p * C::Q_PANEL, &tq, q_full, p * 64, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES, k0 = kv_lo + t * BK;
        if (t >= STAGES) mbar_wait(empty + 8 * s, (t / STAGES - 1) & 1);
        // the stage's K panels and V panels complete one phase together
        mbar_expect_tx(full + 8 * s, C::K_BYTES + C::V_BYTES);
        for (int p = 0; p < C::QK_PANELS; ++p)
          tma_load(sk + s * C::K_BYTES + p * C::KV_PANEL, &tk, full + 8 * s,
                   p * 64, k0, hk, b);
        for (int p = 0; p < C::V_PANELS; ++p)
          tma_load(sv + s * C::V_BYTES + p * C::KV_PANEL, &tv, full + 8 * s,
                   p * 64, k0, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each. While one warpgroup runs its
    // softmax, the other's wgmma keeps the tensor cores busy. (Overlapping
    // a warpgroup's own softmax with its next q k^T made ptxas serialize
    // the wgmma chain, and was slower.)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wgi - 1, tid = threadIdx.x - 128 * wgi;
    const int lane = tid % 32, g = lane >> 2, tq4 = lane & 3;
    const int r_lo = q0 + 64 * cw;                 // the warpgroup's rows
    const int row0 = r_lo + 16 * (tid / 32) + g;   // this thread's rows:
                                                   // row0 and row0 + 8
    const uint32_t qa = sq + 64 * 128 * cw;
    float o_acc[DV / 2], sc[BK / 2];
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) o_acc[e] = 0.0f;
    float m[2] = {NEG, NEG}, l_part[2] = {0.0f, 0.0f}, alpha[2];

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(full + 8 * s, (t / STAGES) & 1);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] = 0.0f;
      wg_fence();
      issue_qk<DQK, BK>(sc, qa, sk + s * C::K_BYTES);
      wg_wait<0>();
      fence_regs(sc);
      softmax_tile<BK>(sc, m, l_part, alpha, kv_lo + t * BK, r_lo, row0,
                       tq4, Tk, causal, window, scale_log2);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          o_acc[4 * j + 2 * i] *= alpha[i];
          o_acc[4 * j + 2 * i + 1] *= alpha[i];
        }

      // o += p v, p rounded to bf16 in the A fragments, 16 keys a step
      const uint32_t va = sv + s * C::V_BYTES;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(sc[8 * kk], sc[8 * kk + 1]),
                                pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]),
                                pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]),
                                pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7])};
        wgmma_rs<DV>(o_acc, pa, desc_sw128(va + kk * 16 * 128, C::KV_PANEL));
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(o_acc);
      mbar_arrive(empty + 8 * s);   // this thread is done with the stage
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_part[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + 8 * i;
      if (row >= S) continue;
      const float den = fmaxf(l, 1e-30f);
      bf16* orow = o + b * ob + h * oh + (long long)row * os;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tq4) = pack_bf16(
            o_acc[4 * j + 2 * i] / den, o_acc[4 * j + 2 * i + 1] / den);
    }
  }
}

}  // namespace wg

// cuTensorMapEncodeTiled, fetched through the runtime so that nothing
// links libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A (b, h, s, d) bf16 view with element strides (bs, hs, rs) and d
// contiguous, as 4-d boxes of 64 columns x box_rows rows, 128-byte swizzle;
// rows past `rows` read as zeros.
int tensor_map(CUtensorMap* map, const void* ptr, int D, int rows, int heads,
               int B, long long rs, long long hs, long long bs,
               int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)rs * 2, (cuuint64_t)hs * 2,
                                 (cuuint64_t)bs * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DQK, int DV>
int launch_bf16_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                      int B, int H, int KV, int S, int Tk, const Strides& st,
                      int causal, int window, cudaStream_t stream) {
  using C = wg::Cfg<DQK, DV>;
  CUtensorMap mq, mk, mv;
  int e = tensor_map(&mq, q, DQK, S, H, B, st.qs, st.qh, st.qb, wg::BQ);
  if (!e) e = tensor_map(&mk, k, DQK, Tk, KV, B, st.ks, st.kh, st.kb, C::BK);
  if (!e) e = tensor_map(&mv, v, DV, Tk, KV, B, st.vs, st.vh, st.vb, C::BK);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(
      wg::flash_fwd_wgmma_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + wg::BQ - 1) / wg::BQ, B * H);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)DQK);
  wg::flash_fwd_wgmma_kernel<DQK, DV><<<grid, wg::NT, C::SMEM, stream>>>(
      mq, mk, mv, o, H, H / KV, S, Tk, st.ob, st.oh, st.os, scale_log2,
      causal, window);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               int B, int H, int KV, int S, int Tk, const Strides& st,
               int causal, int window, cudaStream_t stream) {
  constexpr int smem = f32_smem<DQK, DV>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<DQK, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<DQK, DV><<<grid, NT, smem, stream>>>(
      q, k, v, o, H, H / KV, S, Tk, st, 1.0f / sqrtf((float)DQK), causal,
      window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
                int H, int KV, int S, int Tk, const Strides& st, int causal,
                int window, cudaStream_t stream) {
  using C = mma_route::Cfg<D>;
  cudaError_t e = cudaFuncSetAttribute(
      mma_route::flash_fwd_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + C::BQ - 1) / C::BQ, B * H);
  mma_route::flash_fwd_mma_kernel<D><<<grid, C::NT, C::SMEM, stream>>>(
      q, k, v, o, H, H / KV, S, Tk, st, 1.0f / sqrtf((float)D), causal,
      window);
  return (int)cudaGetLastError();
}

// The float32 route is built for (D, D) and (192, 128); the mma.sync route
// for (D, D) only.
struct F32 {
  static constexpr bool MLA = true;
  template <int D, typename... A>
  static int run(A... args) { return launch_f32<D, D>(args...); }
  template <typename... A>
  static int run_mla(A... args) { return launch_f32<192, 128>(args...); }
};
struct BF16 {
  static constexpr bool MLA = false;
  template <int D, typename... A>
  static int run(A... args) { return launch_bf16<D>(args...); }
};

template <typename L, typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int B, int H, int KV,
             int S, int Tk, int D, int Dv, const long long* strides,
             int causal, int window, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Tk <= 0) return 0;
  const long long* x = strides;
  const Strides st{x[0], x[1], x[2], x[3], x[4],  x[5],
                   x[6], x[7], x[8], x[9], x[10], x[11]};
  if constexpr (L::MLA) {
    if (D == 192 && Dv == 128)
      return L::run_mla(q, k, v, o, B, H, KV, S, Tk, st, causal, window, stream);
  }
  if (Dv != D) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return L::template run<16>(q, k, v, o, B, H, KV, S, Tk, st, causal, window, stream);
    case 32:
      return L::template run<32>(q, k, v, o, B, H, KV, S, Tk, st, causal, window, stream);
    case 64:
      return L::template run<64>(q, k, v, o, B, H, KV, S, Tk, st, causal, window, stream);
    case 128:
      return L::template run<128>(q, k, v, o, B, H, KV, S, Tk, st, causal, window, stream);
    case 256:
      return L::template run<256>(q, k, v, o, B, H, KV, S, Tk, st, causal, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: the (b, h, s) element strides of q, k, v, o, in that order.
// D: the head dim of q and k; Dv: that of v and o. window <= 0: no window.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a (D, Dv) pair the route is not built for.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int B, int H,
                                   int KV, int S, int Tk, int D, int Dv,
                                   const long long* strides, int causal,
                                   int window, cudaStream_t stream) {
  return dispatch<F32>(q, k, v, o, B, H, KV, S, Tk, D, Dv, strides, causal,
                       window, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    int B, int H, int KV, int S, int Tk, int D,
                                    int Dv, const long long* strides,
                                    int causal, int window,
                                    cudaStream_t stream) {
  return dispatch<BF16>(q, k, v, o, B, H, KV, S, Tk, D, Dv, strides, causal,
                        window, stream);
}

// The wgmma route: (D, Dv) = (64, 64), (128, 128), (256, 256) or
// (192, 128), every (b, h, s) stride a positive multiple of 8 elements
// (TMA's 16-byte strides) and the bases 16-byte aligned; the wrapper checks
// both.
extern "C" int flash_attention_bf16_wgmma(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    __nv_bfloat16* o, int B, int H, int KV, int S, int Tk, int D, int Dv,
    const long long* strides, int causal, int window, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Tk <= 0) return 0;
  const long long* x = strides;
  const Strides st{x[0], x[1], x[2], x[3], x[4],  x[5],
                   x[6], x[7], x[8], x[9], x[10], x[11]};
  if (D == 192 && Dv == 128)
    return launch_bf16_wgmma<192, 128>(q, k, v, o, B, H, KV, S, Tk, st, causal, window, stream);
  if (Dv != D) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch_bf16_wgmma<64, 64>(q, k, v, o, B, H, KV, S, Tk, st, causal, window, stream);
    case 128:
      return launch_bf16_wgmma<128, 128>(q, k, v, o, B, H, KV, S, Tk, st, causal, window, stream);
    case 256:
      return launch_bf16_wgmma<256, 256>(q, k, v, o, B, H, KV, S, Tk, st, causal, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
