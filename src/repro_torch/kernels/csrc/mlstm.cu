// mLSTM's parallel stabilized form, forward: for each batch row b, head h
// and query row i, over the keys j <= i,
//   Dm_ij = (F_i - F_j) + logi_j          (F the cumsum of logf over S)
//   m_i   = max_j Dm_ij,   w_ij = exp(Dm_ij - m_i)
//   s_ij  = x(x(q_i . k_j) x(scale)),   sw_ij = s_ij w_ij
//   h_i   = x(x(sum_j x(sw_ij) v_j) / x(max(|sum_j sw_ij|, exp(-m_i))))
// q, k, v and h (B, S, H, dh) in the inputs' dtype, F and logi float32
// (B, H, S), x() rounding to the inputs' dtype (float32, or bfloat16, where
// the scale 1/sqrt(dh), computed in float32 as the reference does, is
// rounded to bf16: the reference's weakly typed float32 meets bf16
// scores).
//
// Replaces the reference's parallel form, src/repro/models/xlstm.py:53-66
// (not Pallas: XLA's einsums over (B, S, S, H) tensors). At one 32,768-token
// prompt with 4 heads each of Dm, w, the scores and sw is 17.2 GB in
// float32; here nothing of (S, S) touches memory, as flash attention does
// for softmax attention.
//
// Bound: the tensor cores. At xlstm-125m's prefill (B, S, H, dh) = (1,
// 32768, 4, 384), 2.15e9 causal (pair, head)s of 2 dh (q.k) + 2 dh (P V)
// FLOPs are 3.30e12 FLOPs, 3.34 ms at 989 TFLOP/s; the exps (one a pair)
// 0.51 ms at the SFU's 16 a clock an SM; the bytes 0.3 GB, 0.09 ms.
//
// Three routes, one kernel each:
// * wgmma (bf16, dh 384), mlstm_wgmma_kernel: warpgroup MMA fed by TMA
//   rings, the score and the value products on separate warpgroups
//   (namespace wg_route below, with the budget that shapes it).
// * mma (bf16, dh 64 or 384), mlstm_mma_kernel: a block of 8 warps takes
//   64 query rows of one (b, h). First one scalar pass over its keys gives
//   m_i exactly in the reference's order (3 FLOPs a pair beside the 4 dh
//   of the products; the keys' F and logi staged through shared memory),
//   so the weights need no online rescaling. Then per
//   tile of 64 keys up to the diagonal: S = Q K^T on mma.sync m16n8k16
//   (warp (r, c): rows 16 r, keys 32 c), the weights and the den sums in
//   registers (a weight is one ex2.approx, without exp2f's range
//   handling), x(sw) to shared memory as bf16, then O += P V (warp (r, c):
//   rows 16 r, value columns dh / 2 c), the 64 x dh float32 accumulator
//   in registers (96 a thread at dh = 384). q, K and V are bf16 rows of
//   pitch dh + 8 (conflict-free ldmatrix); K for the next tile is copied
//   by cp.async while P V runs, V while the next S does. Query tiles run
//   heaviest first (the diagonal's last tiles have the most keys). The
//   route of dh = 64, and the wgmma route's witness and yardstick at 384.
// * fma (float32, dh 64 or 384), mlstm_fma_kernel: a block of 128 threads
//   takes 16 query rows, tiles of 16 keys, every product a float32 FMA
//   chain on the CUDA cores (mma.sync on float32 would be TF32). The route
//   of the checks and the tests; no main path runs float32.
// Sums run in other orders than the reference's (the tiles, the den's
// partials, the mma's tree), so every route is held to tolerances, not
// bits; the file is built without -fmad=false.
#include <cuda.h>   // CUtensorMap and its enums; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 2^x on the SFU, one MUFU.EX2 (exp2f adds range handling around it; a
// weight under 2^-126 is 0 either way once sw is rounded to bf16)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
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

// one copy of `bytes` (4 or 16) from global to shared memory, zeros where
// `ok` is false, in flight until the thread's next cp.async.wait_group
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// m_i of `rows` query rows from i0 of one (b, h), `lanes` threads a row
// (a power of two within a warp, consecutive threads), each thread taking
// every lanes-th key; Dm in the reference's order. Rows past S get 0.
template <int kLanes>
__device__ __forceinline__ float row_max(const float* F, const float* L,
                                         int i, int S, int sub) {
  float mx = -__int_as_float(0x7f800000);   // -inf
  if (i < S) {
    const float fi = F[i];
    for (int j = sub; j <= i; j += kLanes) mx = fmaxf(mx, (fi - F[j]) + L[j]);
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o /= 2)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  return i < S ? mx : 0.0f;
}

// row_max's m_i with the keys' F and logi staged through shared memory
// `stage` (2 kMC floats) a chunk of kMC keys at a time, every thread of the
// group of kThreads (thread `tid` of it) loading the chunk (a block's rows
// read each key: from L2, F and logi of one (b, h), 256 KB at S = 32768,
// outrun the L1) and each row reading four keys a load; the same maxima in
// the same order of terms. The group meets at named barrier kBar (0: the
// whole block).
constexpr int kMC = 1024;
template <int kBar, int kThreads>
__device__ __forceinline__ void group_sync() {
  if constexpr (kBar == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"n"(kBar), "n"(kThreads) : "memory");
}
template <int kLanes, int kThreads, int kBar = 0>
__device__ __forceinline__ float row_max_staged(const float* F,
                                                const float* L, int i, int S,
                                                int sub, int last,
                                                float* stage, int tid) {
  float* fs = stage;
  float* ls = stage + kMC;
  float mx = -__int_as_float(0x7f800000);   // -inf
  const float fi = i < S ? F[i] : 0.0f;
  for (int j0 = 0; j0 <= last; j0 += kMC) {
    group_sync<kBar, kThreads>();   // the chunk before read
    for (int x = tid; x < kMC; x += kThreads) {
      const bool ok = j0 + x < S;
      fs[x] = ok ? F[j0 + x] : 0.0f;
      ls[x] = ok ? L[j0 + x] : 0.0f;
    }
    group_sync<kBar, kThreads>();
    const int n = i < S ? min(i - j0 + 1, kMC) : 0;   // the row's keys here
    for (int x = 4 * sub; x < n; x += 4 * kLanes) {
      const float4 f4 = *reinterpret_cast<const float4*>(fs + x);
      const float4 l4 = *reinterpret_cast<const float4*>(ls + x);
      mx = fmaxf(mx, (fi - f4.x) + l4.x);
      if (x + 1 < n) mx = fmaxf(mx, (fi - f4.y) + l4.y);
      if (x + 2 < n) mx = fmaxf(mx, (fi - f4.z) + l4.z);
      if (x + 3 < n) mx = fmaxf(mx, (fi - f4.w) + l4.w);
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o /= 2)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  return i < S ? mx : 0.0f;
}

// ---------------------------------------------------------------- mma ----

namespace mma_route {

template <int DH>
struct Cfg {
  static constexpr int BQ = 64;              // query rows a block
  static constexpr int BK = 64;              // keys a tile
  static constexpr int NT = 256;             // 8 warps
  static constexpr int P = DH + 8;           // pitch of q, K, V rows
  static constexpr int PP = BK + 8;          // pitch of P rows
  static constexpr int DV = DH / 2;          // value columns a warp
  static constexpr int NV = DV / 8;          // their n-tiles
  // q, K, V and P in bf16, then F and logi of a tile's keys and the den
  // partials (the rows' m borrow their first BQ)
  static constexpr int SMEM = (BQ * P + 2 * BK * P + BQ * PP) * 2
                              + (2 * BK + 3 * BQ) * 4;
  static_assert(DH % 16 == 0 && NV % 2 == 0, "dh a multiple of 32");
  static_assert(BQ * PP * 2 >= 2 * kMC * 4, "P's buffer stages the m pass");
};

struct Smem {
  bf16* q;
  bf16* k;
  bf16* v;
  bf16* p;
  float* fk;   // F of the tile's keys
  float* lk;   // logi of the tile's keys
  float* den;  // (3, BQ): the rows' m, then the den partials of the
               // two key halves
};

template <int DH>
__device__ __forceinline__ Smem carve(unsigned char* base) {
  using C = Cfg<DH>;
  Smem s;
  s.q = reinterpret_cast<bf16*>(base);
  s.k = s.q + C::BQ * C::P;
  s.v = s.k + C::BK * C::P;
  s.p = s.v + C::BK * C::P;
  s.fk = reinterpret_cast<float*>(s.p + C::BQ * C::PP);
  s.lk = s.fk + C::BK;
  s.den = s.lk + C::BK;
  return s;
}

// rows r0.. of a (B, S, H, DH) tensor's (b, h) into pitch-P shared rows,
// zeros past S
template <int DH, int kRows>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int r0,
                                          int S, int H) {
  using C = Cfg<DH>;
  constexpr int kChunks = DH / 8;    // 16-byte copies a row
  for (int c = threadIdx.x; c < kRows * kChunks; c += C::NT) {
    const int r = c / kChunks, col = c % kChunks * 8;
    const bool ok = r0 + r < S;
    const bf16* at = src + (ok ? (long long)(r0 + r) * H * DH + col : 0);
    cp_async<16>(dst + r * C::P + col, at, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(256, 1)
    mlstm_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ F,
                     const float* __restrict__ L, float scale,
                     bf16* __restrict__ out, int S, int H) {
  using C = Cfg<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve<DH>(smem_raw);
  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  const int tile = gridDim.y - 1 - blockIdx.y;   // heaviest first
  const int i0 = tile * C::BQ;
  const long long base = ((long long)b * S * H + hh) * DH;   // (b, 0, h, 0)
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const float* Fb = F + (long long)bh * S;
  const float* Lb = L + (long long)bh * S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp % 4, wc = warp / 4;
  const int g = lane / 4, qd = lane % 4;
  const int last = min(S, i0 + C::BQ) - 1;       // the tile's last row
  const int tiles = last / C::BK + 1;            // key tiles up to it

  auto fetch_k = [&](int t) {
    const int j0 = t * C::BK;
    copy_rows<DH, C::BK>(s.k, kb, j0, S, H);
    if (tid < C::BK) {
      const bool ok = j0 + tid < S;
      cp_async<4>(s.fk + tid, Fb + (ok ? j0 + tid : 0), ok);
      cp_async<4>(s.lk + tid, Lb + (ok ? j0 + tid : 0), ok);
    }
  };
  copy_rows<DH, C::BQ>(s.q, qb, i0, S, H);
  fetch_k(0);
  cp_async_commit();
  copy_rows<DH, C::BK>(s.v, vb, 0, S, H);
  cp_async_commit();

  // m_i: 4 threads a row, every row of the block, the keys staged in P's
  // buffer (free until the first tile)
  const float m_row = row_max_staged<4, C::NT>(
      Fb, Lb, i0 + tid / 4, S, tid % 4, last, reinterpret_cast<float*>(s.p),
      tid);
  __syncthreads();
  if (tid % 4 == 0) s.den[tid / 4] = m_row;    // borrowed for m
  __syncthreads();
  const int ra = 16 * wr + g, rb = ra + 8;     // this thread's two rows
  const int ia = i0 + ra, ib = i0 + rb;
  const float ma = s.den[ra], mb = s.den[rb];
  const float fa = ia < S ? Fb[ia] : 0.0f, fb = ib < S ? Fb[ib] : 0.0f;
  float den_a = 0.0f, den_b = 0.0f;
  float o[C::NV][4];
#pragma unroll
  for (int n = 0; n < C::NV; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  for (int t = 0; t < tiles; ++t) {
    const int j0 = t * C::BK;
    cp_async_wait<1>();      // q and this tile's K, F, logi landed
    __syncthreads();
    // S = Q K^T for rows 16 wr.., keys 32 wc..
    float sc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0;
#pragma unroll 4
    for (int kk = 0; kk < DH; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, s.q + (16 * wr + lane % 8 + 8 * ((lane / 8) % 2)) * C::P
                     + kk + 8 * (lane / 16));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t bb[4];
        ldsm_x4(bb, s.k + (32 * wc + 16 * half + lane % 8 + 8 * (lane / 16))
                          * C::P + kk + 8 * ((lane / 8) % 2));
        mma16816(sc[2 * half], a, bb[0], bb[1]);
        mma16816(sc[2 * half + 1], a, bb[2], bb[3]);
      }
    }
    // the weights, sw, the den sums and x(sw) into P
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * wc + 8 * n + 2 * qd + (e & 1);
        const int j = j0 + col;
        const bool low = e < 2;
        const int i = low ? ia : ib;
        float sw = 0.0f;
        if (j <= i && i < S) {
          const float dm = ((low ? fa : fb) - s.fk[col]) + s.lk[col];
          const float w = ex2_ftz((dm - (low ? ma : mb)) * kLog2e);
          sw = round_bf16(round_bf16(sc[n][e]) * scale) * w;
        }
        sc[n][e] = sw;
        if (low) den_a += sw; else den_b += sw;
      }
      const int col = 32 * wc + 8 * n + 2 * qd;
      *reinterpret_cast<uint32_t*>(s.p + ra * C::PP + col) =
          pack_bf16(sc[n][0], sc[n][1]);
      *reinterpret_cast<uint32_t*>(s.p + rb * C::PP + col) =
          pack_bf16(sc[n][2], sc[n][3]);
    }
    cp_async_wait<0>();      // this tile's V landed
    __syncthreads();         // P and V visible; K free
    if (t + 1 < tiles) fetch_k(t + 1);
    cp_async_commit();
    // O += P V for rows 16 wr.., value columns DV wc..
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, s.p + (16 * wr + lane % 8 + 8 * ((lane / 8) % 2)) * C::PP
                     + kk + 8 * (lane / 16));
#pragma unroll
      for (int n = 0; n < C::NV; n += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, s.v + (kk + lane % 8 + 8 * ((lane / 8) % 2)) * C::P
                          + C::DV * wc + 8 * n + 8 * (lane / 16));
        mma16816(o[n], a, bb[0], bb[1]);
        mma16816(o[n + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();         // V and P free
    if (t + 1 < tiles) copy_rows<DH, C::BK>(s.v, vb, j0 + C::BK, S, H);
    cp_async_commit();
  }

  // den: the row's four threads, then the two key halves
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    den_a += __shfl_xor_sync(0xffffffffu, den_a, off);
    den_b += __shfl_xor_sync(0xffffffffu, den_b, off);
  }
  if (qd == 0) {
    s.den[C::BQ + wc * C::BQ + ra] = den_a;
    s.den[C::BQ + wc * C::BQ + rb] = den_b;
  }
  __syncthreads();
  const float da = round_bf16(fmaxf(
      fabsf(s.den[C::BQ + ra] + s.den[2 * C::BQ + ra]), expf(-ma)));
  const float db = round_bf16(fmaxf(
      fabsf(s.den[C::BQ + rb] + s.den[2 * C::BQ + rb]), expf(-mb)));
#pragma unroll
  for (int n = 0; n < C::NV; ++n) {
    const int col = C::DV * wc + 8 * n + 2 * qd;
    if (ia < S)
      *reinterpret_cast<uint32_t*>(out + base + (long long)ia * H * DH + col) =
          pack_bf16(round_bf16(o[n][0]) / da, round_bf16(o[n][1]) / da);
    if (ib < S)
      *reinterpret_cast<uint32_t*>(out + base + (long long)ib * H * DH + col) =
          pack_bf16(round_bf16(o[n][2]) / db, round_bf16(o[n][3]) / db);
  }
}

}  // namespace mma_route

// -------------------------------------------------------------- wgmma ----
// bf16 at dh = 384 (xlstm-125m's prefill) on warpgroup MMA. The budget that
// shapes it, a block of 64 query rows of one (b, h):
// * tiles: a 64-row tile of q, K or V is 48 KB in bf16 (six 128-byte
//   swizzled panels of 64 columns, as TMA writes them and wgmma reads them);
// * registers: a 64 x 384 float32 accumulator is 192 registers a thread
//   over one warpgroup, too many beside the scores, so the value columns
//   are split over two warpgroups, 96 registers each;
// * shared memory: at most 227 KB a block; two K and two V stages are 192
//   KB, P (x(sw), 64 x 64 bf16) two buffers of 8 KB;
// * wgmma takes 64 rows and N <= 256; with both operands in shared memory
//   an N = 16 product is bound by shared-memory bandwidth, so every N here
//   is >= 64;
// * the card: at 2,048 bf16 FMAs a clock an SM, one 64 x 64 key tile
//   (Q K^T and P V, 2 x 64 x 64 x 384 FMAs) is ~1,540 clocks of tensor-core
//   time; the weights ~4,096 pairs x ~12 instructions, ~400 issue clocks
//   over one warpgroup; ~112 KB of shared-memory reads a tile, ~73 B a clock
//   of 128. And from L2: 96 KB of K and V a tile is 64 FLOPs a byte, so
//   kCl = 2 (a cluster of two blocks, adjacent query tiles of one (b, h))
//   multicasts each K and V tile into both blocks, half of it loaded by
//   each, for 128 FLOPs a byte.
// The block: four warpgroups.
// * Producer (warpgroup 0, 32 registers after setmaxnreg.dec): thread 0
//   issues the TMA loads of q (once, into V's second stage) and of every K
//   tile with its keys' F and logi (1-D bulk copies); thread 32 those of
//   every V tile; two-stage rings guarded by full / empty mbarriers. The
//   tensor maps run over the (B, S, H, dh) tensors' own strides, and TMA's
//   zero fill of rows past S replaces the ragged-edge loads.
// * S (warpgroup 1, 224 registers): q as wgmma's register A operand (96
//   registers, read once by ldmatrix), each tile S = Q K^T as 24 m64n64k16
//   wgmmas, then the weights and the den partials in registers (the causal
//   and edge test only on tiles that cross the diagonal or S), x(sw) into
//   P's buffer t % 2 (128-byte swizzled, conflict-free stores), a proxy
//   fence, and an arrive on P's full barrier.
// * PV (warpgroups 2 and 3, 128 registers): warpgroup c runs O[:, 192 c :
//   192 c + 192] += P V[:, 192 c : ...] as 4 m64n192k16 wgmmas a tile, both
//   operands from shared memory (V through the transposed descriptor),
//   issued once S(t + 1) has landed (an mbarrier a tile), so that P V(t)
//   runs beside the S warpgroup's weights and S(t + 1)'s chain has the
//   tensor cores alone, and before P V(t - 1) is waited for. Before the
//   first tile they take m_i (row_max_staged, 4 threads a row, staged in P's
//   buffers) while the S warpgroup loads q, and hand it over at a named
//   barrier; after the last they take the den from the S warpgroup at
//   another, and write h.
// The weights round to bf16 two values at a time (one F2FP and two
// unpacking ops): a conversion each (F2F) shares the unit the exps take.
// No warpgroup overlaps its own weights with its own next wgmma chain (on
// flash_attention that made ptxas serialize the chain). The designs timed
// beside it (a block alone, S(t + 1) issued before tile t's weights, other
// roundings, P V not gated) are built by chip_mlstm_phases.py from edited
// copies of this file; their times are in PERF.md.
namespace wg_route {

constexpr int DH = 384;
constexpr int BQ = 64;                   // query rows a block
constexpr int BK = 64;                   // keys a tile
constexpr int NT = 512;                  // four warpgroups
constexpr int PANELS = DH / 64;          // 128-byte columns of q, K, V
constexpr int PANEL = 64 * 128;          // bytes of a 64-row panel
constexpr int TILE = PANELS * PANEL;     // a q, K or V tile: 48 KB
constexpr int P_BYTES = BQ * BK * 2;     // a P buffer: 8 KB
constexpr int FL_BYTES = 2 * BK * 4;     // a K stage's F and logi
constexpr int DV = DH / 2;               // value columns a PV warpgroup

constexpr int kCl = 2;                   // blocks a cluster
static_assert(PANELS % kCl == 0, "each block loads whole panels");

// x and y rounded to bf16 (to nearest, ties to even) and back, for the
// finite values the weights take, by one packing conversion
__device__ __forceinline__ float2 round2_bf16(float x, float y) {
  const uint32_t u = pack_bf16(x, y);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// offsets from the 1024-byte-aligned base
constexpr int OFF_K = 0;                         // 2 K stages
constexpr int OFF_V = OFF_K + 2 * TILE;          // 2 V stages (q: stage 1)
constexpr int OFF_P = OFF_V + 2 * TILE;          // 2 P buffers
constexpr int OFF_FL = OFF_P + 2 * P_BYTES;      // 2 x (F, logi) of K's keys
constexpr int OFF_M = OFF_FL + 2 * FL_BYTES;     // the rows' m
constexpr int OFF_DEN = OFF_M + BQ * 4;          // the rows' den
constexpr int OFF_BAR = OFF_DEN + BQ * 4;        // mbarriers
// q_full, q_free, k_full[2], k_empty[2], v_full[2], v_empty[2], p_full[2],
// p_empty[2], s_done
constexpr int N_BARS = 15;
constexpr int SMEM = 1024 + OFF_BAR + 8 * N_BARS;
static_assert(SMEM <= 232448, "a block takes at most 227 KB");
static_assert(2 * P_BYTES >= 2 * kMC * 4, "P's buffers stage the m pass");

// named barriers (0 is __syncthreads)
constexpr int BAR_M = 1;      // PV warpgroups' m pass, among themselves
constexpr int BAR_M_DONE = 2; // m handed to the S warpgroup
constexpr int BAR_DEN = 3;    // den handed to the PV warpgroups

using namespace hopper;   // mbarriers, TMA, wgmma descriptors and fences

// an arrive on barrier `bar` of this block and on the same barrier of the
// cluster's other block
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  mbar_arrive(bar);
  uint32_t peer, remote;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(peer));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(bar), "r"(peer ^ 1u));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// one box (64 columns x 64 rows) of a 4-d tensor map (d, s, h, b) into
// shared memory of both blocks of the cluster (the same offset, the same
// barrier offset)
__device__ __forceinline__ void tma_load_mc(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "h"((unsigned short)3)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global memory
// into shared memory of both blocks of the cluster
__device__ __forceinline__ void bulk_load_mc(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"((unsigned short)3)
      : "memory");
}

// d (64 x 64) [+]= A (64 x 16, registers) B (64 x 16, shared, K-major):
// S = Q K^T, 16 of dh a step; acc = 0 starts the sum
__device__ __forceinline__ void wgmma_qk(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x 192) += A (64 x 16, shared, K-major) B (16 x 192, shared,
// MN-major): O += P V, 16 keys a step
__device__ __forceinline__ void wgmma_pv(float (&d)[96], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
      ", %96, %97, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// the byte offset of 16-byte chunk `c` of row `r` in a 128-byte-swizzled
// panel (chunk c of row r lives at chunk c ^ (r % 8))
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

__global__ void __launch_bounds__(NT, 1)
    mlstm_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const float* __restrict__ F,
                       const float* __restrict__ L, int pitch, float scale,
                       bf16* __restrict__ out, int S, int H) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gen = smem_raw + (base - raw);   // the same, generic
  const uint32_t sk = base + OFF_K, sv = base + OFF_V, sp = base + OFF_P;
  const uint32_t sq = sv + TILE;                  // q in V's second stage
  const float* fl = reinterpret_cast<const float*>(gen + OFF_FL);
  float* s_m = reinterpret_cast<float*>(gen + OFF_M);
  float* s_den = reinterpret_cast<float*>(gen + OFF_DEN);
  const uint32_t bars = base + OFF_BAR;
  const uint32_t q_full = bars, q_free = bars + 8;
  const uint32_t k_full = bars + 16, k_empty = bars + 32;
  const uint32_t v_full = bars + 48, v_empty = bars + 64;
  const uint32_t p_full = bars + 80, p_empty = bars + 96;
  const uint32_t s_done = bars + 112;   // a phase a tile's S landed

  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  // a cluster takes kCl adjacent query tiles, heaviest clusters first; its
  // blocks walk the same key tiles (the last block's), the others' extra
  // tiles wholly masked
  const int rank = blockIdx.y % kCl;
  const int group = gridDim.y / kCl - 1 - blockIdx.y / kCl;
  const int tile = kCl * group + rank;
  const int i0 = tile * BQ;
  const int tiles = (min(S, (kCl * group + kCl) * BQ) - 1) / BK + 1;
  const float* Fb = F + (long long)bh * pitch;
  const float* Lb = L + (long long)bh * pitch;
  const bool edge = i0 + BQ > S;   // rows past S in this block

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_free, 4 * kCl);              // the S warps of the cluster
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * kCl);   // the S warps of the cluster
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 8 * kCl);   // the PV warps of the cluster
      mbar_init(p_full + 8 * s, 128);        // the S threads
      mbar_init(p_empty + 8 * s, 256);       // the PV threads
    }
    mbar_init(s_done, 4);                    // the S warps
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();   // every barrier of the cluster set before any arrive

  const int wgi = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;   // the warp in its warpgroup
  if (wgi == 0) {
    // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
    const int panel0 = rank * (PANELS / kCl);   // this block's share
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, TILE);
      for (int p = 0; p < PANELS; ++p)
        tma_load(sq + p * PANEL, &tq, q_full, p * 64, i0, hh, b);
      for (int t = 0; t < tiles; ++t) {
        const int s = t & 1, j0 = t * BK;
        if (t >= 2) mbar_wait(k_empty + 8 * s, ((t >> 1) - 1) & 1);
        mbar_expect_tx(k_full + 8 * s, TILE + FL_BYTES);
        for (int p = panel0; p < panel0 + PANELS / kCl; ++p)
          tma_load_mc(sk + s * TILE + p * PANEL, &tk, k_full + 8 * s,
                      p * 64, j0, hh, b);
        // the keys' F from block 0, their logi from block 1
        const uint32_t dfl = base + OFF_FL + s * FL_BYTES;
        bulk_load_mc(dfl + rank * BK * 4, (rank ? Lb : Fb) + j0, BK * 4,
                     k_full + 8 * s);
      }
    } else if (threadIdx.x == 32) {
      for (int t = 0; t < tiles; ++t) {
        const int s = t & 1, j0 = t * BK;
        if (t >= 2)
          mbar_wait(v_empty + 8 * s, ((t >> 1) - 1) & 1);
        else if (t == 1)
          mbar_wait(q_free, 0);   // q read out of stage 1
        mbar_expect_tx(v_full + 8 * s, TILE);
        for (int p = panel0; p < panel0 + PANELS / kCl; ++p)
          tma_load_mc(sv + s * TILE + p * PANEL, &tv, v_full + 8 * s,
                      p * 64, j0, hh, b);
      }
    }
  } else if (wgi == 1) {
    // ---- S: scores, weights, den, x(sw) into P
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int g = lane / 4, qd = lane % 4;
    const int ra = 16 * warp + g, rb = ra + 8;   // this thread's two rows
    const int ia = i0 + ra, ib = i0 + rb;
    // q as the A operand: 24 k-steps of 16 columns, ldmatrix x4 each
    uint32_t qf[DH / 16][4];
    mbar_wait(q_full, 0);
    {
      const int r = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t at = sq + (kk >> 2) * PANEL
                            + sw128(r, 2 * (kk & 3) + (lane >> 4));
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(qf[kk][0]), "=r"(qf[kk][1]), "=r"(qf[kk][2]),
              "=r"(qf[kk][3])
            : "r"(at));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive_cluster(q_free);
    const float fa = ia < S ? Fb[ia] : 0.0f, fb = ib < S ? Fb[ib] : 0.0f;
    asm volatile("bar.sync %0, %1;\n" ::"n"(BAR_M_DONE), "n"(384)
                 : "memory");
    const float ma = s_m[ra], mb = s_m[rb];
    float den_a = 0.0f, den_b = 0.0f;
    // S(t) = Q K(t)^T into sc, issued as one wgmma group once K(t) landed
    auto issue = [&](float (&sc)[32], int t) {
      const int s = t & 1;
      mbar_wait(k_full + 8 * s, (t >> 1) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_qk(sc, qf[kk],
                 desc_sw128(sk + s * TILE + (kk >> 2) * PANEL + (kk & 3) * 32,
                            16),
                 kk > 0);
      wg_commit();
    };
    // tile t: S(t) into sc, K(t) released, then the weights and x(sw) into
    // P
    auto step = [&](float (&sc)[32], int t) {
      const int s = t & 1, j0 = t * BK;
      issue(sc, t);
      // the tile's keys' F and logi: columns 8 n + 2 qd and the next
      const float* fk = fl + s * (2 * BK);
      float2 fj[8], lj[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        fj[n] = *reinterpret_cast<const float2*>(fk + 8 * n + 2 * qd);
        lj[n] = *reinterpret_cast<const float2*>(fk + BK + 8 * n + 2 * qd);
      }
      wg_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_cluster(k_empty + 8 * s);
        mbar_arrive(s_done);
      }
      // the weights, sw and the den sums; sc[4 n + 2 h + e] is row ra + 8 h,
      // key column 8 n + 2 qd + e
      const bool mask = t >= tile || edge;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 x = round2_bf16(sc[4 * n + 2 * h], sc[4 * n + 2 * h + 1]);
          const float2 xs = round2_bf16(x.x * scale, x.y * scale);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dm = ((h ? fb : fa) - (e ? fj[n].y : fj[n].x))
                             + (e ? lj[n].y : lj[n].x);
            const float w = ex2_ftz((dm - (h ? mb : ma)) * kLog2e);
            float sw = (e ? xs.y : xs.x) * w;
            if (mask) {
              const int j = j0 + 8 * n + 2 * qd + e;
              const int i = h ? ib : ia;
              if (!(j <= i && i < S)) sw = 0.0f;
            }
            sc[4 * n + 2 * h + e] = sw;
            if (h) den_b += sw; else den_a += sw;
          }
        }
      }
      if (t >= 2) mbar_wait(p_empty + 8 * s, ((t >> 1) - 1) & 1);
      unsigned char* pb = gen + OFF_P + s * P_BYTES;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<uint32_t*>(pb + sw128(ra, n) + 4 * qd) =
            pack_bf16(sc[4 * n], sc[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(pb + sw128(rb, n) + 4 * qd) =
            pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
      }
      // the generic-proxy stores made visible to wgmma's reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(p_full + 8 * s);
    };
    float sa[32];
    for (int t = 0; t < tiles; ++t) step(sa, t);
    // den: the row's four threads
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      den_a += __shfl_xor_sync(0xffffffffu, den_a, off);
      den_b += __shfl_xor_sync(0xffffffffu, den_b, off);
    }
    if (qd == 0) {
      s_den[ra] = den_a;
      s_den[rb] = den_b;
    }
    asm volatile("bar.arrive %0, %1;\n" ::"n"(BAR_DEN), "n"(384) : "memory");
  } else {
    // ---- PV: O[:, DV c ..] += P V[:, DV c ..]
    const int c = wgi - 2, pt = threadIdx.x - 256;
    {
      // m_i: 4 threads a row, staged in P's buffers (free until the S
      // warpgroup has m)
      const int last = min(S, i0 + BQ) - 1;
      const float m_row = row_max_staged<4, 256, BAR_M>(
          Fb, Lb, i0 + pt / 4, S, pt % 4, last,
          reinterpret_cast<float*>(gen + OFF_P), pt);
      if (pt % 4 == 0) s_m[pt / 4] = m_row;
      asm volatile("bar.arrive %0, %1;\n" ::"n"(BAR_M_DONE), "n"(384)
                   : "memory");
    }
    float o[DV / 2];
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) o[e] = 0.0f;
    for (int t = 0; t < tiles; ++t) {
      const int s = t & 1;
      mbar_wait(v_full + 8 * s, (t >> 1) & 1);
      mbar_wait(p_full + 8 * s, (t >> 1) & 1);
      // S(t + 1) landed: s_done's phase t + 1 (the S warpgroup lands
      // S(t + 2) only after this iteration frees P(t - 1)'s buffer, so the
      // parity is never a phase behind)
      if (t + 1 < tiles) mbar_wait(s_done, (t + 1) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv(o, desc_sw128(sp + s * P_BYTES + kk * 32, 16),
                 desc_sw128(sv + s * TILE + 3 * c * PANEL + kk * 16 * 128,
                            PANEL));
      wg_commit();
      wg_wait<1>();   // the tile before done: its V and P free
      if (t > 0) {
        const int sb = (t - 1) & 1;
        __syncwarp();
        if (lane == 0) mbar_arrive_cluster(v_empty + 8 * sb);
        mbar_arrive(p_empty + 8 * sb);
      }
    }
    wg_wait<0>();
    fence_regs(o);
    asm volatile("bar.sync %0, %1;\n" ::"n"(BAR_DEN), "n"(384) : "memory");
    const int g = lane / 4, qd = lane % 4;
    const long long hb = ((long long)b * S * H + hh) * DH;   // (b, 0, h, 0)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int r = 16 * warp + g + 8 * e2, i = i0 + r;
      if (i >= S) continue;
      const float d = round_bf16(fmaxf(fabsf(s_den[r]), expf(-s_m[r])));
      bf16* orow = out + hb + (long long)i * H * DH + DV * c;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * qd) =
            pack_bf16(round_bf16(o[4 * n + 2 * e2]) / d,
                      round_bf16(o[4 * n + 2 * e2 + 1]) / d);
    }
  }
  __syncwarp();
  cluster_sync();   // no block leaves while the other may arrive on its
                    // barriers or multicast into it
}

}  // namespace wg_route

// ---------------------------------------------------------------- fma ----

namespace fma_route {

template <int DH>
struct Cfg {
  static constexpr int BQ = 16;    // query rows a block
  static constexpr int BK = 16;    // keys a tile
  static constexpr int NT = 128;   // 8 threads a row
  static constexpr int P = DH + 1; // pitch of q and K rows (conflict-free)
  static constexpr int NO = DH / 8;
  static constexpr int SMEM = (BQ * P + BK * P + BK * DH + BQ * BK + 2 * BK
                               + BQ) * 4;
};

template <int DH>
__global__ void __launch_bounds__(128)
    mlstm_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ F,
                     const float* __restrict__ L, float scale,
                     float* __restrict__ out, int S, int H) {
  using C = Cfg<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + C::BQ * C::P;
  float* vs = ks + C::BK * C::P;
  float* ps = vs + C::BK * DH;
  float* fk = ps + C::BQ * C::BK;
  float* lk = fk + C::BK;
  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
  const long long base = ((long long)b * S * H + hh) * DH;
  const float* Fb = F + (long long)bh * S;
  const float* Lb = L + (long long)bh * S;
  const int tid = threadIdx.x, r = tid / 8, sub = tid % 8;
  const int i = i0 + r;
  for (int c = tid; c < C::BQ * DH; c += C::NT) {
    const int rr = c / DH, d = c % DH;
    qs[rr * C::P + d] = i0 + rr < S ? q[base + (long long)(i0 + rr) * H * DH
                                        + d] : 0.0f;
  }
  const float m = row_max<8>(Fb, Lb, i, S, sub);
  const float fi = i < S ? Fb[i] : 0.0f;
  float den = 0.0f;
  float o[C::NO];
#pragma unroll
  for (int n = 0; n < C::NO; ++n) o[n] = 0.0f;
  const int last = min(S, i0 + C::BQ) - 1;
  for (int j0 = 0; j0 <= last; j0 += C::BK) {
    __syncthreads();
    for (int c = tid; c < C::BK * DH; c += C::NT) {
      const int kk = c / DH, d = c % DH;
      const bool ok = j0 + kk < S;
      const long long at = base + (long long)(j0 + kk) * H * DH + d;
      ks[kk * C::P + d] = ok ? k[at] : 0.0f;
      vs[kk * DH + d] = ok ? v[at] : 0.0f;
    }
    if (tid < C::BK) {
      const bool ok = j0 + tid < S;
      fk[tid] = ok ? Fb[j0 + tid] : 0.0f;
      lk[tid] = ok ? Lb[j0 + tid] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kk = sub + 8 * u, j = j0 + kk;
      float sw = 0.0f;
      if (j <= i && i < S) {
        float dot = 0.0f;
        for (int d = 0; d < DH; ++d)
          dot = fmaf(qs[r * C::P + d], ks[kk * C::P + d], dot);
        const float w = expf(((fi - fk[kk]) + lk[kk]) - m);
        sw = dot * scale * w;
      }
      ps[r * C::BK + kk] = sw;
      den += sw;
    }
    __syncthreads();
    for (int kk = 0; kk < C::BK; ++kk) {
      const float p = ps[r * C::BK + kk];
#pragma unroll
      for (int n = 0; n < C::NO; ++n)
        o[n] = fmaf(p, vs[kk * DH + sub + 8 * n], o[n]);
    }
  }
#pragma unroll
  for (int off = 1; off < 8; off *= 2)
    den += __shfl_xor_sync(0xffffffffu, den, off);
  const float dd = fmaxf(fabsf(den), expf(-m));
  if (i < S) {
#pragma unroll
    for (int n = 0; n < C::NO; ++n)
      out[base + (long long)i * H * DH + sub + 8 * n] = o[n] / dd;
  }
}

}  // namespace fma_route

// 1/sqrt(dh) in float32 (IEEE sqrt and division, as XLA's), as the
// reference's prefill scales the scores
template <int DH>
float score_scale() {
  return 1.0f / sqrtf((float)DH);
}

template <int DH>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* F,
                const float* L, bf16* out, int B, int S, int H,
                cudaStream_t stream) {
  using C = mma_route::Cfg<DH>;
  const float scale = __bfloat162float(__float2bfloat16_rn(score_scale<DH>()));
  cudaError_t e = cudaFuncSetAttribute(
      mma_route::mlstm_mma_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (S + C::BQ - 1) / C::BQ);
  mma_route::mlstm_mma_kernel<DH><<<grid, C::NT, C::SMEM, stream>>>(
      q, k, v, F, L, scale, out, S, H);
  return (int)cudaGetLastError();
}

int launch_bf16_wgmma(const bf16* q, const bf16* k, const bf16* v,
                      const float* F, const float* L, int pitch, bf16* out,
                      int B, int S, int H, cudaStream_t stream) {
  using namespace wg_route;
  // (B, S, H, dh) contiguous, as 4-d boxes (d, s, h, b) of 64 columns x 64
  // rows; rows past S read as zeros
  const long long rs = (long long)H * DH, hs = DH, bs = (long long)S * H * DH;
  using hopper::bf16_tensor_map;
  CUtensorMap mq, mk, mv;
  int err = bf16_tensor_map(&mq, q, DH, S, H, B, rs, hs, bs, BQ);
  if (!err) err = bf16_tensor_map(&mk, k, DH, S, H, B, rs, hs, bs, BK);
  if (!err) err = bf16_tensor_map(&mv, v, DH, S, H, B, rs, hs, bs, BK);
  if (err) return err;
  auto kernel = mlstm_wgmma_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  float scale = __bfloat162float(__float2bfloat16_rn(score_scale<DH>()));
  const int groups = ((S + BQ - 1) / BQ + kCl - 1) / kCl;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(B * H, groups * kCl);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = kCl;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&mq, &mk, &mv, &F, &L, &pitch, &scale, &out, &S, &H};
  e = cudaLaunchKernelExC(&cfg, (const void*)kernel, args);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int DH>
int launch_f32(const float* q, const float* k, const float* v, const float* F,
               const float* L, float* out, int B, int S, int H,
               cudaStream_t stream) {
  using C = fma_route::Cfg<DH>;
  const float scale = score_scale<DH>();
  cudaError_t e = cudaFuncSetAttribute(
      fma_route::mlstm_fma_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (S + C::BQ - 1) / C::BQ);
  fma_route::mlstm_fma_kernel<DH><<<grid, C::NT, C::SMEM, stream>>>(
      q, k, v, F, L, scale, out, S, H);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int S, int H) {
  return B > 0 && S > 0 && H > 0 && (long long)B * H <= 2147483647LL
         && (S + 15) / 16 <= 65535;
}

}  // namespace

// q, k, v, out: (B, S, H, dh) contiguous in one dtype, 16-byte aligned; F
// (the cumsum of logf over S) and L (logi): (B, H, S) float32 contiguous.
// dh 64 or 384.
extern "C" int mlstm_parallel_bf16(const bf16* q, const bf16* k,
                                   const bf16* v, const float* F,
                                   const float* L, bf16* out, int B, int S,
                                   int H, int dh, cudaStream_t stream) {
  if (!shape_ok(B, S, H)) return (int)cudaErrorInvalidValue;
  if (dh == 64) return launch_bf16<64>(q, k, v, F, L, out, B, S, H, stream);
  if (dh == 384) return launch_bf16<384>(q, k, v, F, L, out, B, S, H, stream);
  return (int)cudaErrorInvalidValue;
}

// The wgmma route: q, k, v, out as above at dh = 384; F and L (B, H,
// pitch) float32, pitch a multiple of 64 (>= S; what lies past S is never
// used), so that each K tile's F and logi are one 256-byte bulk copy.
extern "C" int mlstm_parallel_bf16_wgmma(const bf16* q, const bf16* k,
                                         const bf16* v, const float* F,
                                         const float* L, int pitch,
                                         bf16* out, int B, int S, int H,
                                         int dh, cudaStream_t stream) {
  if (!shape_ok(B, S, H) || dh != wg_route::DH || pitch < S || pitch % 64)
    return (int)cudaErrorInvalidValue;
  return launch_bf16_wgmma(q, k, v, F, L, pitch, out, B, S, H, stream);
}

extern "C" int mlstm_parallel_f32(const float* q, const float* k,
                                  const float* v, const float* F,
                                  const float* L, float* out, int B, int S,
                                  int H, int dh, cudaStream_t stream) {
  if (!shape_ok(B, S, H)) return (int)cudaErrorInvalidValue;
  if (dh == 64) return launch_f32<64>(q, k, v, F, L, out, B, S, H, stream);
  if (dh == 384) return launch_f32<384>(q, k, v, F, L, out, B, S, H, stream);
  return (int)cudaErrorInvalidValue;
}
