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
// Two routes, one kernel each:
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
//   heaviest first (the diagonal's last tiles have the most keys).
// * fma (float32, dh 64 or 384), mlstm_fma_kernel: a block of 128 threads
//   takes 16 query rows, tiles of 16 keys, every product a float32 FMA
//   chain on the CUDA cores (mma.sync on float32 would be TF32). The route
//   of the checks and the tests; no main path runs float32.
// Sums run in other orders than the reference's (the tiles, the den's
// partials, the mma's tree), so both routes are held to tolerances, not
// bits; the file is built without -fmad=false.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// block loading the chunk (a block's rows read each key: from L2, F and
// logi of one (b, h), 256 KB at S = 32768, outrun the L1) and each row
// reading four keys a load; the same maxima in the same order of terms.
constexpr int kMC = 1024;
template <int kLanes, int kThreads>
__device__ __forceinline__ float row_max_staged(const float* F,
                                                const float* L, int i, int S,
                                                int sub, int last,
                                                float* stage) {
  float* fs = stage;
  float* ls = stage + kMC;
  float mx = -__int_as_float(0x7f800000);   // -inf
  const float fi = i < S ? F[i] : 0.0f;
  for (int j0 = 0; j0 <= last; j0 += kMC) {
    __syncthreads();   // the chunk before read
    for (int x = threadIdx.x; x < kMC; x += kThreads) {
      const bool ok = j0 + x < S;
      fs[x] = ok ? F[j0 + x] : 0.0f;
      ls[x] = ok ? L[j0 + x] : 0.0f;
    }
    __syncthreads();
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
      Fb, Lb, i0 + tid / 4, S, tid % 4, last, reinterpret_cast<float*>(s.p));
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

extern "C" int mlstm_parallel_f32(const float* q, const float* k,
                                  const float* v, const float* F,
                                  const float* L, float* out, int B, int S,
                                  int H, int dh, cudaStream_t stream) {
  if (!shape_ok(B, S, H)) return (int)cudaErrorInvalidValue;
  if (dh == 64) return launch_f32<64>(q, k, v, F, L, out, B, S, H, stream);
  if (dh == 384) return launch_f32<384>(q, k, v, F, L, out, B, S, H, stream);
  return (int)cudaErrorInvalidValue;
}
