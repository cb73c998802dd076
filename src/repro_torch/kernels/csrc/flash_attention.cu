// Causal / sliding-window flash attention, forward, with grouped kv heads:
//   o[b, h, s] = sum_t softmax_t(q[b, h, s] . k[b, hk, t] * scale) v[b, hk, t]
// over the keys t that the mask lets q row s see (t < T; t <= s if causal;
// t > s - window if windowed), hk = h / (H / KV). float32 and bfloat16.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel). It computes what that kernel computes,
// not how: the TPU grid walks (B*H, S/bq, T/bk) in order and carries m, l
// and the accumulator in VMEM from one kv step to the next; here one block
// owns a (b, h, 64-row q tile) and runs the kv loop itself, with the running
// max m, normaliser l and accumulator in registers, all float32, and
// out = acc / max(l, 1e-30). Scores are q.k in float32 times the scale, the
// mask writes -1e30, the probabilities are rounded to the input dtype before
// the product with v (the TPU kernel's p.astype(v.dtype)); l sums them
// unrounded.
//
// Design (a first, simple kernel; no TMA, no wgmma, nothing overlapped).
// A block of 128 threads owns 64 q rows; the q tile is staged once in
// shared memory, each 64-key tile of K and V after it. kv tiles wholly
// above the diagonal (causal) or wholly before the window are never
// visited; the ragged edges of S and T are masked in the kernel (rows past
// S are computed but not written, keys past T are zero and masked). Blocks
// are launched longest causal tile first.
// * bf16 (the model's path): mma.sync m16n8k16 on the tensor cores, four
//   warps of 16 rows each, FlashAttention-2's register reuse of the score
//   fragments as the probabilities' operand (see flash_fwd_mma_kernel).
// * float32: FMA on the CUDA cores (tensor cores would round to TF32):
//   thread (rg, cg) owns 4 rows, 8 keys of a tile and D / 8 output columns,
//   the probabilities go through shared memory (see flash_fwd_kernel).
//
// Layout: q, k, v and o are read and written through their (b, h, s)
// strides with d contiguous, so the model's (B, S, H, D) activations need
// no transposed copy (the wrapper checks 16-byte alignment of every row).
//
// Bound: operations. 4 D FLOPs per (query, visible key) pair and head
// against the bytes of q, k, v and o once; at the model's prefill shape the
// FLOPs dwarf the bytes. Against the bf16 tensor-core peak this version
// loses to its synchronous staging (no copy overlaps the math) and to
// mma.sync's share of that peak; wgmma with TMA-fed tiles is the later
// redesign.
#include <cstdint>

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

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int G, int S, int Tk, Strides st, float scale, int causal,
                 int window) {
  constexpr int PQ = D + 1;   // row pitch of the q and k/v tiles (floats)
  constexpr int DC = D / CG;  // output columns per thread
  extern __shared__ float smem[];
  float* qt = smem;                 // BQ x PQ
  float* kv = smem + BQ * PQ;       // BK x PQ: the K tile, then the V tile
  float* pt = kv + BK * PQ;         // BQ x PP: the tile's probabilities

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / G;
  const int rg = threadIdx.x / CG, cg = threadIdx.x % CG;
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + hk * st.kh;
  const float* vp = v + b * st.vb + hk * st.vh;

  load_tile<D>(qt, qp, st.qs, q0, S);

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
    load_tile<D>(kv, kp, st.ks, k0, Tk);
    __syncthreads();

    float s[RPT][CG];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < CG; ++j) s[r][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
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
    load_tile<D>(kv, vp, st.vs, k0, Tk);
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float pa[RPT], vb[DC];
#pragma unroll
      for (int r = 0; r < RPT; ++r) pa[r] = pt[(rg * RPT + r) * PP + t];
#pragma unroll
      for (int c = 0; c < DC; ++c) vb[c] = kv[t * PQ + cg + CG * c];
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
// The same loop on the tensor cores: mma.sync m16n8k16 (bf16 operands,
// float32 accumulators). Each of the four warps owns 16 q rows. q, and two
// buffers each of K and V, are staged as bf16 rows of pitch D + 8 by
// cp.async, the next kv tile's copies in flight while the current one is
// computed. Fragments come from shared memory by ldmatrix (transposed for
// V, whose rows are keys). The scores' accumulator fragments become the
// probabilities' A fragments in registers, rounded to bf16 there, as in
// FlashAttention-2.
typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of rows r0 .. r0 + 63 of a (n, D) bf16 slab into shared
// memory (row pitch D + 8), 16 bytes each; rows past n are zero-filled.
template <int D>
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src,
                                           long long rs, int r0, int n) {
  constexpr int PER_ROW = D / 8;
  for (int e = threadIdx.x; e < BK * PER_ROW; e += NT) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * 8;
    const bool in = r0 + r < n;
    const bf16* g = in ? src + (long long)(r0 + r) * rs + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * (D + 8) + c)),
                 "l"(g), "r"(in ? 16 : 0));
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                     int G, int S, int Tk, Strides st, float scale, int causal,
                     int window) {
  constexpr int PQ = D + 8;     // bf16 row pitch of every tile
  constexpr int NS = BK / 8;    // score fragments (16 x 8) per warp
  constexpr int NO = D / 8;     // output fragments per warp
  constexpr int TILE = BK * PQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x PQ
  bf16* ks = qs + BQ * PQ;                       // 2 x (BK x PQ)
  bf16* vs = ks + 2 * TILE;                      // 2 x (BK x PQ)

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3, r0 = warp * 16;
  const bf16* qp = q + b * st.qb + h * st.qh;
  const bf16* kp = k + b * st.kb + hk * st.kh;
  const bf16* vp = v + b * st.vb + hk * st.vh;

  int kv_hi = Tk, kv_lo = 0;
  if (causal) kv_hi = min(Tk, q0 + BQ);
  if (window > 0) kv_lo = max(0, q0 - window + 1) / BK * BK;

  stage_async<D>(qs, qp, st.qs, q0, S);
  if (kv_lo < kv_hi) {
    stage_async<D>(ks, kp, st.ks, kv_lo, Tk);
    stage_async<D>(vs, vp, st.vs, kv_lo, Tk);
  }
  cp_async_commit();

  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f}, acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int k0 = kv_lo, cur = 0; k0 < kv_hi; k0 += BK, cur ^= 1) {
    if (k0 + BK < kv_hi) {  // the next tile's copies, into the other buffer
      stage_async<D>(ks + (cur ^ 1) * TILE, kp, st.ks, k0 + BK, Tk);
      stage_async<D>(vs + (cur ^ 1) * TILE, vp, st.vs, k0 + BK, Tk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and q) landed for this thread...
    __syncthreads();     // ...and for every thread
    const bf16* kt = ks + cur * TILE;
    const bf16* vt = vs + cur * TILE;

    // s = q k^T for the warp's 16 rows and the tile's 64 keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qs + (r0 + (lane & 15)) * PQ + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, kt + ((j + (lane >> 4)) * 8 + (lane & 7)) * PQ + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma16816(s[j], a, bb[0], bb[1]);
        mma16816(s[j + 1], a, bb[2], bb[3]);
      }
    }

    // mask, then the online softmax of rows g (i = 0) and g + 8 (i = 1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = q0 + r0 + g + 8 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + j * 8 + tq * 2 + e;
          const bool ok = kpos < Tk && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          float& x = s[j][2 * i + e];
          x = ok ? x * scale : NEG;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * i + e];
          x = expf(x - m_new);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][2 * i] *= alpha;
        acc[j][2 * i + 1] *= alpha;
      }
    }

    // acc += p v, p rounded to bf16 in the A fragments, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * PQ +
                          (j + (lane >> 4)) * 8);
        mma16816(acc[j], a, bb[0], bb[1]);
        mma16816(acc[j + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    bf16* orow = o + b * st.ob + h * st.oh + (long long)row * st.os;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + tq * 2) =
          pack_bf16(acc[j][2 * i] / den, acc[j][2 * i + 1] / den);
  }
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               int B, int H, int KV, int S, int Tk, const Strides& st,
               int causal, int window, cudaStream_t stream) {
  const int smem =
      (int)sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BQ * PP);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      q, k, v, o, H, H / KV, S, Tk, st, 1.0f / sqrtf((float)D), causal,
      window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
                int H, int KV, int S, int Tk, const Strides& st, int causal,
                int window, cudaStream_t stream) {
  const int smem = (int)sizeof(bf16) * (BQ + 4 * BK) * (D + 8);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_mma_kernel<D><<<grid, NT, smem, stream>>>(
      q, k, v, o, H, H / KV, S, Tk, st, 1.0f / sqrtf((float)D), causal,
      window);
  return (int)cudaGetLastError();
}

struct F32 {
  template <int D, typename... A>
  static int run(A... args) { return launch_f32<D>(args...); }
};
struct BF16 {
  template <int D, typename... A>
  static int run(A... args) { return launch_bf16<D>(args...); }
};

template <typename L, typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int B, int H, int KV,
             int S, int Tk, int D, const long long* strides, int causal,
             int window, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Tk <= 0) return 0;
  const long long* x = strides;
  const Strides st{x[0], x[1], x[2], x[3], x[4],  x[5],
                   x[6], x[7], x[8], x[9], x[10], x[11]};
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
// window <= 0: no window. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int B, int H,
                                   int KV, int S, int Tk, int D,
                                   const long long* strides, int causal,
                                   int window, cudaStream_t stream) {
  return dispatch<F32>(q, k, v, o, B, H, KV, S, Tk, D, strides, causal,
                       window, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    int B, int H, int KV, int S, int Tk, int D,
                                    const long long* strides, int causal,
                                    int window, cudaStream_t stream) {
  return dispatch<BF16>(q, k, v, o, B, H, KV, S, Tk, D, strides, causal,
                        window, stream);
}
