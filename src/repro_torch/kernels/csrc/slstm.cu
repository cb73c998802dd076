// The sLSTM recurrence, forward: for each batch row b and step t, from the
// carry (c, n, h, m),
//   r  = x(h @ rz)                          (float32 sum, rounded once)
//   z  = x(tanh(x(gz_t + r)))
//   i  = gi_t,  f = log_sigmoid(gf_t + bf),  o = x(sigmoid(go_t))
//   m1 = max(f + m, i),  ip = exp(i - m1),  fp = exp(f + m - m1)
//   c1 = fma(fp, c, ip z),  n1 = fma(fp, n, ip)
//   h1 = x(o x(c1 / max(n1, 1e-6)))
// with c, n, m and the gates' exponents float32 and h in the inputs'
// dtype; x() rounds to that dtype (float32 or bfloat16). hs[b, t] = h1.
//
// Replaces the reference's lax.scan over _slstm_step,
// src/repro/models/xlstm.py:138 (the step at :116-130). Not Pallas: XLA's
// while loop, one dependent (B, D) x (D, D) product a step. The input
// projections gz, gi, gf, go do not depend on h: the caller computes them
// for every step in one GEMM, and this kernel runs the whole time loop in
// one launch, so no step goes back to the host. Rounding: the reference's
// points above; XLA-CPU contracts fp * c + ip * z and fp * n + ip into one
// FMA each, written here as fmaf; the file is built with -fmad=false
// (_build.flags) so that nvcc adds no other contraction. The sum h @ rz
// runs in another order than the reference's dot (sixteen chains over k,
// below), so the kernel is held to tolerances, not bits.
//
// Bound: the serial chain. Each step needs the whole of the previous h: at
// xlstm-125m's (B, S, D) = (1, 32768, 768) a step's h @ rz is 590k
// multiply-adds (1.2e-3 ms of the card at 989 TFLOP/s over 32768 steps:
// nothing), but no step can start before the one before it ends, so the
// floor is 32768 times one step's latency: a read of h, a dot product of
// 768 terms, the exps and a barrier. rz (1.18 MB in bf16 at D = 768) is
// more than one SM's shared memory. Two routes, one kernel each:
// * block (every dtype and width; the witness): one block a batch row, a
//   thread a column j; h in shared memory (two buffers, so one barrier a
//   step orders the reads of step t before the writes of step t + 1); c,
//   n and m in the thread's registers for the whole sequence; rz read
//   from L2 every step, coalesced along j (33 us a step at D = 768: the
//   loads a warp keeps in flight, not the L2's rate, set it).
// * cluster (bf16 at D = 768, the main path's): a thread-block cluster of
//   8 blocks a batch row, block r holding columns 96 r .. 96 r + 95 of rz
//   in its shared memory for the whole sequence (147 KB); each column's
//   dot product split over 4 lanes (a quarter of k each), which end with
//   the same sum by two butterfly shuffles and all compute the step; the
//   new h written into every block's buffer through distributed shared
//   memory (each lane to two blocks), then one cluster barrier a step.
// Both sum h @ rz in one order, 16 chains of D / 16 consecutive k, each
// an fmaf chain, combined ((a0 + a1) + (a2 + a3)) by fours and the four
// sums so again: the cluster route is bitwise the block route.
// The next step's four gate values are loaded before this step's dot
// product, so their latency hides behind it.
//
// Decode is the same kernel at S = 1 with the cache's (c, n, h, m) as both
// the carry in and the carry out (the same pointers: each thread reads its
// own elements before the loop and writes them after it).
//
// Built with SLSTM_CHAIN_ONLY=1 (the ``slstm_chain`` variant of _build.py),
// the cluster route keeps only its serial chain: a step is the dot product
// of h with the block's columns of rz, the lanes' shuffles, the write of h
// into every block and the cluster barrier, and h1 is the sum itself (no
// gate loads, no step). Its time over S is this design's floor a step.
#ifndef SLSTM_CHAIN_ONLY
#define SLSTM_CHAIN_ONLY 0
#endif
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxD = 1024;   // a thread a column
constexpr int kChains = 16;   // h @ rz's chains (D a multiple of 16)

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and widened again
template <typename T>
__device__ __forceinline__ float round_x(float v) {
  return to_f<T>(from_f<T>(v));
}

// jax.nn.log_sigmoid(x) = -softplus(-x), softplus(y) = logaddexp(y, 0) =
// max(y, 0) + log1p(exp(-|y|))
__device__ __forceinline__ float log_sigmoid(float x) {
  const float y = -x;
  return -(fmaxf(y, 0.0f) + log1pf(expf(-fabsf(y))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The four chains' sums of a group, combined as every route combines them
__device__ __forceinline__ float sum4(const float* a) {
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// One step of the carry (c, n, m) of a column from its gate inputs and r,
// the float32 sum of h @ rz; returns the new h (rounded to T).
template <typename T>
__device__ __forceinline__ float step(float zt_in, float it, float ft_in,
                                      float ot_in, float r_sum, float bias,
                                      float& c, float& n, float& m) {
  const float r = round_x<T>(r_sum);
  const float zt = round_x<T>(tanhf(round_x<T>(zt_in + r)));
  const float ft = log_sigmoid(ft_in + bias);
  const float ot = round_x<T>(sigmoid(ot_in));
  const float fm = ft + m;
  const float m1 = fmaxf(fm, it);
  const float ip = expf(it - m1);
  const float fp = expf(fm - m1);
  c = fmaf(fp, c, ip * zt);
  n = fmaf(fp, n, ip);
  m = m1;
  return round_x<T>(ot * round_x<T>(c / fmaxf(n, 1e-6f)));
}

template <typename T>
__global__ void __launch_bounds__(kMaxD)
    slstm_kernel(const T* __restrict__ gz, const T* __restrict__ gi,
                 const T* __restrict__ gf, const T* __restrict__ go,
                 long long ld, long long bs, const T* __restrict__ rz,
                 const T* __restrict__ bf, const float* c0, const float* n0,
                 const T* h0, const float* m0, float* c_out, float* n_out,
                 T* h_out, float* m_out, T* __restrict__ hs, int S, int D) {
  __shared__ float hbuf[2][kMaxD];
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const long long cj = (long long)b * D + j;
  float c = c0 ? c0[cj] : 0.0f;
  float n = n0 ? n0[cj] : 0.0f;
  float m = m0 ? m0[cj] : 0.0f;
  float h = h0 ? to_f<T>(h0[cj]) : 0.0f;
  const float bias = to_f<T>(bf[j]);
  hbuf[0][j] = h;
  const long long g0 = (long long)b * bs + j;
  T z_n, i_n, f_n, o_n;  // the next step's gate inputs
  if (S > 0) {
    z_n = gz[g0], i_n = gi[g0], f_n = gf[g0], o_n = go[g0];
  }
  __syncthreads();
  for (int t = 0; t < S; ++t) {
    const float zt_in = to_f<T>(z_n), it = to_f<T>(i_n);
    const float ft_in = to_f<T>(f_n), ot_in = to_f<T>(o_n);
    if (t + 1 < S) {
      const long long g = g0 + (long long)(t + 1) * ld;
      z_n = gz[g], i_n = gi[g], f_n = gf[g], o_n = go[g];
    }
    const float* hp = hbuf[t & 1];
    const int len = D / kChains;
    float a[kChains];
#pragma unroll
    for (int e = 0; e < kChains; ++e) a[e] = 0.0f;
    for (int i = 0; i < len; ++i) {
#pragma unroll
      for (int e = 0; e < kChains; ++e) {
        const int k = e * len + i;
        a[e] = fmaf(hp[k], to_f<T>(rz[(long long)k * D + j]), a[e]);
      }
    }
    const float r_sum = (sum4(a) + sum4(a + 4)) + (sum4(a + 8) + sum4(a + 12));
    h = step<T>(zt_in, it, ft_in, ot_in, r_sum, bias, c, n, m);
    hbuf[(t + 1) & 1][j] = h;
    hs[((long long)b * S + t) * D + j] = from_f<T>(h);
    __syncthreads();
  }
  if (c_out) c_out[cj] = c;
  if (n_out) n_out[cj] = n;
  if (m_out) m_out[cj] = m;
  if (h_out) h_out[cj] = from_f<T>(h);
}

namespace cluster_route {

typedef __nv_bfloat16 bf16;
constexpr int kD = 768;                 // the width it is built for
constexpr int kCL = 8;                  // blocks a cluster (portable)
constexpr int kNC = kD / kCL;           // columns a block
constexpr int kQ = 4;                   // lanes a column
constexpr int kThreads = kNC * kQ;      // 384
constexpr int kLen = kD / kChains;      // a chain's k
constexpr int kQuads = kD / 4;          // rz rows in fours
constexpr int kQuadsQ = kQuads / kQ;    // a lane's quads (its quarter of k)
constexpr int kHQ = kD / kQ + 4;        // a quarter's pitch in h's buffer
// rz's columns of the block as (quad of k, column) uint2 of four bf16,
// then h's two buffers
constexpr int kSmem = kQuads * kNC * 8 + 2 * kQ * kHQ * 4;
static_assert(kD % (kChains * 4) == 0 && kChains == 4 * kQ && kNC % 8 == 0,
              "a lane's 4 chains are whole quads of its quarter");

// The column that quad row u of lane quarter q holds column c at: lanes
// of one warp (8 columns, 4 quarters) read 8-byte words of distinct banks
__device__ __forceinline__ int swz(int c, int q) { return (c + 8 * q) % kNC; }

// h's buffer index of k: quarters padded by 4 floats (conflict-free
// 16-byte reads of four quarters at once)
__device__ __forceinline__ int hpad(int k) { return k + 4 * (k / (kD / kQ)); }

__device__ __forceinline__ float lo_bf16(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__global__ void __launch_bounds__(kThreads, 1)
    slstm_cluster_kernel(const bf16* __restrict__ gz,
                         const bf16* __restrict__ gi,
                         const bf16* __restrict__ gf,
                         const bf16* __restrict__ go, long long ld,
                         long long bs, const bf16* __restrict__ rz,
                         const bf16* __restrict__ bf, const float* c0,
                         const float* n0, const bf16* h0, const float* m0,
                         float* c_out, float* n_out, bf16* h_out,
                         float* m_out, bf16* __restrict__ hs, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint2* rzs = reinterpret_cast<uint2*>(smem_raw);
  float* hb = reinterpret_cast<float*>(smem_raw + kQuads * kNC * 8);
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCL;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = warp * 8 + lane / kQ, q = lane % kQ;
  const int j = rank * kNC + col;
  // this block's columns of rz, four k a word pair
  for (int i = threadIdx.x; i < kQuads * kNC; i += kThreads) {
    const int u = i / kNC, cc = i % kNC;
    const bf16* at = rz + (long long)(4 * u) * kD + rank * kNC + cc;
    uint2 w;
    w.x = (unsigned)__bfloat16_as_ushort(at[0])
          | ((unsigned)__bfloat16_as_ushort(at[kD]) << 16);
    w.y = (unsigned)__bfloat16_as_ushort(at[2 * kD])
          | ((unsigned)__bfloat16_as_ushort(at[3 * kD]) << 16);
    rzs[u * kNC + swz(cc, u / kQuadsQ)] = w;
  }
  // every block loads the whole h of its batch row
  for (int k = threadIdx.x; k < kD; k += kThreads)
    hb[hpad(k)] = h0 ? __bfloat162float(h0[(long long)b * kD + k]) : 0.0f;
  const long long cj = (long long)b * kD + j;
  float c = c0 ? c0[cj] : 0.0f;
  float n = n0 ? n0[cj] : 0.0f;
  float m = m0 ? m0[cj] : 0.0f;
  float h = h0 ? __bfloat162float(h0[cj]) : 0.0f;
  const float bias = __bfloat162float(bf[j]);
  const long long g0 = (long long)b * bs + j;
  bf16 z_n, i_n, f_n, o_n;
  if (S > 0) {
    z_n = gz[g0], i_n = gi[g0], f_n = gf[g0], o_n = go[g0];
  }
  const uint2* wr = rzs + swz(col, q);
  cluster.sync();   // rz and h in place, and every block of the cluster on
                    // its SM before any writes into another's memory
  for (int t = 0; t < S; ++t) {
#if !SLSTM_CHAIN_ONLY
    const float zt_in = __bfloat162float(z_n), it = __bfloat162float(i_n);
    const float ft_in = __bfloat162float(f_n), ot_in = __bfloat162float(o_n);
    if (t + 1 < S) {
      const long long g = g0 + (long long)(t + 1) * ld;
      z_n = gz[g], i_n = gi[g], f_n = gf[g], o_n = go[g];
    }
#endif
    const float4* h4 = reinterpret_cast<const float4*>(hb + (t & 1) * kQ * kHQ);
    float a[kQ];
#pragma unroll
    for (int e = 0; e < kQ; ++e) a[e] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < kLen / 4; ++i) {
#pragma unroll
      for (int e = 0; e < kQ; ++e) {
        const int u = (kQ * q + e) * (kLen / 4) + i;   // chain 4 q + e
        const uint2 w = wr[u * kNC];
        const float4 hv = h4[u + q];                    // hpad(4 u) / 4
        a[e] = fmaf(hv.x, lo_bf16(w.x), a[e]);
        a[e] = fmaf(hv.y, hi_bf16(w.x), a[e]);
        a[e] = fmaf(hv.z, lo_bf16(w.y), a[e]);
        a[e] = fmaf(hv.w, hi_bf16(w.y), a[e]);
      }
    }
    // the four lanes' sums of the column, combined as the block route does
    float r_sum = sum4(a);
    r_sum += __shfl_xor_sync(0xffffffffu, r_sum, 1);
    r_sum += __shfl_xor_sync(0xffffffffu, r_sum, 2);
#if SLSTM_CHAIN_ONLY
    h = r_sum;
#else
    h = step<bf16>(zt_in, it, ft_in, ot_in, r_sum, bias, c, n, m);
#endif
    float* next = hb + ((t + 1) & 1) * kQ * kHQ + hpad(j);
#pragma unroll
    for (int r = 0; r < kCL / kQ; ++r)
      *cluster.map_shared_rank(next, q * (kCL / kQ) + r) = h;
    if (q == 0) hs[((long long)b * S + t) * kD + j] = __float2bfloat16_rn(h);
    cluster.sync();
  }
  if (q == 0) {
    if (c_out) c_out[cj] = c;
    if (n_out) n_out[cj] = n;
    if (m_out) m_out[cj] = m;
    if (h_out) h_out[cj] = __float2bfloat16_rn(h);
  }
}

int launch(const bf16* gz, const bf16* gi, const bf16* gf, const bf16* go,
           long long ld, long long bs, const bf16* rz, const bf16* bf,
           const float* c0, const float* n0, const bf16* h0, const float* m0,
           float* c_out, float* n_out, bf16* h_out, float* m_out, bf16* hs,
           int batch, int S, cudaStream_t stream) {
  if (batch <= 0 || S < 0 || (long long)batch * kCL > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  auto kernel = slstm_cluster_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(batch * kCL);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&gz, &gi, &gf, &go, &ld, &bs, &rz, &bf, &c0, &n0, &h0,
                  &m0, &c_out, &n_out, &h_out, &m_out, &hs, &S};
  e = cudaLaunchKernelExC(&cfg, (const void*)kernel, args);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace cluster_route

template <typename T>
int launch(const T* gz, const T* gi, const T* gf, const T* go, long long ld,
           long long bs, const T* rz, const T* bf, const float* c0,
           const float* n0, const T* h0, const float* m0, float* c_out,
           float* n_out, T* h_out, float* m_out, T* hs, int batch, int S,
           int D, cudaStream_t stream) {
  if (batch <= 0 || S < 0 || D <= 0 || D > kMaxD || D % kChains)
    return (int)cudaErrorInvalidValue;
  slstm_kernel<T><<<batch, D, 0, stream>>>(gz, gi, gf, go, ld, bs, rz, bf,
                                           c0, n0, h0, m0, c_out, n_out,
                                           h_out, m_out, hs, S, D);
  return (int)cudaGetLastError();
}

}  // namespace

// gz, gi, gf, go: (batch, S, D) in one dtype, element (b, t, j) at b * bs +
// t * ld + j (views of one (batch, S, 4 D) projection: ld = 4 D); rz (D,
// D), bf (D,) and hs (batch, S, D) contiguous in that dtype; the carry in
// (c0, n0, h0, m0) and out (c_out, n_out, h_out, m_out): (batch, D), h in
// the inputs' dtype, the others float32, each null or not (a null carry in
// is zeros; the carry out may be the carry in). D a multiple of 16 up to
// 1024 (the block route); the cluster route: bf16 at D = 768.
extern "C" int slstm_scan_f32(const float* gz, const float* gi,
                              const float* gf, const float* go, long long ld,
                              long long bs, const float* rz, const float* bf,
                              const float* c0, const float* n0,
                              const float* h0, const float* m0, float* c_out,
                              float* n_out, float* h_out, float* m_out,
                              float* hs, int batch, int S, int D,
                              cudaStream_t stream) {
  return launch<float>(gz, gi, gf, go, ld, bs, rz, bf, c0, n0, h0, m0, c_out,
                       n_out, h_out, m_out, hs, batch, S, D, stream);
}

extern "C" int slstm_scan_bf16(
    const __nv_bfloat16* gz, const __nv_bfloat16* gi, const __nv_bfloat16* gf,
    const __nv_bfloat16* go, long long ld, long long bs,
    const __nv_bfloat16* rz, const __nv_bfloat16* bf, const float* c0,
    const float* n0, const __nv_bfloat16* h0, const float* m0, float* c_out,
    float* n_out, __nv_bfloat16* h_out, float* m_out, __nv_bfloat16* hs,
    int batch, int S, int D, cudaStream_t stream) {
  return launch<__nv_bfloat16>(gz, gi, gf, go, ld, bs, rz, bf, c0, n0, h0,
                               m0, c_out, n_out, h_out, m_out, hs, batch, S,
                               D, stream);
}

extern "C" int slstm_scan_bf16_cluster(
    const __nv_bfloat16* gz, const __nv_bfloat16* gi, const __nv_bfloat16* gf,
    const __nv_bfloat16* go, long long ld, long long bs,
    const __nv_bfloat16* rz, const __nv_bfloat16* bf, const float* c0,
    const float* n0, const __nv_bfloat16* h0, const float* m0, float* c_out,
    float* n_out, __nv_bfloat16* h_out, float* m_out, __nv_bfloat16* hs,
    int batch, int S, int D, cudaStream_t stream) {
  if (D != cluster_route::kD) return (int)cudaErrorInvalidValue;
  return cluster_route::launch(gz, gi, gf, go, ld, bs, rz, bf, c0, n0, h0, m0,
                               c_out, n_out, h_out, m_out, hs, batch, S,
                               stream);
}
