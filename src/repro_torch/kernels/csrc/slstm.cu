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
// 768 terms, the exps and a hand-over of h. rz (1.18 MB in bf16 at D =
// 768) is more than one SM's shared memory or registers. Two routes, one
// kernel each:
// * block (every dtype and width; the witness): one block a batch row, a
//   thread a column j; h in shared memory (two buffers, so one barrier a
//   step orders the reads of step t before the writes of step t + 1); c,
//   n and m in the thread's registers for the whole sequence; rz read
//   from L2 every step, coalesced along j (33 us a step at D = 768: the
//   loads a warp keeps in flight, not the L2's rate, set it).
// * cluster (bf16 at D = 768, the main path's): a thread-block cluster of
//   SLSTM_CLUSTER_BLOCKS = 16 blocks a batch row (non-portable: the launch
//   asks the card whether it can place one and fails if not), block r
//   owning columns 48 r .. 48 r + 47. Each column's 16 chains lie in 16
//   lanes, each lane the chain of 48 k of two adjacent columns, whose rz
//   it holds in 96 registers as float32 for the whole sequence (of the
//   168 a thread of 384 may have); a step reads only h from
//   shared memory, as bf16 (16-byte loads of 8 k, widened by a shift or a
//   mask). The lanes' sums meet by four butterfly shuffles (the first
//   hands each lane's other column to its neighbour), and each lane then
//   computes the step of one of its two columns. The new h (bf16, as the
//   step rounds it) is handed over without a cluster barrier: each warp
//   packs its 4 columns into one 8-byte st.async into every block's
//   buffer, counted on that block's mbarrier, and a block waits on its own
//   mbarrier for the step's 1,536 bytes. Two buffers, two mbarriers: a
//   block writes step t + 1's h into a buffer only after it has all of
//   step t's h, which every block sent after reading that buffer for step
//   t - 1. The half of the step that needs no r (the forget and output
//   gates, m, the exps, n: step_pre) is computed while h is in flight.
//   chip_slstm_phases.py times it beside the previous design (8
//   blocks, rz in shared memory, h through distributed shared memory and
//   a cluster barrier a step, 3.50 us a step against this one's 0.99 on
//   the H100).
// Both sum h @ rz in one order, 16 chains of D / 16 consecutive k, each
// an fmaf chain, combined ((a0 + a1) + (a2 + a3)) by fours and the four
// sums so again (a lane's own chains first, then across its lanes by
// shuffles xor 1, 2, 4, 8): the cluster route is bitwise the block route.
// The next step's four gate values are loaded a step ahead, so their
// latency hides behind the chain.
//
// Decode is the same kernel at S = 1 with the cache's (c, n, h, m) as both
// the carry in and the carry out (the same pointers: each thread reads its
// own elements before the loop and writes them after it).
//
// Built with SLSTM_CHAIN_ONLY=1 (the ``slstm_chain`` variant of _build.py),
// the cluster route keeps only its serial chain: a step is the wait for
// h, the dot product of h with the block's columns of rz, the lanes'
// shuffles and the hand-over of h, and h1 is the sum itself rounded to
// bf16 (no gate loads, no step). Its time over S is this design's floor a
// step.
#ifndef SLSTM_CHAIN_ONLY
#define SLSTM_CHAIN_ONLY 0
#endif
#ifndef SLSTM_CLUSTER_BLOCKS
#define SLSTM_CLUSTER_BLOCKS 16
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

// The step split in two for the cluster route, the same operations in the
// same order: the half that needs no r (the forget and output gates, m,
// the exps and n, carried here), computed while h is handed over, and the
// half that does (z, c and h1).
struct StepPre {
  float ot, ip, fp;
};

template <typename T>
__device__ __forceinline__ StepPre step_pre(float it, float ft_in,
                                            float ot_in, float bias,
                                            float& n, float& m) {
  StepPre s;
  const float ft = log_sigmoid(ft_in + bias);
  s.ot = round_x<T>(sigmoid(ot_in));
  const float fm = ft + m;
  const float m1 = fmaxf(fm, it);
  s.ip = expf(it - m1);
  s.fp = expf(fm - m1);
  n = fmaf(s.fp, n, s.ip);
  m = m1;
  return s;
}

template <typename T>
__device__ __forceinline__ float step_post(float zt_in, float r_sum,
                                           const StepPre& s, float& c,
                                           float n) {
  const float r = round_x<T>(r_sum);
  const float zt = round_x<T>(tanhf(round_x<T>(zt_in + r)));
  c = fmaf(s.fp, c, s.ip * zt);
  return round_x<T>(s.ot * round_x<T>(c / fmaxf(n, 1e-6f)));
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
constexpr int kD = 768;                    // the width it is built for
constexpr int kCL = SLSTM_CLUSTER_BLOCKS;  // blocks a cluster (a batch row)
constexpr int kQ = kChains;                // lanes a column, a chain each
constexpr int kC = 2;                      // columns a lane (a chain of each)
constexpr int kNC = kD / kCL;              // columns a block
constexpr int kThreads = kNC / kC * kQ;
constexpr int kK = kD / kQ;                // a lane's k, its chains' length
constexpr int kHQ = kK + 8;                // a lane's k in h's buffer, padded
constexpr int kHB = kQ * kHQ;              // one buffer of h, bf16
constexpr unsigned kTxBytes = kD * 2;      // h's bytes a block gets a step
// h's two buffers, then their two mbarriers
constexpr int kSmem = 2 * kHB * 2 + 16;
static_assert(32 / kQ * kC == 4 && kD % (4 * kCL) == 0 && kCL <= 32
                  && kK % 8 == 0,
              "a warp's 4 columns are one 8-byte send a block");

// h's buffer index of k: each lane's k padded by 8 bf16 (conflict-free
// 16-byte reads of a quarter warp's lanes)
__device__ __forceinline__ int hpad(int k) { return k + 8 * (k / kK); }

__device__ __forceinline__ float lo_bf16(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
// the bf16 bits of a float that is a bf16 value (h is rounded to bf16)
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __float_as_uint(v) >> 16;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The address of this block's shared address a in block r of the cluster
__device__ __forceinline__ unsigned at_rank(unsigned a, int r) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(a), "r"(r));
  return out;
}

// Arrive on an mbarrier and have its phase wait for `bytes` more
__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Whether the phase of parity `parity` of an mbarrier is complete, and so
// the bytes its st.async stores counted in this block's shared memory
// (the default acquire at the block's scope: the data are shared memory,
// which no L1 line caches, so no cluster-scope invalidation of L1 a step)
__device__ __forceinline__ bool phase_done(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred ok;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 ok, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, ok;\n\t}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for that phase. A hand-over that never completes (a fault) traps
// after kWaitCycles instead of holding the card
constexpr long long kWaitCycles = 20000000000LL;   // ~10 s
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  if (phase_done(bar, parity)) return;
  const long long start = clock64();
  while (!phase_done(bar, parity))
    if (clock64() - start > kWaitCycles) __trap();
}

// 8 bytes into another block's shared memory (cluster addresses), counted
// on its mbarrier
__device__ __forceinline__ void send8(unsigned dst, unsigned lo, unsigned hi,
                                      unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];"
      :: "r"(dst), "r"(lo), "r"(hi), "r"(bar) : "memory");
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
  bf16* hb = reinterpret_cast<bf16*>(smem_raw);
  const unsigned bar0 = smem_addr(smem_raw + 2 * kHB * 2);  // bar1: + 8
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCL;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int q = lane % kQ;
  // the lane's dot product covers columns j0 .. j0 + kC - 1; its step is
  // that of column jm (the kQ lanes of a column group share the kC steps)
  const int j0 = rank * kNC + warp * 4 + lane / kQ * kC;
  const int cm = q % kC, jm = j0 + cm;
  // this lane's k of its two columns of rz as float32 (96 registers), for
  // the whole sequence (a row's two columns in one 4-byte load). ptxas
  // keeps them widened (141 registers a thread); a build that keeps the
  // bf16 pairs and widens them again every step (125 registers, ~40 more
  // instructions in the dot) runs a step 30% slower on the H100
  // (chip_slstm_phases.py), so check its register count after an edit
  float w[kC][kK];
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
        rz + (long long)(q * kK + i) * kD + j0);
    w[0][i] = __low2float(v);
    w[1][i] = __high2float(v);
  }
  // every block loads the whole h of its batch row
  for (int k = threadIdx.x; k < kD; k += kThreads)
    hb[hpad(k)] = h0 ? h0[(long long)b * kD + k] : __float2bfloat16_rn(0.0f);
  // h_u lands in buffer u & 1, counted on mbarrier u & 1 (u >= 1): the
  // first two phases armed here, each later one once its buffer's last
  // phase is complete
  if (threadIdx.x == 0) {
    for (int p = 0; p < 2; ++p)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(bar0 + 8 * p), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (S >= 2) expect_bytes(bar0 + 8, kTxBytes);
    if (S >= 3) expect_bytes(bar0, kTxBytes);
  }
  // lane r < kCL sends the warp's 4 columns to block r: their addresses
  // there in both buffers, and both mbarriers
  const int first = rank * kNC + warp * 4;
  unsigned dst_h0 = 0, dst_h1 = 0, dst_bar0 = 0, dst_bar1 = 0;
  if (lane < kCL) {
    dst_h0 = at_rank(smem_addr(hb + hpad(first)), lane);
    dst_h1 = at_rank(smem_addr(hb + kHB + hpad(first)), lane);
    dst_bar0 = at_rank(bar0, lane);
    dst_bar1 = at_rank(bar0 + 8, lane);
  }
  const long long cj = (long long)b * kD + jm;
  float c = c0 ? c0[cj] : 0.0f;
  float n = n0 ? n0[cj] : 0.0f;
  float m = m0 ? m0[cj] : 0.0f;
  float h = h0 ? __bfloat162float(h0[cj]) : 0.0f;
  const float bias = __bfloat162float(bf[jm]);
  const long long g0 = (long long)b * bs + jm;
  bf16 z_n, i_n, f_n, o_n;   // the next step's gate inputs
  float zt_in = 0.0f;        // this step's z input
  StepPre pre = {};          // this step's r-free half
#if !SLSTM_CHAIN_ONLY
  if (S > 0) {
    zt_in = __bfloat162float(gz[g0]);
    pre = step_pre<bf16>(__bfloat162float(gi[g0]),
                         __bfloat162float(gf[g0]),
                         __bfloat162float(go[g0]), bias, n, m);
  }
  if (S > 1) {
    const long long g = g0 + ld;
    z_n = gz[g], i_n = gi[g], f_n = gf[g], o_n = go[g];
  }
#endif
  cluster.sync();   // the mbarriers armed, h_0 in place, and every block of
                    // the cluster on its SM before any writes into another's
  for (int t = 0; t < S; ++t) {
    const int p = t & 1;
    if (t > 0) {
      // h_t from every block: phase (t - 1) / 2 of mbarrier p
      wait_phase(bar0 + 8 * p, ((t - 1) >> 1) & 1);
      if (threadIdx.x == 0 && t + 2 < S) expect_bytes(bar0 + 8 * p, kTxBytes);
    }
    const uint4* h8 = reinterpret_cast<const uint4*>(hb + p * kHB + q * kHQ);
    // chain q of both columns, k rising
    float a[kC] = {0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kK; k += 8) {
      const uint4 hw = h8[k / 8];
      const float hv[8] = {lo_bf16(hw.x), hi_bf16(hw.x), lo_bf16(hw.y),
                           hi_bf16(hw.y), lo_bf16(hw.z), hi_bf16(hw.z),
                           lo_bf16(hw.w), hi_bf16(hw.w)};
#pragma unroll
      for (int cc = 0; cc < kC; ++cc)
#pragma unroll
        for (int u = 0; u < 8; ++u) a[cc] = fmaf(hv[u], w[cc][k + u], a[cc]);
    }
    // column jm's chains, combined as the block route combines them: the
    // first exchange hands each lane's other column's chain to its
    // neighbour, which keeps that column; then across the column's lanes
    float r_sum = (cm ? a[1] : a[0])
                  + __shfl_xor_sync(0xffffffffu, cm ? a[0] : a[1], 1);
#pragma unroll
    for (int x = 2; x < kQ; x *= 2)
      r_sum += __shfl_xor_sync(0xffffffffu, r_sum, x);
#if SLSTM_CHAIN_ONLY
    h = round_x<bf16>(r_sum);
#else
    h = step_post<bf16>(zt_in, r_sum, pre, c, n);
#endif
    if (t + 1 < S) {
      // h_{t+1} of the warp's 4 columns (column w's step is lane
      // w / kC * kQ + w % kC's), 8 bytes by lane r into buffer p ^ 1 of
      // block r
      unsigned hw[4];
#pragma unroll
      for (int w = 0; w < 4; ++w)
        hw[w] = bf16_bits(__shfl_sync(0xffffffffu, h, w / kC * kQ + w % kC));
      if (lane < kCL) {
        if (p) send8(dst_h0, hw[0] | hw[1] << 16, hw[2] | hw[3] << 16,
                     dst_bar0);
        else send8(dst_h1, hw[0] | hw[1] << 16, hw[2] | hw[3] << 16,
                   dst_bar1);
      }
    }
    if (q < kC) hs[((long long)b * S + t) * kD + jm] = __float2bfloat16_rn(h);
#if !SLSTM_CHAIN_ONLY
    if (t + 1 < S) {
      zt_in = __bfloat162float(z_n);
      pre = step_pre<bf16>(__bfloat162float(i_n), __bfloat162float(f_n),
                           __bfloat162float(o_n), bias, n, m);
      if (t + 2 < S) {
        const long long g = g0 + (long long)(t + 2) * ld;
        z_n = gz[g], i_n = gi[g], f_n = gf[g], o_n = go[g];
      }
    }
#endif
  }
  cluster.sync();   // no block leaves while another may write into it
  if (q < kC) {
    if (c_out) c_out[cj] = c;
    if (n_out) n_out[cj] = n;
    if (m_out) m_out[cj] = m;
    if (h_out) h_out[cj] = __float2bfloat16_rn(h);
  }
}

// A launch refused before it was made: the runtime's error is cleared, so
// that it is not reported again by the next launch's cudaGetLastError
int refuse(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
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
  if (e == cudaSuccess && kCL > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return refuse(e);
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
  // a cluster the card cannot place is refused here, not left to hang or
  // to run elsewhere
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (e != cudaSuccess) return refuse(e);
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
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
