// Mamba's selective scan with its C contraction, forward:
//   h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + x(dt_t[d] u_t[d]) B_t[n]
//   y_t[d]    = x(sum_n h_t[d, n] C_t[n])
// for each batch row b, channel d < Din and state n < 16 (St), from h_{-1} =
// h0 (zeros when none is given); the final state h_{S-1} is written to h_out
// when asked for. x() rounds to the inputs' dtype (float32 or bfloat16): u,
// dt, B and C and y are in that dtype, A, h0, h_out and the state float32.
//
// Replaces the reference's chunked scan, src/repro/models/ssm.py:103 (a
// lax.scan over _ssm_chunk, whose associative_scan at :51 composes a chunk
// of 256 steps) together with the C contraction at :107 and the decode step
// at :105. Not Pallas: XLA's loop. It keeps the reference's rounding points
// (ssm.py:86-88, :107): dA = exp(float32(dt) * A); dBx = float32(x(dt * u))
// * float32(B), the product dt * u rounded to the inputs' dtype before it is
// widened (exact in float32 for two bf16 values, then one rounding); the
// state in float32; y the float32 sum over n, rounded once. XLA-CPU
// contracts a h + b into one FMA, so the recurrence is one fmaf. Its order
// of sums differs from the reference's in two places, the scan's tree
// (here: the sequential recurrence) and the sum over n (here: an FMA chain
// over a lane's 4 states, then a tree over 4 lanes), so it is held to
// tolerances, not bits: it is not one of _build.BITWISE_SOURCES and is
// built without -fmad=false.
//
// Bound: the exps. One exp per (b, t, d, n): at Jamba's prefill, (B, S,
// Din, St) = (1, 32768, 8192, 16), 4.29e9 of them at the SFU's 16 a clock
// on each of 132 SMs at 1,980 MHz is 1.03 ms, above the 0.48 ms that u
// and dt read and y written (bf16, 1.61 GB) take at 3.35 TB/s. So:
// * the state lives in registers for the whole sequence and the time loop
//   runs inside the block: nothing of the (B, S, Din, St) tensors the
//   reference materialises (dA, dBx, the scan's a_c and b_c, h: 17.2 GB
//   each at that shape) touches memory;
// * a channel's 16 states are spread over 4 lanes of 4 states each: at B
//   = 1 a thread a channel would be 8,192 threads on 132 SMs, a thread a
//   state puts twice the shared-memory reads and five times the shuffles
//   on the same queue as the exps (the SFU's MUFU issues through the MIO
//   queue with LDS and SHFL). Here a step of a lane is one 8-byte read
//   (dt and x(dt u) of its channel) and two 16-byte reads (its 4 B and 4
//   C), 4 exps, and the sum over n is a lane's FMA chain, then a
//   reduce-scatter over the 4 lanes taken 4 steps at a time (3 shuffles
//   for 4 steps, lane q keeping step q's sum);
// * each exp is one MUFU.EX2 behind the product dt * A (and its scaling
//   by log2(e)), with no test around it (exp2_ftz);
// * a block of 32 channels (128 threads; two blocks an SM overlap each
//   other's barriers) copies a round of 32 steps of dt, u, B and C into
//   shared memory with cp.async, the next round in flight while this one
//   computes (a load into registers held its scoreboard, and the first
//   shared-memory read that waited on the same one stalled on it), widens
//   the landed round into (dt, x(dt u)) and B, C tiles of floats, and
//   writes y through shared memory as rows of 32 channels.
// A ragged S needs no padding: the last group of a round that passes S
// leaves the state alone on its steps past S, whose y is not written.
// Decode is the same kernel at S = 1 with the cache's state as h0 and
// h_out (the same pointer: each thread reads its elements before the loop
// and writes them after). Din must be a multiple of 8 (bf16) or 4
// (float32) and u, dt, B and C 16-byte aligned (the wrapper checks), for
// the 16-byte copies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kState = 16;                       // St
constexpr int kLanes = 4;                        // lanes a channel
constexpr int kPer = kState / kLanes;            // states a lane
constexpr int kChannels = 32;                    // channels a block
constexpr int kThreads = kChannels * kLanes;
constexpr int kSteps = 32;                       // steps staged a round
constexpr int kGroup = kLanes;                   // steps a reduce-scatter
constexpr int kPairs = kSteps * kChannels / 2 / kThreads;  // dt, u pairs
constexpr int kStatePairs = kSteps * kState / 2 / kThreads;  // B, C pairs
// s.y's row: lane q of a channel stores 32 / kLanes q banks on, so a
// warp's (lane, channel) stores fall on 32 banks
constexpr int kYRow = kChannels + 32 / kLanes;
static_assert((kPer == 2 || kPer == 4) && kSteps % kGroup == 0 &&
                  kSteps * kChannels % (2 * kThreads) == 0 &&
                  kSteps * kState % (2 * kThreads) == 0,
              "a round's staging and the reduce-scatter assume these");

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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
__device__ __forceinline__ float round_x(float v);
template <>
__device__ __forceinline__ float round_x<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_x<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 2^x on the SFU, denormal results flushed to zero: one MUFU.EX2. (The
// non-flushing form that __expf compiles to without -ftz wraps each
// MUFU.EX2 in a test and two predicated multiplies on one predicate
// register, which chains every exp of a thread behind the one before.)
// exp(dt A) below 2^-126, dt A < -87.3, becomes 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// One level of the reduce-scatter over the lanes of a channel: lanes
// with bit M of q keep the upper M partial sums and send the lower M, the
// others the reverse; each adds what its partner q ^ M sent.
template <int M>
__device__ __forceinline__ void fold(float* p, int q) {
  const bool up = (q & M) != 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float send = up ? p[i] : p[i + M];
    const float keep = up ? p[i + M] : p[i];
    p[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// Every level, M = kLanes / 2 down to 1: lane q ends with p[0] the sum of
// step q's partial sums over the channel's lanes.
template <int M>
__device__ __forceinline__ void fold_all(float* p, int q) {
  fold<M>(p, q);
  if constexpr (M > 1) fold_all<M / 2>(p, q);
}

// A lane's states, one 8- or 16-byte load or store
struct alignas(4 * kPer) Lane {
  float v[kPer];
};

// One 16-byte copy from global to shared memory, in flight until the
// thread's next cp.async.wait_group; zeros where ``ok`` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(at),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// A round's inputs as they are in memory, in the inputs' dtype
template <typename T>
struct alignas(16) Raw {
  T dt[kSteps][kChannels];
  T u[kSteps][kChannels];
  T B[kSteps][kState];
  T C[kSteps][kState];
};

// This thread's copies of the round at t0 into r: rows of the block's
// channels of dt and u, and of B and C, 16 bytes a copy (Din a multiple
// of a copy's elements, so a copy lies wholly inside or outside the row),
// zeros past S and past Din.
template <typename T>
__device__ __forceinline__ void fetch(Raw<T>& r, const T* u, const T* dt,
                                      const T* Bp, const T* Cp, int b,
                                      int t0, int S, int Din, int d0) {
  constexpr int kE = 16 / sizeof(T);      // elements a copy
  constexpr int kRow = kChannels / kE;    // copies a row of channels
  constexpr int kSRow = kState / kE;      // copies a row of states
  for (int i = threadIdx.x; i < kSteps * kRow; i += kThreads) {
    const int j = i / kRow, col = i % kRow * kE;
    const bool ok = t0 + j < S && d0 + col < Din;
    const long long at = ok ? ((long long)b * S + t0 + j) * Din + d0 + col
                            : 0;
    cp_async16(&r.dt[j][col], dt + at, ok);
    cp_async16(&r.u[j][col], u + at, ok);
  }
  for (int i = threadIdx.x; i < kSteps * kSRow; i += kThreads) {
    const int j = i / kSRow, col = i % kSRow * kE;
    const bool ok = t0 + j < S;
    const long long at = ok ? ((long long)b * S + t0 + j) * kState + col : 0;
    cp_async16(&r.B[j][col], Bp + at, ok);
    cp_async16(&r.C[j][col], Cp + at, ok);
  }
}

struct Tiles {
  float2 dd[kSteps][kChannels];  // (dt, x(dt u)) of each (step, channel)
  Lane B[kSteps][kLanes];        // B of each step, a lane's states together
  Lane C[kSteps][kLanes];
  float y[kSteps][kYRow];
};

// A landed round widened into the tiles: (dt, x(dt u)) pairs of channels,
// B and C pairs of states.
template <typename T>
__device__ __forceinline__ void widen(Tiles& s, const Raw<T>& r) {
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int j = i / (kChannels / 2), cc = i % (kChannels / 2) * 2;
    const float2 dv = load2(&r.dt[j][cc]), uv = load2(&r.u[j][cc]);
    *reinterpret_cast<float4*>(&s.dd[j][cc]) =
        make_float4(dv.x, round_x<T>(dv.x * uv.x), dv.y,
                    round_x<T>(dv.y * uv.y));
  }
#pragma unroll
  for (int k = 0; k < kStatePairs; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int j = i / (kState / 2), nn = i % (kState / 2) * 2;
    reinterpret_cast<float2*>(&s.B[j][0])[nn / 2] = load2(&r.B[j][nn]);
    reinterpret_cast<float2*>(&s.C[j][0])[nn / 2] = load2(&r.C[j][nn]);
  }
}

// Steps g .. g + kGroup - 1 of a round for lane q of channel c: the first
// ``valid`` advance the state (a literal kGroup in a whole round, so the
// test folds away), and lane q stores step g + q's sum over the states.
__device__ __forceinline__ void scan_group(Tiles& s, const float* a, float* h,
                                           int g, int valid, int c, int q) {
  float p[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const float2 dd = s.dd[g + j][c];
    const Lane bb = s.B[g + j][q];
    const Lane cc = s.C[g + j][q];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float dA = exp2_ftz(dd.x * a[k] * kLog2e);
      const float dBx = dd.y * bb.v[k];
      h[k] = j < valid ? fmaf(dA, h[k], dBx) : h[k];
    }
    float acc = h[0] * cc.v[0];
#pragma unroll
    for (int k = 1; k < kPer; ++k) acc = fmaf(h[k], cc.v[k], acc);
    p[j] = acc;
  }
  fold_all<kLanes / 2>(p, q);
  s.y[g + q][c] = p[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                          const float* __restrict__ A,
                          const T* __restrict__ Bp, const T* __restrict__ Cp,
                          const float* h0, float* h_out, T* __restrict__ y,
                          int S, int Din, int chunks) {
  __shared__ Tiles s;
  __shared__ Raw<T> raw[2];
  const int q = threadIdx.x % kLanes;
  const int c = threadIdx.x / kLanes;
  const int b = blockIdx.x / chunks;
  const int d0 = (blockIdx.x % chunks) * kChannels;
  const int d = d0 + c;
  const bool live = d < Din;
  const long long hi = ((long long)b * Din + d) * kState + q * kPer;
  float a[kPer], h[kPer];
  {
    const Lane zero = {};
    const Lane av = live ? *reinterpret_cast<const Lane*>(
                               A + (long long)d * kState + q * kPer)
                         : zero;
    const Lane hv = (live && h0 != nullptr)
                        ? *reinterpret_cast<const Lane*>(h0 + hi)
                        : zero;
#pragma unroll
    for (int k = 0; k < kPer; ++k) a[k] = av.v[k], h[k] = hv.v[k];
  }

  // y of the round at t0 (steps of it) from s.y, rows of the block's
  // channels
  auto write_y = [&](int t0, int steps) {
#pragma unroll
    for (int k = 0; k < kSteps * kChannels / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int j = i / kChannels, cc = i % kChannels;
      if (j < steps && d0 + cc < Din)
        y[((long long)b * S + t0 + j) * Din + d0 + cc] = from_f<T>(s.y[j][cc]);
    }
  };

  // a round lands in raw[r & 1] while the round before computes
  const int rounds = (S + kSteps - 1) / kSteps;
  if (rounds > 0) fetch(raw[0], u, dt, Bp, Cp, b, 0, S, Din, d0);
  cp_async_commit();
  for (int r = 0; r < rounds; ++r) {
    const int t0 = r * kSteps;
    if (r + 1 < rounds)
      fetch(raw[(r + 1) & 1], u, dt, Bp, Cp, b, t0 + kSteps, S, Din, d0);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // round r landed; round r - 1's sums are in s.y
    if (r > 0) write_y(t0 - kSteps, kSteps);
    widen(s, raw[r & 1]);
    __syncthreads();
    const int steps = min(kSteps, S - t0);
    if (steps == kSteps) {
      // two groups in flight: one's reduce-scatter beside the other's exps
#pragma unroll 2
      for (int g = 0; g < kSteps; g += kGroup)
        scan_group(s, a, h, g, kGroup, c, q);
    } else {
      for (int g = 0; g < steps; g += kGroup)
        scan_group(s, a, h, g, min(kGroup, steps - g), c, q);
    }
  }
  __syncthreads();
  if (rounds > 0) write_y((rounds - 1) * kSteps, S - (rounds - 1) * kSteps);
  if (live && h_out != nullptr) {
    Lane hv;
#pragma unroll
    for (int k = 0; k < kPer; ++k) hv.v[k] = h[k];
    *reinterpret_cast<Lane*>(h_out + hi) = hv;
  }
}

template <typename T>
int launch(const T* u, const T* dt, const float* A, const T* Bp, const T* Cp,
           const float* h0, float* h_out, T* y, int batch, int S, int Din,
           cudaStream_t stream) {
  if (batch <= 0 || Din <= 0 || Din % (16 / sizeof(T)) || S < 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = (Din + kChannels - 1) / kChannels;
  const long long grid = (long long)batch * chunks;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  selective_scan_kernel<T><<<(unsigned)grid, kThreads, 0, stream>>>(
      u, dt, A, Bp, Cp, h0, h_out, y, S, Din, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// u, dt, y: (batch, S, Din); Bp, Cp: (batch, S, 16), all contiguous in one
// dtype, Din a multiple of 16 bytes' elements, each 16-byte aligned; A:
// (Din, 16) float32; h0 and h_out (batch, Din, 16) float32 or null (they
// may be the same buffer), A, h0 and h_out 16-byte aligned.
extern "C" int selective_scan_f32(const float* u, const float* dt,
                                  const float* A, const float* Bp,
                                  const float* Cp, const float* h0,
                                  float* h_out, float* y, int batch, int S,
                                  int Din, cudaStream_t stream) {
  return launch<float>(u, dt, A, Bp, Cp, h0, h_out, y, batch, S, Din, stream);
}

extern "C" int selective_scan_bf16(const __nv_bfloat16* u,
                                   const __nv_bfloat16* dt, const float* A,
                                   const __nv_bfloat16* Bp,
                                   const __nv_bfloat16* Cp, const float* h0,
                                   float* h_out, __nv_bfloat16* y, int batch,
                                   int S, int Din, cudaStream_t stream) {
  return launch<__nv_bfloat16>(u, dt, A, Bp, Cp, h0, h_out, y, batch, S, Din,
                               stream);
}
