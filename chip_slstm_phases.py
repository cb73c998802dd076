"""Where a step of ``slstm_scan``'s cluster route goes, on one NVIDIA GPU,
and the parent design's time beside the one the source holds.

    python3 chip_slstm_phases.py [--sass DIR]

No ``ncu`` runs on the card's machine, so this script builds copies of
``csrc/slstm.cu`` in a temporary directory, never in the repository, one
``nvcc`` each, all started together. The designs (``DESIGNS``):

* ``parent``: the route's previous design (``PARENT_ROUTE`` below: 8
  blocks, rz in each block's shared memory, h written into every block's
  buffer through distributed shared memory, one cluster barrier a step),
  spliced into a copy of the source in place of its ``cluster_route``
  namespace;
* ``new``: the source as it stands (16 blocks, rz in registers, h handed
  over by ``st.async`` onto an ``mbarrier``).

Each design is built three ways: as it is (timed), with
``-DSLSTM_CHAIN_ONLY=1`` (its serial chain alone, timed) and stamped:
thread 0 of three blocks of the batch row (the first, the middle and the
last) reads the SM's cycle counter (``clock64``) at each phase boundary
of the first ``ITERS`` steps (``PHASES``). It runs them at xlstm-125m's
prefill shape, (1, 32,768, 768) bf16, on ``chip_smoke.py``'s seeded
inputs, the designs in turns (``ROUNDS`` rounds of parent, new, new,
parent), and decode's step, (4, 1, 768) from a carry in place, over a
CUDA graph; checks every copy's outputs and final carry, prefill and
decode, bit for bit against the block route's, and prints the card's name
and power limit first, then one JSON object: each design's launch times,
us a step, its chain's, the stamped copy's, decode's ms, each phase's
median cycles a step (over the steps and the three blocks) and, at the
card's top SM clock (``nvidia-smi``), microseconds, and the cluster
kernel's ``ptxas -v`` lines. It exits 1 if a copy is not bitwise. The copies find their edits by the text of the sources, so an edit
to those lines of the kernel must be made here too (a build that cannot
find its text raises; ``tests/test_torch_chip_scripts.py`` checks it on
the CPU). ``--sass DIR`` also writes each design's disassembly there.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                      "slstm.cu")

SHAPE, SEED, ROUNDS = (1, 32768, 768), 41, 2
#: decode's step (4 requests, one token, from a carry, in place), timed
#: over DECODE_REPS launches in a CUDA graph
DECODE, DECODE_REPS = (4, 1, 768), 200
#: steps stamped, and counter reads a step
ITERS, SLOTS = 2048, 7
#: the phases each read closes (read k - 1 to read k)
PHASES = {
    "parent": ("gate_loads", "dot", "shuffles", "step_math",
               "remote_stores", "barrier"),
    "new": ("wait", "dot", "shuffles", "step_math", "remote_stores",
            "gates_r_free_half")}
#: design -> (the source it stamps, ``parent`` or ``new``, and the flags it
#: adds)
DESIGNS = {"parent": ("parent", ()), "new": ("new", ())}
#: the namespace each design's cluster route lives in
ROUTE_BEGIN, ROUTE_END = ("namespace cluster_route {\n",
                          "}  // namespace cluster_route\n")

PARENT_ROUTE = """namespace cluster_route {

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
"""

HEAD = f"""
__device__ long long g_slstm_stamps[3][{ITERS}][{SLOTS}];
__device__ __forceinline__ int slstm_stamp_slot() {{
  return blockIdx.x == 0 ? 0
         : blockIdx.x == gridDim.x / 2 ? 1
         : blockIdx.x == gridDim.x - 1 ? 2 : -1;
}}
"""
#: a counter read at step t, slot k
STAMP = ("if (threadIdx.x == 0 && t < " + str(ITERS)
         + " && slstm_stamp_slot() >= 0) g_slstm_stamps"
         "[slstm_stamp_slot()][t][{k}] = clock64();")
TAIL = f"""
extern "C" int slstm_phase_stamps(long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_slstm_stamps,
                                   sizeof(long long) * 3 * {ITERS} * {SLOTS});
}}
extern "C" int slstm_phase_clear() {{
  static long long zeros[3][{ITERS}][{SLOTS}];
  return (int)cudaMemcpyToSymbol(g_slstm_stamps, zeros, sizeof(zeros));
}}
"""
_INCLUDES = "namespace cg = cooperative_groups;\n"


def _s(k: int) -> str:
    return STAMP.format(k=k)


#: design -> ((text, its replacement), ...): the counter reads, found in
#: the design's text (the parent's spliced in)
EDITS = {
    "parent": (
        (_INCLUDES, _INCLUDES + HEAD),
        ("  for (int t = 0; t < S; ++t) {\n#if !SLSTM_CHAIN_ONLY\n",
         "  for (int t = 0; t < S; ++t) {\n    " + _s(0)
         + "\n#if !SLSTM_CHAIN_ONLY\n"),
        ("      z_n = gz[g], i_n = gi[g], f_n = gf[g], o_n = go[g];\n    }\n"
         "#endif\n",
         "      z_n = gz[g], i_n = gi[g], f_n = gf[g], o_n = go[g];\n    }\n"
         "#endif\n    " + _s(1) + "\n"),
        ("    // the four lanes' sums of the column, combined as the block "
         "route does\n",
         "    " + _s(2) + "\n    // the four lanes' sums of the column, "
         "combined as the block route does\n"),
        ("    r_sum += __shfl_xor_sync(0xffffffffu, r_sum, 2);\n",
         "    r_sum += __shfl_xor_sync(0xffffffffu, r_sum, 2);\n    "
         + _s(3) + "\n"),
        ("    float* next = hb + ((t + 1) & 1) * kQ * kHQ + hpad(j);\n",
         "    " + _s(4) + "\n"
         "    float* next = hb + ((t + 1) & 1) * kQ * kHQ + hpad(j);\n"),
        ("    cluster.sync();\n  }\n  if (q == 0) {\n",
         "    " + _s(5) + "\n    cluster.sync();\n    " + _s(6)
         + "\n  }\n  if (q == 0) {\n"),
    ),
    "new": (
        (_INCLUDES, _INCLUDES + HEAD),
        ("  for (int t = 0; t < S; ++t) {\n    const int p = t & 1;\n",
         "  for (int t = 0; t < S; ++t) {\n    const int p = t & 1;\n    "
         + _s(0) + "\n"),
        ("      if (threadIdx.x == 0 && t + 2 < S) expect_bytes(bar0 + 8 * p, "
         "kTxBytes);\n    }\n",
         "      if (threadIdx.x == 0 && t + 2 < S) expect_bytes(bar0 + 8 * p, "
         "kTxBytes);\n    }\n    " + _s(1) + "\n"),
        ("    // column jm's chains, combined as the block route combines "
         "them: the\n",
         "    " + _s(2) + "\n    // column jm's chains, combined as the block "
         "route combines them: the\n"),
        ("      r_sum += __shfl_xor_sync(0xffffffffu, r_sum, x);\n",
         "      r_sum += __shfl_xor_sync(0xffffffffu, r_sum, x);\n    "
         + _s(3) + "\n"),
        ("    if (t + 1 < S) {\n      // h_{t+1} of the warp's 4 columns",
         "    " + _s(4) + "\n    if (t + 1 < S) {\n"
         "      // h_{t+1} of the warp's 4 columns"),
        ("#if !SLSTM_CHAIN_ONLY\n    if (t + 1 < S) {\n      zt_in = ",
         "    " + _s(5) + "\n#if !SLSTM_CHAIN_ONLY\n    if (t + 1 < S) {\n"
         "      zt_in = "),
        ("  }\n  cluster.sync();   // no block leaves while another may "
         "write into it\n",
         "    " + _s(6) + "\n  }\n  cluster.sync();   // no block leaves "
         "while another may write into it\n"),
    ),
}


def design_text(base: str, src: str | None = None) -> str:
    """The source of a design's ``base``: ``slstm.cu`` as it stands
    (``new``) or with the parent's cluster route spliced in."""
    if src is None:
        with open(SOURCE) as fh:
            src = fh.read()
    if base == "new":
        return src
    a, b = src.find(ROUTE_BEGIN), src.find(ROUTE_END)
    if a < 0 or b < a or src.count(ROUTE_BEGIN) != 1:
        raise RuntimeError("slstm.cu: the cluster_route namespace not found")
    return src[:a] + PARENT_ROUTE + src[b + len(ROUTE_END):]


def edited(base: str, src: str | None = None) -> str:
    """The stamped copy's text of a design's base."""
    src = design_text(base, src)
    for old, new in EDITS[base]:
        if src.count(old) != 1:
            raise RuntimeError(f"{base}: text not found once: {old!r}")
        src = src.replace(old, new)
    return src + TAIL


def build(tmp: str) -> dict:
    """{(design, kind): (library, ptxas lines)} for kind ``plain``,
    ``chain`` and ``stamped``, every ``nvcc`` at once."""
    import chip_smoke as c
    from repro_torch.kernels import _build
    procs = {}
    for design, (base, flags) in DESIGNS.items():
        texts = {"plain": design_text(base), "chain": design_text(base),
                 "stamped": edited(base)}
        for kind, text in texts.items():
            cu = os.path.join(tmp, f"{design}_{kind}.cu")
            lib = os.path.join(tmp, f"lib{design}_{kind}.so")
            with open(cu, "w") as fh:
                fh.write(text)
            extra = [*flags] + (["-DSLSTM_CHAIN_ONLY=1"] if kind == "chain"
                                else [])
            procs[design, kind] = (lib, subprocess.Popen(
                [_build.nvcc(), *_build.flags("slstm"), *extra, "-o", lib,
                 cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        libs[key] = (lib, c.kernel_ptxas(log, "slstm_cluster_kernel"))
    return libs


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def phases(base: str, runs) -> dict:
    """Median cycles of each phase a step over the stamped runs (each
    [block][step][read]), and of the whole step."""
    names = PHASES[base]
    out = {p: [] for p in names}
    whole = []
    for run in runs:
        for blk in run:
            for it in range(ITERS):
                row = blk[it]
                if all(row[k] for k in range(SLOTS)):
                    for k, p in enumerate(names):
                        out[p].append(row[k + 1] - row[k])
                if it + 1 < ITERS and row[0] and blk[it + 1][0]:
                    whole.append(blk[it + 1][0] - row[0])
    rec = {p: median(v) for p, v in out.items()}
    rec["step"] = median(whole)
    return rec


def _dump_sass(libs: dict, out_dir: str) -> None:
    """Each design's plain build disassembled (``cuobjdump -sass``) into
    ``out_dir``."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    os.makedirs(out_dir, exist_ok=True)
    for (design, kind), (path, _) in libs.items():
        if kind == "plain":
            with open(os.path.join(out_dir, f"{design}.sass"), "w") as fh:
                subprocess.run([tool, "-sass", path], stdout=fh, check=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sass = argv[argv.index("--sass") + 1] if "--sass" in argv else None
    if not torch.cuda.is_available():
        print("chip_slstm_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    print(c.card_line(), flush=True)
    B, S, D = SHAPE
    *args, _ = c._slstm_inputs(B, S, D, torch.bfloat16, SEED)
    *dargs, dcarry = c._slstm_inputs(*DECODE, torch.bfloat16, SEED + 1, True)
    _P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    out = {"shape": list(SHAPE), "decode_shape": list(DECODE), "designs": {}}

    def launcher(path, symbol="slstm_scan_bf16_cluster"):
        """The C entry ``symbol`` of a build as ``run(inputs, carry,
        carry_out)`` -> hs."""
        lib = ctypes.CDLL(path)
        fn = getattr(lib, symbol)
        fn.argtypes = [_P] * 4 + [_L, _L] + [_P] * 11 + [_I, _I, _I, _P]
        fn.restype = ctypes.c_int

        def run(inputs=args, carry=None, carry_out=None):
            gz, gi, gf, go, rz, bf = inputs
            b, s, d = gz.shape
            hs = torch.empty((b, s, d), dtype=torch.bfloat16, device="cuda")
            cin, cout = ([None] * 4 if t is None else [x.data_ptr() for x in t]
                         for t in (carry, carry_out))
            err = fn(gz.data_ptr(), gi.data_ptr(), gf.data_ptr(),
                     go.data_ptr(), gz.stride(1), gz.stride(0),
                     rz.data_ptr(), bf.data_ptr(), *cin, *cout,
                     hs.data_ptr(), b, s, d,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{path}: CUDA error {err}")
            return hs
        return lib, run

    def same(got, outs, want, want_outs) -> bool:
        return bool(torch.equal(got, want)) and all(
            torch.equal(a, b) for a, b in zip(outs, want_outs))

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        if sass:
            _dump_sass(libs, sass)
        # the witness: the block route of the parent's copy, prefill and
        # decode (in place on a copy of the carry)
        block = launcher(libs["parent", "plain"][0], "slstm_scan_bf16")[1]
        want_out = c._slstm_carry(B, D, torch.bfloat16)
        want = block(args, None, want_out)
        dwant_out = tuple(t.clone() for t in dcarry)
        dwant = block(dargs, dwant_out, dwant_out)
        runs = {key: launcher(path)[1] for key, (path, _) in libs.items()
                if key[1] != "stamped"}
        for design in DESIGNS:
            rec = out["designs"][design] = {
                "ptxas": libs[design, "plain"][1], "ms": [], "chain_ms": []}
            for kind in ("plain", "stamped"):
                run = (runs[design, kind] if kind == "plain"
                       else launcher(libs[design, kind][0])[1])
                got_out = c._slstm_carry(B, D, torch.bfloat16)
                got = run(args, None, got_out)
                rec[f"{kind}_bitwise_block"] = same(got, got_out, want,
                                                    want_out)
            cache = tuple(t.clone() for t in dcarry)
            got = runs[design, "plain"](dargs, cache, cache)
            rec["decode_bitwise_block"] = same(got, cache, dwant, dwant_out)
            cache = tuple(t.clone() for t in dcarry)
            rec["decode_graph_ms"] = c.graph_ms(
                lambda: runs[design, "plain"](dargs, cache, cache),
                DECODE_REPS)
        order = list(DESIGNS) + list(DESIGNS)[::-1]
        for _ in range(ROUNDS):
            for design in order:
                rec = out["designs"][design]
                rec["ms"].append(c.cuda_ms(runs[design, "plain"], 1, 1))
                rec["chain_ms"].append(c.cuda_ms(runs[design, "chain"], 1, 1))
        for design, (base, _) in DESIGNS.items():
            lib, run = launcher(libs[design, "stamped"][0])
            stamps, clear = lib.slstm_phase_stamps, lib.slstm_phase_clear
            stamps.argtypes, stamps.restype = [_P], ctypes.c_int
            clear.argtypes, clear.restype = [], ctypes.c_int
            stamped, us = [], []
            for rep in range(3):
                if clear():
                    raise RuntimeError("stamps: clear failed")
                ms = c.cuda_ms(run, 1, 0)
                buf = (ctypes.c_longlong * (3 * ITERS * SLOTS))()
                if stamps(buf):
                    raise RuntimeError(f"{design}: stamps not read")
                if rep:
                    flat = list(buf)
                    stamped.append([[flat[(b * ITERS + i) * SLOTS:
                                          (b * ITERS + i + 1) * SLOTS]
                                     for i in range(ITERS)]
                                    for b in range(3)])
                    us.append(1e3 * ms / S)
            rec = out["designs"][design]
            rec["cycles"] = phases(base, stamped)
            rec["stamped_us_per_step"] = us
    mhz = c.sm_clock_mhz()
    for rec in out["designs"].values():
        rec["us_per_step"] = [1e3 * ms / S for ms in rec["ms"]]
        rec["chain_us_per_step"] = [1e3 * ms / S for ms in rec["chain_ms"]]
        rec["us"] = {p: (v / mhz if v is not None else None)
                     for p, v in rec["cycles"].items()}
    out["sm_clock_mhz"] = mhz
    print(json.dumps(out), flush=True)
    ok = all(rec[f"{k}_bitwise_block"] for rec in out["designs"].values()
             for k in ("plain", "stamped", "decode"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
