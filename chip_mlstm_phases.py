"""Where a tile of ``mlstm_parallel``'s bf16 routes goes, on one NVIDIA
GPU, and each design's time at xlstm-125m's prefill.

    python3 chip_mlstm_phases.py [--sass DIR]

No ``ncu`` runs on the card's machine, so this script builds copies of
``csrc/mlstm.cu`` in a temporary directory, never in the repository, one
``nvcc`` each, all started together: each build (``BUILDS``: the source
as it stands, and edited by text into the designs tried beside it: a
block alone, no multicast (``cl1``); P V issued beside S's chain, not
gated on it (``no_gate``); the weights' bf16 roundings a conversion each
(``convert``) or in integer ops (``int_round``); the first design, both
ungated and converting (``first``); that with S(t + 1) issued before tile
t's weights into a second accumulator (``ahead``)) as it is (timed) and
stamped: one thread of each role of three blocks of the first (b, h) (the
heaviest query tile, the middle one and the one a quarter in) reads the
SM's cycle counter (``clock64``) at each phase boundary of every key tile
(``PHASES``) and around the block's prologue and epilogue
(``PROLOGUE``). The designs (``DESIGNS``) are the ``mma``
route (``mma.sync``, the parent) and the wgmma route of each build. It
runs them at MLSTM_PREFILL, (1, 32,768, 4, 384) bf16, on
``chip_smoke.py``'s seeded inputs (``_mlstm_inputs``), timing the designs
in turns (``ROUNDS`` rounds of each, then back), checks every copy's head
and tail rows by ``chip_smoke._mlstm_ok``, and prints the card's name and
power limit first, then one JSON object: each design's launch times, the
stamped copy's, each phase's median cycles a tile (over the tiles and
the three blocks) and, at the card's top SM clock (``nvidia-smi``),
microseconds, the prologue's and epilogue's medians, and the kernels'
``ptxas -v`` lines. It exits 1 if a copy fails the check. The copies
find their edits by the text of the source, so an edit to those lines of
the kernels must be made here too (a build that cannot find its text
raises; ``tests/test_torch_chip_scripts.py`` checks it on the CPU).
``--sass DIR`` also writes each plain build's disassembly there.
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
                      "mlstm.cu")

SEED, ROUNDS = 40, 2
#: key tiles stamped a block (the heaviest block at S = 32,768 has 512),
#: counter reads a tile, and prologue / epilogue reads a role
ITERS, SLOTS, PRO = 512, 7, 4
#: the wgmma route's designs tried beside the shipped one, as edits of its
#: text: (old, new), each found exactly once, in turn
_CL1 = (   # a cluster of one block: no multicast, no remote arrives
    ("constexpr int kCl = 2; ", "constexpr int kCl = 1; "),
    (r'''  uint32_t peer, remote;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(peer));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(bar), "r"(peer ^ 1u));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
''', ""),
    (r'''  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
''', ""),
    (r'''  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "h"((unsigned short)3)
      : "memory");
''', "  tma_load(dst, map, bar, c0, c1, c2, c3);\n"),
    (r'''      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"((unsigned short)3)
''', r'''      " [%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes),
      "r"(bar)
'''),
    ('''        bulk_load_mc(dfl + rank * BK * 4, (rank ? Lb : Fb) + j0, BK * 4,
                     k_full + 8 * s);
''', '''        bulk_load_mc(dfl, Fb + j0, BK * 4, k_full + 8 * s);
        bulk_load_mc(dfl + BK * 4, Lb + j0, BK * 4, k_full + 8 * s);
'''))
_NO_GATE = (   # P V(t) issued once P(t) is there, beside S(t + 1)'s chain
    ("        mbar_arrive(s_done);\n", ""),
    ('''      // S(t + 1) landed: s_done's phase t + 1 (the S warpgroup lands
      // S(t + 2) only after this iteration frees P(t - 1)'s buffer, so the
      // parity is never a phase behind)
      if (t + 1 < tiles) mbar_wait(s_done, (t + 1) & 1);
''', ""))
_ROUND = '''  const uint32_t u = pack_bf16(x, y);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
'''
_CONVERT = (   # a conversion (F2F) each
    (_ROUND, "  return make_float2(round_bf16(x), round_bf16(y));\n"),)
_INT_ROUND = (   # integer ops
    (_ROUND, '''  const uint32_t a = __float_as_uint(x), b = __float_as_uint(y);
  return make_float2(
      __uint_as_float((a + 0x7fffu + ((a >> 16) & 1u)) & 0xffff0000u),
      __uint_as_float((b + 0x7fffu + ((b >> 16) & 1u)) & 0xffff0000u));
'''),)
_AHEAD = (   # S(t + 1) into a second accumulator before tile t's weights
    ('''    auto step = [&](float (&sc)[32], int t) {
      const int s = t & 1, j0 = t * BK;
      issue(sc, t);
''', '''    auto step = [&](float (&sc)[32], float (&next)[32], int t) {
      const int s = t & 1, j0 = t * BK;
'''),
    ("      // the weights, sw and the den sums;",
     "      if (t + 1 < tiles) issue(next, t + 1);\n"
     "      // the weights, sw and the den sums;"),
    ('''    float sa[32];
    for (int t = 0; t < tiles; ++t) step(sa, t);
''', '''    float sa[32], sb[32];
    issue(sa, 0);
    for (int t = 0; t < tiles; t += 2) {
      step(sa, sb, t);
      if (t + 1 < tiles) step(sb, sa, t + 1);
    }
'''))
#: build -> its edits of the source
BUILDS = {"as_is": (), "cl1": _CL1, "no_gate": _NO_GATE,
          "convert": _CONVERT, "int_round": _INT_ROUND,
          "first": _NO_GATE + _CONVERT,
          "ahead": _NO_GATE + _CONVERT + _AHEAD}
#: design -> (its build, its kernel: ``mma`` or ``wgmma``)
DESIGNS = {"mma": ("as_is", "mma"), "wgmma": ("as_is", "wgmma"),
           **{f"wgmma_{b}": (b, "wgmma") for b in BUILDS if b != "as_is"}}
#: kernel -> role -> the phases each tile read closes (read k - 1 to k)
PHASES = {
    "mma": {"block": ("wait_k", "s_chain", "weights", "wait_v", "pv",
                      "sync")},
    "wgmma": {"s": ("s_landed", "next_issue", "weights", "wait_p_free",
                    "p_handover"),
              "pv": ("wait_v", "wait_p", "pv")}}
#: kernel -> role -> prologue / epilogue phase -> the reads that open and
#: close it
PROLOGUE = {
    "mma": {"block": {"m_pass": (0, 1)}},
    "wgmma": {"s": {"q_load": (0, 1), "wait_m": (1, 2)},
              "pv": {"m_pass": (0, 1), "epilogue": (2, 3)}}}
#: the thread of each role that reads the counter
ROLE_THREAD = {"mma": {"block": 0}, "wgmma": {"s": 128, "pv": 256}}

HEAD = f"""
__device__ long long g_mlstm_stamps[3][2][{ITERS}][{SLOTS}];
__device__ long long g_mlstm_pro[3][2][{PRO}];
// the stamped blocks: the first (b, h)'s heaviest query tile, its middle
// one and the one a quarter in
__device__ __forceinline__ int mlstm_stamp_slot(int i0, int S) {{
  const int nt = (S + 63) / 64, tile = i0 / 64;
  if (blockIdx.x != 0) return -1;
  return tile == nt - 1 ? 0 : tile == nt / 2 ? 1 : tile == nt / 4 ? 2 : -1;
}}
#define MLSTM_STAMP(tid, role, t, k)                                      \\
  if (threadIdx.x == (tid) && (t) < {ITERS} && mlstm_stamp_slot(i0, S) >= 0) \\
    g_mlstm_stamps[mlstm_stamp_slot(i0, S)][role][t][k] = clock64();
#define MLSTM_PRO(tid, role, k)                                           \\
  if (threadIdx.x == (tid) && mlstm_stamp_slot(i0, S) >= 0)               \\
    g_mlstm_pro[mlstm_stamp_slot(i0, S)][role][k] = clock64();
"""
TAIL = f"""
extern "C" int mlstm_phase_stamps(long long* out, long long* pro) {{
  int e = (int)cudaMemcpyFromSymbol(out, g_mlstm_stamps,
                                    sizeof(long long) * 3 * 2 * {ITERS} * {SLOTS});
  return e ? e : (int)cudaMemcpyFromSymbol(pro, g_mlstm_pro,
                                           sizeof(long long) * 3 * 2 * {PRO});
}}
extern "C" int mlstm_phase_clear() {{
  static long long zeros[3][2][{ITERS}][{SLOTS}];
  static long long pzeros[3][2][{PRO}];
  int e = (int)cudaMemcpyToSymbol(g_mlstm_stamps, zeros, sizeof(zeros));
  return e ? e : (int)cudaMemcpyToSymbol(g_mlstm_pro, pzeros, sizeof(pzeros));
}}
"""
_ANCHOR = "namespace {\n\ntypedef __nv_bfloat16 bf16;\n"


def _s(role: int, k: int, tid: int, t: str = "t") -> str:
    return f"MLSTM_STAMP({tid}, {role}, {t}, {k})"


def _p(role: int, k: int, tid: int) -> str:
    return f"MLSTM_PRO({tid}, {role}, {k})"


#: (text, its replacement): the counter reads, found in the source
EDITS = (
    (_ANCHOR, _ANCHOR + HEAD),
    # ---- mma: thread 0, role 0
    ("  const float m_row = row_max_staged<4, C::NT>(",
     "  " + _p(0, 0, 0) + "\n  const float m_row = row_max_staged<4, C::NT>("),
    ("  if (tid % 4 == 0) s.den[tid / 4] = m_row;    // borrowed for m\n"
     "  __syncthreads();\n",
     "  if (tid % 4 == 0) s.den[tid / 4] = m_row;    // borrowed for m\n"
     "  __syncthreads();\n  " + _p(0, 1, 0) + "\n"),
    ("    cp_async_wait<1>();      // q and this tile's K, F, logi landed\n"
     "    __syncthreads();\n",
     "    " + _s(0, 0, 0) + "\n"
     "    cp_async_wait<1>();      // q and this tile's K, F, logi landed\n"
     "    __syncthreads();\n    " + _s(0, 1, 0) + "\n"),
    ("    // the weights, sw, the den sums and x(sw) into P\n",
     "    " + _s(0, 2, 0) + "\n"
     "    // the weights, sw, the den sums and x(sw) into P\n"),
    ("    cp_async_wait<0>();      // this tile's V landed\n"
     "    __syncthreads();         // P and V visible; K free\n",
     "    " + _s(0, 3, 0) + "\n"
     "    cp_async_wait<0>();      // this tile's V landed\n"
     "    __syncthreads();         // P and V visible; K free\n    "
     + _s(0, 4, 0) + "\n"),
    ("    __syncthreads();         // V and P free\n",
     "    " + _s(0, 5, 0) + "\n    __syncthreads();         // V and P free\n"
     "    " + _s(0, 6, 0) + "\n"),
    # ---- wgmma, S warpgroup: thread 128, role 0
    ("    uint32_t qf[DH / 16][4];\n    mbar_wait(q_full, 0);\n",
     "    uint32_t qf[DH / 16][4];\n    " + _p(0, 0, 128)
     + "\n    mbar_wait(q_full, 0);\n"),
    ("    __syncwarp();\n    if (lane == 0) mbar_arrive_cluster(q_free);\n",
     "    " + _p(0, 1, 128) + "\n"
     "    __syncwarp();\n    if (lane == 0) mbar_arrive_cluster(q_free);\n"),
    ("    const float ma = s_m[ra], mb = s_m[rb];\n",
     "    " + _p(0, 2, 128) + "\n    const float ma = s_m[ra], mb = s_m[rb];\n"),
    ("int t) {\n      const int s = t & 1, j0 = t * BK;\n",
     "int t) {\n      const int s = t & 1, j0 = t * BK;\n      "
     + _s(0, 0, 128) + "\n"),
    ("      wg_wait<0>();\n      fence_regs(sc);\n",
     "      wg_wait<0>();\n      fence_regs(sc);\n      " + _s(0, 1, 128)
     + "\n"),
    # after S(t + 1)'s issue where it comes before the weights
    ("      // the weights, sw and the den sums;",
     "      " + _s(0, 2, 128) + "\n      // the weights, sw and the den sums;"),
    ("      if (t >= 2) mbar_wait(p_empty + 8 * s, ((t >> 1) - 1) & 1);\n",
     "      " + _s(0, 3, 128) + "\n"
     "      if (t >= 2) mbar_wait(p_empty + 8 * s, ((t >> 1) - 1) & 1);\n"
     "      " + _s(0, 4, 128) + "\n"),
    ("      mbar_arrive(p_full + 8 * s);\n    };\n",
     "      mbar_arrive(p_full + 8 * s);\n      " + _s(0, 5, 128) + "\n    };\n"),
    # ---- wgmma, PV warpgroup 0: thread 256, role 1
    ("      const int last = min(S, i0 + BQ) - 1;\n",
     "      const int last = min(S, i0 + BQ) - 1;\n      " + _p(1, 0, 256)
     + "\n"),
    ("      if (pt % 4 == 0) s_m[pt / 4] = m_row;\n",
     "      if (pt % 4 == 0) s_m[pt / 4] = m_row;\n      " + _p(1, 1, 256)
     + "\n"),
    ("      mbar_wait(v_full + 8 * s, (t >> 1) & 1);\n",
     "      " + _s(1, 0, 256) + "\n"
     "      mbar_wait(v_full + 8 * s, (t >> 1) & 1);\n      " + _s(1, 1, 256)
     + "\n"),
    # after the wait for P(t) and, gated, for S(t + 1)
    ("      wg_fence();\n#pragma unroll\n      for (int kk = 0; kk < BK / 16;",
     "      " + _s(1, 2, 256) + "\n"
     "      wg_fence();\n#pragma unroll\n      for (int kk = 0; kk < BK / 16;"),
    ("      wg_wait<1>();   // the tile before done: its V and P free\n",
     "      wg_wait<1>();   // the tile before done: its V and P free\n"
     "      " + _s(1, 3, 256) + "\n"),
    ("    wg_wait<0>();\n    fence_regs(o);\n",
     "    wg_wait<0>();\n    fence_regs(o);\n    " + _p(1, 2, 256) + "\n"),
    ("                      round_bf16(o[4 * n + 2 * e2 + 1]) / d);\n    }\n",
     "                      round_bf16(o[4 * n + 2 * e2 + 1]) / d);\n    }\n"
     "    " + _p(1, 3, 256) + "\n"),
)


def source_text() -> str:
    with open(SOURCE) as fh:
        return fh.read()


def _apply(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"mlstm.cu: text not found once: {old!r}")
        src = src.replace(old, new)
    return src


def design_text(build: str) -> str:
    """A build's copy of the source: the design's edits made."""
    return _apply(source_text(), BUILDS[build])


def edited(src: str | None = None) -> str:
    """The stamped copy's text (of the source as it stands by default)."""
    return _apply(source_text() if src is None else src, EDITS) + TAIL


def build(tmp: str) -> dict:
    """{(build, kind): (library, nvcc log)} for kind ``plain`` and
    ``stamped``, every ``nvcc`` at once."""
    from repro_torch.kernels import _build
    csrc = os.path.dirname(SOURCE)
    for header in os.listdir(csrc):   # the headers the copies include
        if header.endswith(".cuh"):
            with open(os.path.join(csrc, header)) as fh, \
                    open(os.path.join(tmp, header), "w") as out:
                out.write(fh.read())
    procs = {}
    for name in BUILDS:
        plain = design_text(name)
        for kind, text in (("plain", plain), ("stamped", edited(plain))):
            cu = os.path.join(tmp, f"{name}_{kind}.cu")
            lib = os.path.join(tmp, f"lib{name}_{kind}.so")
            with open(cu, "w") as fh:
                fh.write(text)
            procs[name, kind] = (lib, subprocess.Popen(
                [_build.nvcc(), *_build.flags("mlstm"), "-o", lib, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        libs[key] = (lib, log)
    return libs


def launcher(path: str, kernel: str):
    """A build's C entry of ``kernel`` as ``run(q, k, v, logi, logf)`` ->
    h, called as the wrapper calls it (``mlstm.c_args``)."""
    from repro_torch.kernels import mlstm
    lib = ctypes.CDLL(path)
    fn = getattr(lib, mlstm._SYMBOLS[kernel, torch.bfloat16])
    fn.argtypes = list(mlstm.ARGTYPES[kernel])
    fn.restype = ctypes.c_int

    def run(q, k, v, logi, logf):
        out = torch.empty_like(q)
        args, _rows = mlstm.c_args(kernel, q, k, v, logi, logf, out,
                                   torch.cuda.current_stream().cuda_stream)
        err = fn(*args)
        if err:
            raise RuntimeError(f"{path}: CUDA error {err}")
        return out
    return lib, run


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def phases(kernel: str, runs, pros) -> dict:
    """Median cycles of each phase a tile over the stamped runs (each
    [block][role][tile][read]) and of the whole tile, by role; the
    prologue's and epilogue's medians; each block's tile loop."""
    out = {}
    for r, (role, names) in enumerate(PHASES[kernel].items()):
        per = {p: [] for p in names}
        whole = []
        for run in runs:
            for blk in run:
                rows = blk[r]
                for t in range(ITERS):
                    row = rows[t]
                    if all(row[k] for k in range(len(names) + 1)):
                        for k, p in enumerate(names):
                            per[p].append(row[k + 1] - row[k])
                    if t + 1 < ITERS and row[0] and rows[t + 1][0]:
                        whole.append(rows[t + 1][0] - row[0])
        rec = {p: median(v) for p, v in per.items()}
        rec["tile"] = median(whole)
        rec["prologue"] = {
            p: median([x[r][b] - x[r][a] for run in pros for x in run
                       if x[r][a] and x[r][b]])
            for p, (a, b) in PROLOGUE[kernel][role].items()}
        out[role] = rec
    return out


def _dump_sass(libs: dict, out_dir: str) -> None:
    """Each plain build disassembled (``cuobjdump -sass``) into
    ``out_dir``."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    os.makedirs(out_dir, exist_ok=True)
    for (name, kind), (path, _) in libs.items():
        if kind == "plain":
            with open(os.path.join(out_dir, f"mlstm_{name}.sass"), "w") as fh:
                subprocess.run([tool, "-sass", path], stdout=fh, check=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sass = argv[argv.index("--sass") + 1] if "--sass" in argv else None
    if not torch.cuda.is_available():
        print("chip_mlstm_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    print(c.card_line(), flush=True)
    B, S, H, dh = c.MLSTM_PREFILL
    args = c._mlstm_inputs(B, S, H, dh, torch.bfloat16, SEED)
    out = {"shape": list(c.MLSTM_PREFILL), "designs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        if sass:
            _dump_sass(libs, sass)
        runs, first = {}, None
        for design, (name, kernel) in DESIGNS.items():
            rec = out["designs"][design] = {
                "build": name, "kernel": kernel, "ms": [],
                "ptxas": c.kernel_ptxas(libs[name, "plain"][1],
                                        f"mlstm_{kernel}_kernel")}
            for kind in ("plain", "stamped"):
                run = launcher(libs[name, kind][0], kernel)[1]
                got = run(*args)
                if kind == "plain":
                    runs[design] = run
                    # every design against the first (the mma route)
                    first = got if first is None else first
                    rec["max_abs_diff_mma"] = float(
                        (got.float() - first.float()).abs().max())
                rows = c._mlstm_head_tail_errors(got, *args)
                rec[f"{kind}_ok"] = all(c._mlstm_ok(r, c.MLSTM_ROW_REL)
                                        for r in rows.values())
                rec[f"{kind}_row_rel"] = max(r["row_rel_err"]
                                             for r in rows.values())
        order = list(DESIGNS) + list(DESIGNS)[::-1]
        for _ in range(ROUNDS):
            for design in order:
                out["designs"][design]["ms"].append(
                    c.cuda_ms(lambda: runs[design](*args), 3, 1))
        for design, (name, kernel) in DESIGNS.items():
            lib, run = launcher(libs[name, "stamped"][0], kernel)
            stamps, clear = lib.mlstm_phase_stamps, lib.mlstm_phase_clear
            stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            stamps.restype = clear.restype = ctypes.c_int
            clear.argtypes = []
            stamped, pros, ms = [], [], []
            n, npro = 3 * 2 * ITERS * SLOTS, 3 * 2 * PRO
            for rep in range(3):
                if clear():
                    raise RuntimeError("stamps: clear failed")
                t_ms = c.cuda_ms(lambda: run(*args), 1, 0)
                buf = (ctypes.c_longlong * n)()
                pbuf = (ctypes.c_longlong * npro)()
                if stamps(buf, pbuf):
                    raise RuntimeError(f"{design}: stamps not read")
                if rep:
                    flat, pflat = list(buf), list(pbuf)
                    stamped.append([[[flat[((b * 2 + r) * ITERS + i) * SLOTS:
                                           ((b * 2 + r) * ITERS + i + 1)
                                           * SLOTS] for i in range(ITERS)]
                                     for r in range(2)] for b in range(3)])
                    pros.append([[pflat[(b * 2 + r) * PRO:
                                        (b * 2 + r + 1) * PRO]
                                  for r in range(2)] for b in range(3)])
                    ms.append(t_ms)
            rec = out["designs"][design]
            rec["cycles"] = phases(kernel, stamped, pros)
            rec["stamped_ms"] = ms
    mhz = c.sm_clock_mhz()
    for rec in out["designs"].values():
        rec["us"] = {role: {p: (v / mhz if isinstance(v, (int, float))
                                else None)
                            for p, v in cyc.items() if p != "prologue"}
                     for role, cyc in rec["cycles"].items()}
    out["sm_clock_mhz"] = mhz
    print(json.dumps(out), flush=True)
    ok = all(rec[f"{k}_ok"] for rec in out["designs"].values()
             for k in ("plain", "stamped"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
