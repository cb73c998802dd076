"""Where the fused ATO apply kernel spends its time, on one NVIDIA GPU.

    python3 chip_ato_phases.py

No ``ncu`` runs on the card's machine, so this script builds a copy of
``csrc/seeding.cu`` (in a temporary directory, never in the repository)
whose ``ato_apply_fused_kernel`` has thread 0 of block 0 read the SM's
cycle counter (``clock64``) at seven points: entry; its rows loaded and
their step-size candidates taken; past the min's barrier; its rows
updated and stored; past the counts' and sums' barrier; its free rows
placed; the last store issued. It replays the fused apply of ATO's
first ramp step, as ``ato_seed`` records it (heart n = 270 and adult n =
1,000, fold 0 -> 1, one lane) and as ``ato_seed_batch`` does on the
3-lane C row (adult), each on a copy of its inputs, 20 times after a
warm-up, and prints each phase's median cycles and, at the card's most
SM clock (``nvidia-smi``), microseconds; beside them the kernel's time
by CUDA events behind a spin kernel, for the copy and for the package's
own build (the counter reads cost a few cycles). Prints the
card's name and power limit first and one JSON object last. The copy
finds its edits by the text of the source, so an edit to those lines of
``seeding.cu`` must be made here too (a build that cannot find its text
raises).
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
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")

STAMP = ("if (threadIdx.x == 0 && blockIdx.x == 0) g_ato_stamps[{}] = "
         "clock64();")
#: (text of seeding.cu, its replacement): the counter reads
EDITS = (
    ("#include <cstdint>\n",
     "#include <cstdint>\n\n__device__ long long g_ato_stamps[8];\n"),
    ("  int par = 0;\n  const int tid = threadIdx.x, lane = tid & 31, "
     "wid = tid >> 5;\n  // the flag is tested",
     "  int par = 0;\n  " + STAMP.format(0) + "\n  const int tid = "
     "threadIdx.x, lane = tid & 31, wid = tid >> 5;\n  // the flag is "
     "tested"),
    ("  if (was_done) {   // (uniform)",
     "  " + STAMP.format(1) + "\n  if (was_done) {   // (uniform)"),
    ("  mn = block_ext<false>(mn, red, par);\n  double eta = nan_min(mn, "
     "1.0);\n  if (!isfinite(eta)) eta = 1.0;\n  double sf = 0.0, sw = 0.0,",
     "  mn = block_ext<false>(mn, red, par);\n  " + STAMP.format(2)
     + "\n  double eta = nan_min(mn, 1.0);\n  if (!isfinite(eta)) eta = "
     "1.0;\n  double sf = 0.0, sw = 0.0,"),
    ("  sf = warp_sum(sf);\n  sw = warp_sum(sw);\n  dmax = warp_ext<true>"
     "(dmax);",
     "  " + STAMP.format(3) + "\n  sf = warp_sum(sf);\n  sw = warp_sum(sw);"
     "\n  dmax = warp_ext<true>(dmax);"),
    ("    any_w[wid] = anyR | (anyT << 1);\n  }\n  __syncthreads();",
     "    any_w[wid] = anyR | (anyT << 1);\n  }\n  __syncthreads();\n  "
     + STAMP.format(4)),
    ("  const int nf = base;\n  if (nf > m_cap)", "  " + STAMP.format(5)
     + "\n  const int nf = base;\n  if (nf > m_cap)"),
    ("    rhs[0] = nf > 0 ? SW : 0.0;\n  }\n}",
     "    rhs[0] = nf > 0 ? SW : 0.0;\n  }\n  " + STAMP.format(6) + "\n}"),
)
EXTRA = """
extern "C" int ato_phase_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_ato_stamps, sizeof(long long) * 8);
}
"""
PHASES = ("rows_loaded", "min_barrier", "rows_updated", "sums_barrier",
          "rows_placed", "last_store")
REPS = 20
_P, _I, _D, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                  ctypes.c_longlong)


def build(tmp: str) -> str:
    from repro_torch.kernels import _build
    with open(os.path.join(CSRC, "seeding.cu")) as fh:
        src = fh.read()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"text not found once: {old!r}")
        src = src.replace(old, new)
    for name in os.listdir(CSRC):
        if name.endswith(".cuh"):
            with open(os.path.join(CSRC, name)) as fh, \
                    open(os.path.join(tmp, name), "w") as out:
                out.write(fh.read())
    cu, lib = os.path.join(tmp, "seeding.cu"), os.path.join(tmp, "libp.so")
    with open(cu, "w") as fh:
        fh.write(src + EXTRA)
    log = subprocess.run([_build.nvcc(), *_build.flags("seeding"), "-o",
                          lib, cu], capture_output=True, text=True)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log.stdout}{log.stderr}")
    return lib


def fused_args(a, kw, eta, stream):
    """The fused C entry's arguments for the recorded call ``a`` / ``kw``
    (the wrapper's order), eta into ``eta``."""
    (g, f, alpha, v, Phi, y, b, Cs, tol, tn, fr, T_act, R_act, done, step,
     max_steps) = a
    c = kw["carry"]
    s = c.s
    lanes, n = f.shape
    return (c.K.data_ptr(), n, g.data_ptr(), f.data_ptr(), alpha.data_ptr(),
            Phi.data_ptr(), y.data_ptr(), c.in_S.data_ptr(),
            c.in_T.data_ptr(), T_act.data_ptr(), R_act.data_ptr(),
            done.data_ptr(), step.data_ptr(), eta.data_ptr(),
            Cs.data_ptr(), c.b_fallback.data_ptr(), lanes, float(tol),
            int(max_steps), s.idx.shape[1],
            *(getattr(s, k).data_ptr() for k in (
                "train_now", "free", "nf", "b", "v", "w", "idx", "lane", "yM",
                "lam", "rhs")), stream)


def run_case(fn, stamps, a, kw) -> dict:
    import chip_smoke as c
    types = [_P, _I, *([_P] * 14), _I, _D, _L, _I, *([_P] * 11), _P]
    fn.argtypes, fn.restype = types, ctypes.c_int
    out, events = [], []
    for rep in range(REPS + 1):
        x, k = c._clone_call(a, kw)
        eta = torch.empty(x[1].shape[0], dtype=torch.float64,
                          device=x[1].device)
        args = fused_args(x, k, eta, torch.cuda.current_stream().cuda_stream)
        c.sync()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(2_000_000)
        s.record()
        err = fn(*args)
        e.record()
        e.synchronize()
        if err:
            raise RuntimeError(f"fused apply: CUDA error {err}")
        buf = (ctypes.c_longlong * 8)()
        if stamps is not None and stamps(buf):
            raise RuntimeError("stamps: copy failed")
        if rep:
            events.append(s.elapsed_time(e))
            out.append(list(buf))
    res = {"events_ms_median": sorted(events)[REPS // 2]}
    if stamps is not None:
        res["cycles"] = {
            name: sorted(r[i + 1] - r[i] for r in out)[REPS // 2]
            for i, name in enumerate(PHASES)}
        res["cycles_total"] = sorted(r[6] - r[0] for r in out)[REPS // 2]
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_ato_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from repro_torch.core import seeding
    from repro_torch.core.cv import _transition_idx
    from repro_torch.kernels import _build
    _build.build_all()
    print(c.card_line(), flush=True)
    cases = {}
    for name, n in (("heart", 270), ("adult", 1000)):
        rec = c._record_seeding_inputs(name, n)
        cases[f"{name}_solo"] = (rec["calls"]["ato_apply_lanes"][0],
                                 rec["kwargs"]["ato_apply_lanes"][0])
    ds, K, y, masks, chunks, Cs, prev = c._ato_row_problem("adult", 1000)
    idx = _transition_idx(chunks, 0, 1, K.device)
    with c._Recorder(seeding, ("ato_apply_lanes",)) as rec:
        seeding.ato_seed_batch(K, y, Cs, prev, *idx, bucket_by_lane=False)
    cases["adult_row"] = (rec.calls["ato_apply_lanes"][0],
                          rec.kwargs["ato_apply_lanes"][0])
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = ctypes.CDLL(build(tmp))
        stamps = lib.ato_phase_stamps
        stamps.argtypes, stamps.restype = [_P], ctypes.c_int
        own = _build.load("seeding").ato_apply_fused_f64
        for key, (a, kw) in cases.items():
            row = run_case(lib.ato_apply_fused_f64, stamps, a, kw)
            row["events_ms_median_package"] = run_case(own, None, a,
                                                       kw)["events_ms_median"]
            out[key] = row
    mhz = float(subprocess.run(   # the clock the card runs at under load
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])
    for row in out.values():
        row["us"] = {k: v / mhz for k, v in row["cycles"].items()}
        row["us_total"] = row["cycles_total"] / mhz
    out["sm_clock_mhz"] = mhz
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
