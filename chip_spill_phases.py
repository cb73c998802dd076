"""Where the LOO seeders' fused spills spend their time, on one NVIDIA GPU.

    python3 chip_spill_phases.py

No ``ncu`` runs on the card's machine, so this script builds a copy of
``csrc/seeding.cu`` (in a temporary directory, never in the repository)
whose ``avg_spill_fused_kernel`` has thread 0 read the SM's cycle counter
(``clock64``) at entry, once its rows are loaded and counted, past round
0's count reduction, and after each round's pass over its rows and each
round's reduction. It replays the fused AVG spill of adult n = 1,000's
full solution at rows 0, 499 and 999 (the inputs ``run_loo``'s seeds
give it), 20 times after a warm-up, and prints each phase's median
cycles and, at the card's most SM clock (``nvidia-smi``), microseconds;
and, at row 0, the same for ablations (``MUTANTS``: each a copy with one
more edit, its values not checked): the share taken by a multiply in
place of the division, the clamp with its NaN tests on every input
(the kernel drops them where the spill provably stays finite), and the
rounds without their counts, each built in parallel. Beside them, by
``torch.profiler`` over 20 calls of each: the device time of the
package's own kernels (the fused and split routes of both
spills, and ``water_fill``) as the seeders launch them, so that a
kernel's time can be told from a graph's or an event's overhead. Prints
the card's name and power limit first and one JSON object last. The
copy finds its edits by the text of the source, so an edit to those
lines of ``seeding.cu`` must be made here too (a build that cannot find
its text raises; ``tests/test_torch_chip_scripts.py`` checks it on the
CPU).
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

#: the fused AVG spill's rounds (``kAvgRounds`` in ``seeding.cu``)
ROUNDS = 8
#: counter reads: entry, rows loaded, round 0's counts, then each round's
#: pass and reduction
SLOTS = 3 + 2 * ROUNDS
STAMP = "if (threadIdx.x == 0) g_spill_stamps[{}] = clock64();"
#: (text of seeding.cu, its replacement): the counter reads
EDITS = (
    ("#include <cstdint>\n",
     f"#include <cstdint>\n\n__device__ long long g_spill_stamps[{SLOTS}];\n"),
    ("  constexpr int R = kAvgRows;\n",
     "  constexpr int R = kAvgRows;\n  " + STAMP.format(0) + "\n"),
    ("  double resid = y_t * a_t;\n",
     "  " + STAMP.format(1) + "\n  double resid = y_t * a_t;\n"),
    ("  avg_reduce<false, MAXT / 32>(bigs, up, down, red, par);\n",
     "  avg_reduce<false, MAXT / 32>(bigs, up, down, red, par);\n  "
     + STAMP.format(2) + "\n"),
    ("      avg_reduce<true, MAXT / 32>(sum, up, down, red, par);\n"
     "      resid = resid - sum;\n",
     "      " + STAMP.format("3 + 2 * rd") + "\n"
     "      avg_reduce<true, MAXT / 32>(sum, up, down, red, par);\n"
     "      resid = resid - sum;\n      " + STAMP.format("4 + 2 * rd")
     + "\n"),
)
EXTRA = f"""
extern "C" int spill_phase_stamps(long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_spill_stamps,
                                   sizeof(long long) * {SLOTS});
}}
"""
#: ablation -> its edit of the fused AVG pass (timing only)
MUTANTS = {
    "no_division": (
        "      const double share =\n          resid == 0.0 ? resid : resid "
        "/ (d > 1 ? (double)d : 1.0);\n",
        "      const double share = resid * (d > 1 ? 0.001 : 1.0);\n"),
    "nan_clamp": (
        "  if (bigs == 0.0 && fabs(C) <= kAvgBig && fabs(resid) <= "
        "kAvgBig)\n",
        "  if (false)\n"),
    "no_counts": ("    up += (f && g_up) ? 1 : 0;\n"
                  "    down += (f && g_dn) ? 1 : 0;\n", "")}
REPS = 20
ROWS = (0, 499, 999)
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


def build(tmp: str, names) -> dict:
    """{name: library}: the stamped copy ("stamped") and each ablation of
    ``names``, every ``nvcc`` started at once."""
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
    procs = {}
    for name in ("stamped",) + tuple(names):
        text = src
        if name in MUTANTS:
            old, new = MUTANTS[name]
            if text.count(old) != 1:
                raise RuntimeError(f"text not found once: {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"{name}.cu")
        lib = os.path.join(tmp, f"lib{name}.so")
        with open(cu, "w") as fh:
            fh.write(text + EXTRA)
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.flags("seeding"), "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = lib
    return libs


def stamped(fn, stamps, y, alpha, C, t) -> dict:
    """Median cycles of each phase of the copy's fused AVG spill over
    ``REPS`` calls after a warm-up."""
    fn.argtypes = [_P, _P, _D, _I, _P, _P, _P, _I, _P]
    fn.restype = ctypes.c_int
    n = y.shape[0]
    outs = [torch.empty_like(y) for _ in range(3)]
    rows = []
    for rep in range(REPS + 1):
        err = fn(y.data_ptr(), alpha.data_ptr(), float(C), int(t),
                 *(o.data_ptr() for o in outs), n,
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * SLOTS)()
        if err or stamps(buf):
            raise RuntimeError(f"stamped avg_spill: CUDA error {err}")
        if rep:
            rows.append(list(buf))
    med = lambda xs: sorted(xs)[REPS // 2]  # noqa: E731
    return {"rows_loaded": med([r[1] - r[0] for r in rows]),
            "counts_0": med([r[2] - r[1] for r in rows]),
            "pass": [med([r[3 + 2 * k] - r[2 + 2 * k] for r in rows])
                     for k in range(ROUNDS)],
            "reduce": [med([r[4 + 2 * k] - r[3 + 2 * k] for r in rows])
                       for k in range(ROUNDS)],
            "total": med([r[SLOTS - 1] - r[0] for r in rows])}


def profiled(calls) -> dict:
    """{kernel: device us a launch} over every call of ``calls`` (name ->
    a function), each run ``REPS`` times under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        out[name] = {e.key[:60]: e.self_device_time_total / e.count
                     for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_spill_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from repro_torch.core import seeding
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import seeding as ks
    _build.build_all()
    print(c.card_line(), flush=True)
    ds, K, y, prev = c._seed_problem_full("adult", 1000)
    alpha, C = prev.alpha, ds.C
    out = {"n": y.shape[0], "rows": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, path in build(tmp, MUTANTS).items():
            lib = ctypes.CDLL(path)
            stamps = lib.spill_phase_stamps
            stamps.argtypes, stamps.restype = [_P], ctypes.c_int
            for t in (ROWS if name == "stamped" else ROWS[:1]):
                key = t if name == "stamped" else f"{t}_{name}"
                out["rows"][key] = stamped(lib.avg_spill_fused_f64, stamps,
                                           y, alpha, C, t)
    t = ROWS[0]
    pro = ref.loo_start_ref(y, alpha, C, t)
    order = ref.loo_order_ref(K[:, t], t)
    out["profiler_us"] = profiled({
        "avg_fused": lambda: ks.avg_spill_loo(y, alpha, C, t),
        "avg_split": lambda: ks.avg_spill(pro[0], pro[2], pro[3], pro[4],
                                          pro[1]),
        "top_fused": lambda: ks.top_spill_loo(K, y, alpha, C, t),
        "top_split": lambda: ks.top_spill(order, pro[0], pro[2], pro[3],
                                          pro[1]),
        "avg_seed": lambda: seeding.avg_seed_loo(K, y, C, alpha, t),
        "top_seed": lambda: seeding.top_seed_loo(K, y, C, alpha, t)})
    mhz = c.sm_clock_mhz()
    for row in out["rows"].values():
        row["us_total"] = row["total"] / mhz
        row["us_pass_mean"] = sum(row["pass"]) / ROUNDS / mhz
        row["us_reduce_mean"] = sum(row["reduce"]) / ROUNDS / mhz
    out["sm_clock_mhz"] = mhz
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
