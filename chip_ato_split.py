"""Where ATO's ramp step spends its device time on one GPU.

    python3 chip_ato_split.py [--src DIR]

Builds the kernels of the package under DIR (default this checkout's
``src``; another checkout's ``src`` splits another tree in the same
call), then profiles with ``torch.profiler`` (CPU and CUDA activity),
each after a warm-up call: one heart ATO seed (n = 270, k = 10, fold
0 -> 1, ``ato_seed``: one lane), one adult seed (n = 1,000, its ramp's
one step) and the ATO C row (0.01 / 1 / 100 x C, ``ato_seed_batch``
with one padded ramp of three lanes) on heart and on adult.

The parts of a ramp step are wrapped in ``record_function`` ranges:
``ato_system`` (``ato_system_lanes``), ``mv`` (``torch.mv``: the rhs and
g products), ``lu`` (``torch.linalg.solve_ex``), ``ato_apply``
(``ato_apply_lanes``) and ``f_update_clamp`` (``smo_f_update`` and
``torch.clamp``, the alpha update of trees that take it after the
apply); a kernel goes to the innermost range open when the host launched
it (the trace's correlation ids), else to ``glue`` (the gathers, masks
and scatter between the parts). Per step: each part's device ms and
kernels, the step's device span (its first kernel's start to its last
kernel's end), the busy ms inside it (some kernel running), the idle ms
(none), and the host ms that enqueued the step. Prints the card's name
and power limit first and one JSON object last.
"""
from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

#: the step's parts: (namespace, attribute, label); a missing one is skipped
TORCH_PARTS = ((torch, "mv", "mv"), (torch.linalg, "solve_ex", "lu"),
               (torch, "clamp", "f_update_clamp"))
SEEDING_PARTS = (("ato_system_lanes", "ato_system"),
                 ("ato_apply_lanes", "ato_apply"),
                 ("smo_f_update", "f_update_clamp"), ("_ato_step", "step"))
PREFIX = "ato_split:"
#: the port's own kernels by name, for a launch the trace did not record
NAMED = (("ato_system_kernel", "ato_system"), ("ato_b_kernel", "ato_system"),
         ("ato_apply", "ato_apply"), ("smo_f_update", "f_update_clamp"))


class _Labels:
    """Wraps the step's parts in ``record_function`` ranges while open."""

    def __init__(self, seeding):
        self.targets = [(seeding, name, label)
                        for name, label in SEEDING_PARTS
                        if hasattr(seeding, name)] + list(TORCH_PARTS)
        self.saved = []

    def __enter__(self):
        from torch.profiler import record_function
        for ns, name, label in self.targets:
            fn = getattr(ns, name)
            self.saved.append((ns, name, fn))

            def run(*a, _fn=fn, _label=PREFIX + label, **kw):
                with record_function(_label):
                    return _fn(*a, **kw)
            setattr(ns, name, run)
        return self

    def __exit__(self, *exc):
        for ns, name, fn in reversed(self.saved):
            setattr(ns, name, fn)


def _union(intervals) -> float:
    total, end = 0.0, -1.0
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def split_trace(events) -> dict:
    """Per-step parts of a chrome trace's events (``_Labels``' ranges)."""
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(PREFIX)]
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in ranges
                   if e["name"] == PREFIX + "step")
    parts = [(e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):])
             for e in ranges if e["name"] != PREFIX + "step"]
    starts = [s for s, _ in steps]
    launch = {}   # correlation -> (step, part)
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        corr = (e.get("args") or {}).get("correlation")
        t = e["ts"]
        k = bisect.bisect_right(starts, t) - 1
        if corr is None or k < 0 or t > steps[k][1]:
            continue
        inner = [p for p in parts if p[0] <= t <= p[1]]
        label = min(inner, key=lambda p: p[1] - p[0])[2] if inner else "glue"
        launch[corr] = (k, label)
    per = [{"parts": {}, "kernels": {}, "iv": []} for _ in steps]
    device = sorted((e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")), key=lambda e: e["ts"])
    last, unmatched = None, 0
    for e in device:
        hit = launch.get((e.get("args") or {}).get("correlation"))
        if hit is None:   # no launch record: by name, in the step before it
            label = next((lab for key, lab in NAMED if key in e["name"]),
                         None)
            if last is None or label is None:
                continue
            hit, unmatched = (last[0], label), unmatched + 1
        last = hit
        k, label = hit
        p = per[k]
        p["parts"][label] = p["parts"].get(label, 0.0) + e["dur"] / 1e3
        p["kernels"][label] = p["kernels"].get(label, 0) + 1
        p["iv"].append((e["ts"], e["ts"] + e["dur"]))
    rows = []
    for (s0, s1), p in zip(steps, per):
        if not p["iv"]:
            continue
        span = (max(b for _, b in p["iv"]) - min(a for a, _ in p["iv"])) / 1e3
        busy = _union(p["iv"]) / 1e3
        rows.append({"parts_ms": p["parts"], "kernels": p["kernels"],
                     "span_ms": span, "busy_ms": busy,
                     "idle_ms": span - busy, "host_ms": (s1 - s0) / 1e3})
    if not rows:
        return {"steps": 0}
    n = len(rows)
    labels = sorted({k for r in rows for k in r["parts_ms"]})
    mean = lambda key: sum(r[key] for r in rows) / n  # noqa: E731
    out = {"steps": n, "kernels_matched_by_name": unmatched,
           "per_step_ms": {k: sum(r["parts_ms"].get(k, 0.0) for r in rows)
                           / n for k in labels},
           "kernels_per_step": {k: sum(r["kernels"].get(k, 0) for r in rows)
                                / n for k in labels},
           "span_ms": mean("span_ms"), "busy_ms": mean("busy_ms"),
           "idle_ms": mean("idle_ms"), "host_ms": mean("host_ms"),
           "first_step": rows[0]}
    out["lu_share_of_busy"] = out["per_step_ms"].get("lu", 0.0) / max(
        out["busy_ms"], 1e-12)
    out["bound"] = "host" if out["host_ms"] > out["busy_ms"] else "device"
    return out


def profile_split(run) -> dict:
    """``run`` once to warm up, then once under the profiler, split."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import seeding
    run()
    torch.cuda.synchronize()
    with _Labels(seeding):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return split_trace(events)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_ato_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    if "--src" in argv:
        sys.path.insert(0, os.path.abspath(argv[argv.index("--src") + 1]))
    import repro_torch
    from repro_torch.core import seeding
    from repro_torch.core.cv import _transition_idx
    from repro_torch.kernels import _build
    _build.build_all()
    print(c.card_line(), flush=True)
    out = {"package": repro_torch.__file__}
    ds, K, y, prev, idx = c._seed_problem("heart", 270)
    out["heart_solo"] = profile_split(
        lambda: seeding.ato_seed(K, y, ds.C, prev, *idx))
    ds, K, y, prev, idx = c._seed_problem("adult", 1000)
    out["adult_solo"] = profile_split(
        lambda: seeding.ato_seed(K, y, ds.C, prev, *idx))
    del K
    for name, n in (("heart", 270), ("adult", 1000)):
        ds, K, y, masks, chunks, Cs, prev = c._ato_row_problem(name, n)
        idx = _transition_idx(chunks, 0, 1, K.device)
        out[f"{name}_row"] = profile_split(
            lambda: seeding.ato_seed_batch(K, y, Cs, prev, *idx,
                                           bucket_by_lane=False))
        del K
    torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
