"""Where SIR's greedy pass and water_fill spend their time on one GPU.

    python3 chip_sir_split.py

Builds the port's kernels, then at adult n = 32,560 (K from the RBF
kernel, fold 0 -> 1 of k = 10, 5 and 3 folds: |R| = |T| = 3,256, 6,512
and 10,853) profiles ``sir_greedy`` as ``sir_seed`` calls it, for the
list length and segment size it takes and for others, with
``torch.profiler``: each of its kernels' device time per call
(``sir_order_kernel``, the list passes, the walks), and the rescanned and
fallback rows per call. Then the list pass alone over every row
(``sir_candidate_lists``, CUDA events), and ``water_fill`` at 800 and
26,048 rows (seeded, the SVM box and per-row bounds) at each forced
levels a round and the one-level witness build (CUDA graphs). Prints the
card's name and power limit first and one JSON object last.
"""
from __future__ import annotations

import json
import os
import re
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: (list length, segment rows) profiled beside the wrapper's own choice
SIR_SHAPES = ((32, 1024), (64, 1024), (64, 2048), (64, 0))


def _profile_sir(run, reps: int = 3) -> dict:
    """{kernel: device ms per call} of ``reps`` calls of ``run``."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:   # the kernel's name, before its <...>(
            name = re.search(r"(\w+)(<[^>]*>)?\(", e.key)
            out[name.group(1) if name else e.key] = (
                e.device_time_total / (1e3 * reps))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_sir_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from repro_torch.data.svm_suite import make_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels import seeding as ks
    from repro_torch.svm import kernel_matrix
    _build.build_all(_build.SOURCES + ("water_fill_seq",))
    print(c.card_line(), flush=True)
    ds = make_dataset("adult", n_override=c.SIZE_N)
    dev = torch.device("cuda")
    X = torch.as_tensor(ds.X[:c.SIZE_N - 1], device=dev)
    y = torch.as_tensor(ds.y[:c.SIZE_N - 1], dtype=torch.float64,
                        device=dev)
    K = kernel_matrix(X, X, gamma=ds.gamma)
    out = {"sir_greedy": {}, "water_fill": {}}
    for k in c.SIR_SIZE_K:
        a = c._sir_size_inputs(K, y, k)
        m = a[4].shape[0]
        rows = {}
        shapes = ((ks.SIR_LIST, None),) + SIR_SHAPES
        for L, seg in shapes:
            def run():
                return ks.sir_greedy(K, *a[:4], "random", *a[4:], _list=L,
                                     _segment=seg)
            ks.reset_sir_greedy_events()
            run()
            events = ks.sir_greedy_events()
            key = f"{L}/{ks.sir_segment(m) if seg is None else seg}"
            rows[key + (" (taken)" if seg is None else "")] = {
                "kernels_ms": _profile_sir(run), **events}
        rows["lists_alone_ms"] = c.cuda_ms(
            lambda: ks.sir_candidate_lists(K, a[0], a[1], ks.SIR_LIST,
                                           a[4], a[5]), 5)
        out["sir_greedy"][str(m)] = rows
    del K
    torch.cuda.empty_cache()
    rng = np.random.default_rng(7)
    for a in c._water_fill_big(float(ds.C), (800, 26048)):
        n = a[0].shape[0]
        free = (torch.as_tensor(-rng.random(n) * ds.C, device=dev),
                torch.as_tensor(rng.random(n) * ds.C, device=dev))
        unboxed = (torch.clamp(a[0], *free),) + free + (a[3],)
        for name, args in (("box", a), ("bounds", unboxed)):
            row = {"seq": c.graph_ms(lambda: ks.water_fill(
                *args, _build_name="water_fill_seq"), 10)}
            for lv in (1, 2, 3, 4, 5):
                row[str(lv)] = c.graph_ms(
                    lambda: ks.water_fill(*args, _levels=lv), 10)
            out["water_fill"][f"{n}/{name}"] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
