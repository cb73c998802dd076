"""Measure the lane pool's cost model on one GPU and write the port's file.

    python3 chip_cost_model.py [--out PATH] [--quick]

The port's counterpart of the reference's ``scripts/measure_cost_model.py``,
with its problem, metric and rules, run on the port's own ``LanePool`` on
the card for both source kinds (``dense``: a precomputed K, and
``pallas_rbf``: the matrix-free ``PallasRBF``):

* **problem** — n=1,000 random rows of d=40 (``np.random.default_rng(0)``),
  labels +-1, RBF gamma 0.5; eight lanes with C from ``C_SPREAD`` and
  train masks from ``np.random.default_rng(10 + h)`` (85% of the rows), so
  convergence is staggered;
* **metric** — wall seconds of ``LanePool.run()``, from a
  ``torch.cuda.synchronize`` before it to one after it, per useful
  lane-iteration (the sum of the lanes' ``n_iter``), best of ``--reps``;
* **width verdict** at each forced ``max_width`` (1, 2, 4, 8): 1 when width
  1 is within ``SLACK`` (10%) of the best width, 0 (unbounded) when the
  widest is the best, else the best width;
* **shrink verdict** — the width-1 pool (two lanes) at n/4, n/2 and n:
  shrinking pays only when n/4 costs at most 1 / ``SHRINK_SLACK`` (half) of
  n per iteration.

The kernels are built first, all sources at once, and each pool shape runs
once untimed before it is timed. The result goes into the cost-model file
(``results/cost_model_torch.json`` unless ``--out`` or ``REPRO_COST_MODEL``
names another) as its ``cuda`` entries, with ``meta.cuda`` naming the card
and its power limit as ``nvidia-smi`` prints them, torch, CUDA, n, d, the
widths and reps; the file's other entries (its verbatim copy of the
reference's ``cpu`` entry) stay as they are. Re-run it when the chunk
kernels or the pool's dispatch change. Without a CUDA device it exits
non-zero and writes nothing.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: width 1 keeps the cap unless a batched width beats it by this factor
SLACK = 1.10
#: shrinking pays only when the quarter-size problem is at least this much
#: cheaper per iteration than the full one
SHRINK_SLACK = 2.0
#: staggered-convergence lane spread (the reference's)
C_SPREAD = (0.25, 0.5, 1.0, 2.0, 4.0, 1.0, 0.5, 2.0)
GAMMA = 0.5


def width_verdict(cost: dict, widths) -> int:
    """The reference's width rule over ``{str(width): us per lane-iter}``."""
    best = min(widths, key=lambda w: cost[str(w)])
    if cost["1"] <= SLACK * cost[str(best)]:
        return 1
    if best == max(widths):
        return 0                            # more is better: unbounded
    return best


def shrink_verdict(cost_by_n: dict) -> bool:
    """The reference's shrink rule over ``{str(n): us per iteration}``."""
    ns = [int(k) for k in cost_by_n]
    full, small = cost_by_n[str(max(ns))], cost_by_n[str(min(ns))]
    return bool(small * SHRINK_SLACK <= full)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _problem(n: int, d: int, n_lanes: int, dev):
    """The reference's problem (same draws), on ``dev``."""
    from repro_torch.svm.engine import DenseKernel, PallasRBF
    from repro_torch.svm.kernels import kernel_matrix
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.normal(size=(n, d)), device=dev)
    y = torch.as_tensor(np.where(rng.random(n) < 0.5, -1.0, 1.0), device=dev)
    masks = [torch.as_tensor(np.random.default_rng(10 + h).random(n) < 0.85,
                             device=dev) for h in range(n_lanes)]
    Cs = [C_SPREAD[h % len(C_SPREAD)] for h in range(n_lanes)]
    sources = {"dense": DenseKernel(kernel_matrix(X, X, gamma=GAMMA)),
               "pallas_rbf": PallasRBF(X, GAMMA)}
    return sources, y, masks, Cs


def _run(kind, source, y, masks, Cs, *, width: int, chunk_iters: int):
    """(seconds, useful lane-iterations) of one pool run."""
    from repro_torch.svm.scheduler import LanePool
    pool = LanePool({kind: source}, y, wss="1" if source.fused else "2",
                    max_width=width, chunk_iters=chunk_iters)
    for h, (mask, C) in enumerate(zip(masks, Cs)):
        pool.add(h, mask, C, torch.zeros_like(y), -y, source=kind)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = pool.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return dt, sum(int(r.n_iter) for r in results.values())


def measure_kind(kind, source, y, masks, Cs, *, widths, chunk_iters,
                 reps) -> dict:
    """us per useful lane-iteration at each forced ``max_width``."""
    for w in sorted({1, max(widths)}):      # untimed: load and warm
        _run(kind, source, y, masks, Cs, width=w, chunk_iters=chunk_iters)
    cost, iters = {}, {}
    for w in widths:
        best = np.inf
        for _ in range(reps):
            dt, it = _run(kind, source, y, masks, Cs, width=w,
                          chunk_iters=chunk_iters)
            best = min(best, dt / max(it, 1))
        cost[str(w)], iters[str(w)] = best * 1e6, it
        print(f"  {kind:>10s} width {w:>2d}: {cost[str(w)]:9.4f} "
              "us/useful-lane-iter", flush=True)
    return {"max_width": width_verdict(cost, widths),
            "us_per_lane_iter": cost, "lane_iters": iters}


def measure_shrink(kind, *, ns, d, chunk_iters, reps, dev,
                   n_lanes: int = 2) -> dict:
    """us per useful iteration of the width-1 pool at each size in ``ns``
    (the shapes a shrunk lane's compact chunks run at)."""
    cost = {}
    for m in sorted(ns):
        sources, y, masks, Cs = _problem(m, d, n_lanes, dev)
        best = np.inf
        for rep in range(reps + 1):         # rep 0 warms
            dt, it = _run(kind, sources[kind], y, masks, Cs, width=1,
                          chunk_iters=chunk_iters)
            if rep:
                best = min(best, dt / max(it, 1))
        cost[str(m)] = best * 1e6
        print(f"  {kind:>10s} n {m:>5d}: {cost[str(m)]:9.4f} us/iter",
              flush=True)
    return {"shrink": shrink_verdict(cost), "us_per_iter_by_n": cost}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--d", type=int, default=40)
    ap.add_argument("--chunk-iters", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--widths", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--out", default=None,
                    help="output path (default: the cost model's path)")
    ap.add_argument("--quick", action="store_true",
                    help="a short run (n=200, widths 1 and 2, one rep)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_cost_model: no CUDA device", file=sys.stderr)
        return 1
    if args.quick:
        args.n, args.chunk_iters, args.reps = 200, 256, 1
        args.widths = [1, 2]
    if 1 not in args.widths:
        ap.error("widths must include 1 (the sequential baseline)")
    from repro_torch.kernels import _build
    from repro_torch.svm import cost_model
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    dev = torch.device("cuda")
    out_path = pathlib.Path(args.out) if args.out else cost_model.model_path()
    try:
        model = json.loads(out_path.read_text())
        assert isinstance(model.get("entries"), dict)
    except (OSError, ValueError, AssertionError):
        model = {"entries": {}}
    model["schema"] = 1
    entries = model["entries"].setdefault("cuda", {})
    sources, y, masks, Cs = _problem(args.n, args.d, max(args.widths), dev)
    for kind, src in sources.items():
        entries[kind] = measure_kind(kind, src, y, masks, Cs,
                                     widths=args.widths,
                                     chunk_iters=args.chunk_iters,
                                     reps=args.reps)
    shrink_ns = sorted({max(64, args.n // 4), max(64, args.n // 2), args.n})
    for kind in ("dense", "pallas_rbf"):
        entries[kind].update(measure_shrink(
            kind, ns=shrink_ns, d=args.d, chunk_iters=args.chunk_iters,
            reps=args.reps, dev=dev))
    model.setdefault("meta", {})["cuda"] = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0), "n": args.n, "d": args.d,
        "chunk_iters": args.chunk_iters, "widths": args.widths,
        "n_lanes": len(masks), "reps": args.reps, "quick": bool(args.quick),
        "slack": SLACK, "shrink_slack": SHRINK_SLACK, "shrink_ns": shrink_ns,
        "script": "chip_cost_model.py",
        "seconds": round(time.perf_counter() - t0, 3)}
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(model, indent=2, sort_keys=True) + "\n")
    for kind, e in entries.items():
        print(f"cuda/{kind}: max_width={e['max_width']} "
              f"shrink={e['shrink']}", flush=True)
    print(json.dumps({"cuda": entries, "meta": model["meta"]["cuda"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
