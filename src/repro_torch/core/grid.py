"""(C, gamma) hyper-parameter grid search over alpha-seeded k-fold CV.

Mirrors ``src/repro/core/grid.py``: ``GridCell``, ``GridReport``,
``_merge_occupancy``, ``_row_lanes``, ``_check_grid_args``, ``grid_plans``
and ``run_grid``. The grid is one Study plan (``repro_torch.core.study``):

* **kernel reuse** — the RBF kernel depends on gamma only, so every C cell
  and fold of a gamma row shares one kernel source, declared as a
  ``KernelSpec`` and materialized through the pool's cache under the
  ``max_resident`` / ``cache_bytes`` budget;
* **fold chains** — lane (gi, ci, h) depends on (gi, ci, h-1) through the
  ``"fold"`` transform of ``method``, so cells advance through their
  chains independently;
* **C-adjacent seeding** (``seed_across_C=True``) — fold 0 of (C_m, gamma)
  warm-starts from fold 0 of (C_{m-1}, gamma) through ``"scale_C"``;
* **cross-gamma pooling** (``pool="cross_gamma"``, the default) — every
  lane of every gamma in one multi-source ``LanePool``; ``"per_gamma"``
  runs one pool per gamma row. A lane's iterate sequence depends only on
  its own (source, mask, C, state), so per-lane results are bitwise the
  same under either pool and any budget.

Per-lane evaluations are plan ``EvalSpec``s; the shrink knobs go to the
plans. With a checkpoint manager (cross-gamma pool only) the whole grid
checkpoints as one study, the reference's ``"study"`` records, so a killed
grid resumes every cell's exact iterates.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cv import _fold_masks, _transition_idx
from repro_torch.core.study import Plan, StudyCheckpoint, run_plan
from repro_torch.data.svm_suite import SVMDataset, kfold_chunks
from repro_torch.device import DTYPE, resolve_device
from repro_torch.svm.sources import KernelSpec


@dataclasses.dataclass
class GridCell:
    C: float
    gamma: float
    iterations: int
    acc_correct: int
    acc_total: int
    converged: bool
    #: the cell's folds' admission transforms and their shares of the
    #: chunks (seconds; the port's addition to the reference's cell)
    seed_s: float = 0.0
    solve_s: float = 0.0

    @property
    def accuracy(self) -> float:
        return self.acc_correct / max(self.acc_total, 1)


@dataclasses.dataclass
class GridReport:
    dataset: str
    method: str
    k: int
    n: int
    kernel_time: float
    seed_time: float
    solve_time: float
    cells: list[GridCell]
    #: LanePool width stats; the cross-gamma pool reports ``per_source``
    #: live widths, the per-gamma pools are merged
    occupancy: dict | None = None
    #: kernel-source cache account (materializations, evictions, peak
    #: resident sources and bytes) over the grid's studies
    resident: dict | None = None

    @property
    def total_iterations(self) -> int:
        return int(sum(c.iterations for c in self.cells))

    def best(self) -> GridCell:
        return max(self.cells, key=lambda c: c.accuracy)

    def rows(self) -> list[dict]:
        return [{"dataset": self.dataset, "method": self.method,
                 "C": c.C, "gamma": c.gamma, "k": self.k,
                 "iterations": c.iterations,
                 "accuracy": round(c.accuracy, 4),
                 "converged": c.converged} for c in self.cells]


def _merge_occupancy(rows: list[dict]) -> dict | None:
    """Aggregate per-pool occupancy dicts into one report: ``programs`` is
    summed (each pool has its own), ``per_source`` blocks merge by source
    key (chunk-weighted mean live width, max peak)."""
    if not rows:
        return None
    chunks = sum(r["chunks"] for r in rows)
    if chunks == 0:
        return {"chunks": 0, "mean_live_width": 0.0, "peak_width": 0}
    merged = {
        "chunks": chunks,
        "mean_live_width": round(
            sum(r["mean_live_width"] * r["chunks"] for r in rows) / chunks, 3),
        "mean_packed_width": round(
            sum(r["mean_packed_width"] * r["chunks"] for r in rows) / chunks,
            3),
        "peak_width": max(r["peak_width"] for r in rows),
        "programs": sum(r["programs"] for r in rows),
    }
    per_source: dict[str, list] = {}
    for r in rows:
        for key, s in (r.get("per_source") or {}).items():
            rec = per_source.setdefault(key, [0.0, 0, 0])  # [sum, n, peak]
            rec[0] += s["mean_live_width"] * s["chunks"]
            rec[1] += s["chunks"]
            rec[2] = max(rec[2], s["peak_live_width"])
    if per_source:
        merged["per_source"] = {
            key: {"chunks": n,
                  "mean_live_width": round(s / max(n, 1), 3),
                  "peak_live_width": peak}
            for key, (s, n, peak) in per_source.items()}
    return merged


def _row_lanes(plan: Plan, gi: int, Cs, masks, transitions, method: str,
               seed_across_C: bool, max_iter: int, zeros, y, chunks) -> None:
    """Declare one gamma row's lane sub-graph (cells x folds) and its
    evaluations on ``plan``; lane ids are (gamma index, C index, fold)."""
    k = masks.shape[0]
    for ci, C in enumerate(Cs):
        if method != "cold" and seed_across_C and ci > 0:
            plan.lane((gi, ci, 0), source=gi, train_mask=masks[0], C=C,
                      dep=(gi, ci - 1, 0), transform="scale_C",
                      params=dict(C_old=Cs[ci - 1], train_mask=masks[0]),
                      max_iter=max_iter)
        else:
            plan.lane((gi, ci, 0), source=gi, train_mask=masks[0], C=C,
                      alpha0=zeros, f0=-y, max_iter=max_iter)
        for h in range(1, k):
            if method == "cold":
                plan.lane((gi, ci, h), source=gi, train_mask=masks[h], C=C,
                          alpha0=zeros, f0=-y, max_iter=max_iter)
            else:
                S_idx, R_idx, T_idx = transitions[h]
                plan.lane((gi, ci, h), source=gi, train_mask=masks[h], C=C,
                          dep=(gi, ci, h - 1), transform="fold",
                          params=dict(method=method, S_idx=S_idx,
                                      R_idx=R_idx, T_idx=T_idx),
                          max_iter=max_iter)
        for h in range(k):
            plan.evaluate((gi, ci, h), chunks[h])


def _check_grid_args(pool: str, source_backend: str, method: str) -> None:
    """The grid's entry contract, checked before any plan is built."""
    if pool not in ("cross_gamma", "per_gamma"):
        raise ValueError(f"unknown pool {pool!r}")
    if source_backend not in ("dense", "pallas_rbf"):
        raise ValueError(f"unknown source_backend {source_backend!r} "
                         "(have 'dense', 'pallas_rbf')")
    if source_backend == "pallas_rbf" and method != "cold":
        raise ValueError("source_backend='pallas_rbf' requires "
                         "method='cold': fold-transition seeders "
                         "slab-index a dense kernel matrix")


def grid_plans(ds: SVMDataset, Cs, gammas, k: int = 10,
               method: str = "sir", tol: float = 1e-3,
               max_iter: int = 5_000_000, seed: int = 0,
               seed_across_C: bool = False, chunk_iters: int = 4096,
               lane_quantum: int = 4, max_width: int | None = None,
               pool: str = "cross_gamma", max_resident: int = 0,
               cache_bytes: int = 0, source_backend: str = "dense",
               device=None, shrink_every: int | str = 0,
               shrink_quantum: int = 128, shrink_caps=None,
               shrink_on_seed: bool = True) -> list:
    """The ``Plan``(s) ``run_grid`` runs for these arguments, built but not
    run: one multi-source plan for ``pool="cross_gamma"``, one plan per
    gamma for ``"per_gamma"``. Their arrays are already on the device
    (``cuda`` unless ``device="cpu"``)."""
    _check_grid_args(pool, source_backend, method)
    dev = resolve_device(device)
    Cs = sorted(float(c) for c in Cs)
    gammas = [float(g) for g in gammas]
    X = torch.as_tensor(ds.X, dtype=DTYPE, device=dev)
    chunks = kfold_chunks(ds.n, k, seed=seed)
    n = chunks.size
    y = torch.as_tensor(ds.y, dtype=DTYPE, device=dev)[:n]
    masks = torch.as_tensor(_fold_masks(chunks), device=dev)
    chunks_dev = torch.as_tensor(chunks, device=dev)
    transitions = {} if method == "cold" else \
        {h: _transition_idx(chunks_dev, h - 1, h) for h in range(1, k)}
    # one DECLARED kernel per gamma: the spec slices X to the k-fold
    # truncation before the kernel call, as run_cv builds its K, which
    # keeps grid cells bitwise equal to run_cv
    sources = {gi: KernelSpec(X=X, gamma=gamma, kind="rbf", n=n)
               for gi, gamma in enumerate(gammas)}
    zeros = torch.zeros(n, dtype=DTYPE, device=dev)

    def make_plan(keys) -> Plan:
        plan = Plan(sources={gi: sources[gi] for gi in keys}, y=y, tol=tol,
                    wss="1" if source_backend == "pallas_rbf" else "2",
                    chunk_iters=chunk_iters, lane_quantum=lane_quantum,
                    max_width=max_width, max_resident=max_resident,
                    cache_bytes=cache_bytes, source_backend=source_backend,
                    device=dev, shrink_every=shrink_every,
                    shrink_quantum=shrink_quantum, shrink_caps=shrink_caps,
                    shrink_on_seed=shrink_on_seed)
        for gi in keys:
            _row_lanes(plan, gi, Cs, masks, transitions, method,
                       seed_across_C, max_iter, zeros, y, chunks)
        return plan

    if pool == "cross_gamma":
        return [make_plan(range(len(gammas)))]
    return [make_plan([gi]) for gi in range(len(gammas))]


def run_grid(ds: SVMDataset, Cs, gammas, k: int = 10, method: str = "sir",
             tol: float = 1e-3, max_iter: int = 5_000_000, seed: int = 0,
             seed_across_C: bool = False, chunk_iters: int = 4096,
             lane_quantum: int = 4, max_width: int | None = None,
             pool: str = "cross_gamma", max_resident: int = 0,
             cache_bytes: int = 0, source_backend: str = "dense",
             checkpoint_manager=None, checkpoint_every: int = 1,
             device=None, shrink_every: int | str = 0,
             shrink_quantum: int = 128, shrink_caps=None,
             shrink_on_seed: bool = True) -> GridReport:
    """Cross-validate every (C, gamma) cell; returns per-cell iterations
    and accuracy (``GridReport.best()`` picks the winner). Runs on
    ``cuda`` unless ``device="cpu"``.

    ``method`` is the fold-chain seeder inside each cell (``"cold"``: every
    lane independent); ``seed_across_C`` also chains fold 0 along
    ascending C within a gamma row. ``pool`` picks the schedule:
    ``"cross_gamma"``, one multi-source pool, or ``"per_gamma"``, one pool
    per gamma row. ``max_resident`` / ``cache_bytes`` (0 = unbounded)
    bound the kernels resident at once; a re-materialized kernel is
    bitwise the evicted one, so per-cell results do not depend on the
    budget. ``kernel_time`` counts every materialization.
    ``source_backend="pallas_rbf"`` solves over the matrix-free
    ``PallasRBF`` (WSS-1, row-slab evaluations) and requires
    ``method="cold"``. Per cell, the result equals ``run_cv`` on that
    cell's (C, gamma) under either pool. ``shrink_every`` (or ``"auto"``
    for the cost model's verdict) turns on active-set shrinking in every
    lane. ``checkpoint_manager`` (cross-gamma pool only) checkpoints the
    grid as one study every ``checkpoint_every``-th chunk."""
    _check_grid_args(pool, source_backend, method)
    if checkpoint_manager is not None and pool != "cross_gamma":
        raise ValueError("grid checkpointing is plan-keyed and needs the "
                         "cross-gamma pool (one study = one record stream)")
    Cs = sorted(float(c) for c in Cs)
    gammas = [float(g) for g in gammas]
    m = len(Cs)
    chunks = kfold_chunks(ds.n, k, seed=seed)
    n = chunks.size
    plans = grid_plans(ds, Cs, gammas, k=k, method=method, tol=tol,
                       max_iter=max_iter, seed=seed,
                       seed_across_C=seed_across_C, chunk_iters=chunk_iters,
                       lane_quantum=lane_quantum, max_width=max_width,
                       pool=pool, max_resident=max_resident,
                       cache_bytes=cache_bytes,
                       source_backend=source_backend, device=device,
                       shrink_every=shrink_every,
                       shrink_quantum=shrink_quantum,
                       shrink_caps=shrink_caps,
                       shrink_on_seed=shrink_on_seed)
    if pool == "cross_gamma":
        checkpoint = None
        if checkpoint_manager is not None:
            checkpoint = StudyCheckpoint(
                manager=checkpoint_manager, every=checkpoint_every,
                meta={"bench": "grid", "dataset": ds.name, "method": method,
                      "k": k, "seed": seed, "tol": tol, "max_iter": max_iter,
                      "Cs": Cs, "gammas": gammas,
                      "seed_across_C": seed_across_C,
                      "shrink_every": shrink_every})
        study_results = [run_plan(plans[0], checkpoint=checkpoint)]
        occupancy = study_results[0].occupancy
    else:
        study_results = [run_plan(p) for p in plans]
        occupancy = _merge_occupancy([s.occupancy for s in study_results])

    seed_time = sum(s.seed_time for s in study_results)
    solve_time = sum(s.solve_time for s in study_results)
    # kernel_time counts every materialization: each gamma's first use,
    # and any re-materialization after an eviction
    kernel_time = sum(s.source_stats.get("kernel_time", 0.0)
                      for s in study_results)
    resident = {
        "materializations": sum(s.source_stats.get("materializations", 0)
                                for s in study_results),
        "evictions": sum(s.source_stats.get("evictions", 0)
                         for s in study_results),
        "peak_resident": max(s.source_stats.get("peak_resident", 0)
                             for s in study_results),
        "peak_resident_bytes": max(
            s.source_stats.get("peak_resident_bytes", 0)
            for s in study_results),
    }
    stats = {lid: st for s in study_results for lid, st in s.stats.items()}
    evals = {lid: ev for s in study_results for lid, ev in s.evals.items()}

    t_sz = chunks.shape[1]
    cells: list[GridCell] = []
    for gi, gamma in enumerate(gammas):
        for ci in range(m):
            lids = [(gi, ci, h) for h in range(k)]
            cells.append(GridCell(
                C=Cs[ci], gamma=gamma,
                iterations=int(sum(stats[lid].n_iter for lid in lids)),
                acc_correct=int(sum(evals[lid][0] for lid in lids)),
                acc_total=int(t_sz * k),
                converged=all(stats[lid].converged for lid in lids),
                seed_s=sum(stats[lid].seed_s for lid in lids),
                solve_s=sum(stats[lid].solve_s for lid in lids)))

    return GridReport(dataset=ds.name, method=method, k=k, n=n,
                      kernel_time=kernel_time, seed_time=seed_time,
                      solve_time=solve_time, cells=cells,
                      occupancy=occupancy, resident=resident)
