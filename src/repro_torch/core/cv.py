"""Alpha-seeded k-fold cross-validation, the paper's protocol.

Mirrors ``src/repro/core/cv.py``: ``FoldStat``, ``CVReport``,
``_transition_idx``, ``_fold_masks``, ``_eval_fold``, ``_eval_fold_rows``,
``run_cv``, ``run_cv_batched`` and ``run_loo``. Each declares its
protocol as a Study plan (``repro_torch.core.study``) and ``run_plan`` runs
it on the lane pool. ``run_cv`` is the paper's fold chain: fold 0 starts
cold, fold h is a lane seeded through the ``"fold"`` transform from the
fold the straggler policy picks, with an ``after`` edge on fold h-1, and
is evaluated on its held-out chunk. ``run_cv_batched`` solves the k cold
folds concurrently: as a k-lane plan (``schedule="repacked"``, over a
dense K or the matrix-free ``PallasRBF``), or as one fixed batch
(``schedule="batched"``). ``run_loo`` is the suppl. Fig. 2 protocol.
Each takes the shrink knobs of ``Plan`` (``svm/shrink.py``).

Checkpoints take the reference's records, steps and retention classes, so
a run of either package resumes from the other's directory. ``run_cv``
saves each completed fold (``phase: "done"`` at ``(h + 1) *
_FOLD_STRIDE``, class ``"done"``) from the pool's retirement callback and,
with ``chunk_iters``, every ``checkpoint_every``-th chunk of the live fold
(``phase: "mid"`` at ``h * _FOLD_STRIDE + 1 + chunk``, class ``"mid"``);
a resumed run restores every done record it keeps (``FoldStat.restored``)
and the newest mid record at its exact state. ``run_cv_batched`` (the
repacked schedule) and ``run_loo`` checkpoint as studies
(``StudyCheckpoint``: ``"batch_mid"`` records from ``_BATCH_BASE``, study
records from ``study.STUDY_BASE``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import seeding
from repro_torch.core.study import Plan, StudyCheckpoint, run_plan
from repro_torch.data.svm_suite import SVMDataset, kfold_chunks
from repro_torch.device import DTYPE, resolve_device
from repro_torch.svm import (DenseKernel, PallasRBF, SMOResult,
                             bias_from_solution, dual_objective,
                             kernel_matrix, predict, smo_solve_batched)

# step numbers in a checkpoint directory: fold h's mid-fold chunk records
# at h * _FOLD_STRIDE + 1 + chunk, its completion record at (h + 1) *
# _FOLD_STRIDE, monotone in (fold, chunk); run_cv_batched's records from
# _BATCH_BASE, above any run_cv step; study records from STUDY_BASE
_FOLD_STRIDE = 1_000_000
_BATCH_BASE = _FOLD_STRIDE ** 2


@dataclasses.dataclass
class FoldStat:
    fold: int
    seed_from: int          # which fold's solution seeded this one (-1 = cold)
    n_iter: int
    init_time: float        # seeding + f-recompute (the paper's "init.")
    solve_time: float       # SMO time (the paper's "the rest": train part)
    acc_correct: int
    acc_total: int
    objective: float
    converged: bool
    restored: bool = False  # rebuilt from a checkpoint (times then read 0.0)


@dataclasses.dataclass
class CVReport:
    dataset: str
    method: str
    k: int
    n: int
    kernel_time: float
    folds: list[FoldStat]
    occupancy: dict = dataclasses.field(default_factory=dict)

    @property
    def total_iterations(self) -> int:
        return int(sum(f.n_iter for f in self.folds))

    @property
    def total_init_time(self) -> float:
        return float(sum(f.init_time for f in self.folds))

    @property
    def total_solve_time(self) -> float:
        return float(sum(f.solve_time for f in self.folds))

    @property
    def accuracy(self) -> float:
        c = sum(f.acc_correct for f in self.folds)
        t = sum(f.acc_total for f in self.folds)
        return c / max(t, 1)


def _transition_idx(chunks, g: int, h: int, device=None):
    """Index sets for seeding fold h from fold g's solution.

    Previous train set = all \\ chunk[g]; new train set = all \\ chunk[h]:
    T (added) = chunk[g], R (removed) = chunk[h], S = the rest. ``chunks``
    is the (k, n/k) array, or that array as a tensor already on the device
    (then no copy from the host, so no sync).
    """
    k = chunks.shape[0]
    rest = [chunks[j] for j in range(k) if j not in (g, h)]
    if isinstance(chunks, torch.Tensor):
        return torch.cat(rest), chunks[h], chunks[g]
    return tuple(torch.as_tensor(a, device=device)
                 for a in (np.concatenate(rest), chunks[h], chunks[g]))


def _fold_masks(chunks: np.ndarray) -> np.ndarray:
    """(k, n) boolean train masks; row h is True off fold h's test chunk."""
    k, n = chunks.shape[0], chunks.size
    masks = np.ones((k, n), bool)
    for h in range(k):
        masks[h, chunks[h]] = False
    return masks


def _eval_fold(K, y, chunks, h, res, C) -> tuple[int, int, float]:
    """(acc_correct, acc_total, objective) of fold h's held-out chunk."""
    test_idx = torch.as_tensor(chunks[h], device=K.device)
    train_mask = torch.ones(chunks.size, dtype=torch.bool, device=K.device)
    train_mask[test_idx] = False
    b = bias_from_solution(res, y, train_mask, C)
    pred = predict(K[test_idx], y, res.alpha, b)
    return (int((pred == y[test_idx]).sum()), int(test_idx.shape[0]),
            float(dual_objective(K, y, res.alpha)))


def _eval_fold_rows(source, y, chunks, h, res, C) -> tuple[int, int, float]:
    """``_eval_fold`` for row-streaming sources: the test chunk's kernel
    rows come from ``rows_at`` and the dual objective's quadratic term from
    the streaming ``matvec``; no (n, n) matrix is ever resident."""
    test_idx = torch.as_tensor(chunks[h], device=y.device)
    train_mask = torch.ones(chunks.size, dtype=torch.bool, device=y.device)
    train_mask[test_idx] = False
    b = bias_from_solution(res, y, train_mask, C)
    pred = predict(source.rows_at(test_idx), y, res.alpha, b)
    v = res.alpha * y
    obj = res.alpha.sum() - 0.5 * torch.dot(v, source.matvec(v))
    return (int((pred == y[test_idx]).sum()), int(test_idx.shape[0]),
            float(obj))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cv(ds: SVMDataset, k: int = 10, method: str = "sir",
           tol: float = 1e-3, max_iter: int = 5_000_000, seed: int = 0,
           checkpoint_manager=None, straggler_policy: str = "strict",
           unavailable_folds: frozenset[int] = frozenset(),
           chunk_iters: int | None = None, checkpoint_every: int = 1,
           device=None, shrink_every: int | str = 0,
           shrink_quantum: int = 128, shrink_caps=None,
           shrink_on_seed: bool = True) -> CVReport:
    """Run alpha-seeded k-fold CV with ``method`` in ``seeding.SEEDERS``;
    runs on ``cuda`` unless ``device="cpu"``.

    The fold chain is one plan: fold h is a lane whose seed dependency
    carries the ``"fold"`` transform, and an ``after`` edge on fold h-1
    keeps the paper's sequential protocol. ``unavailable_folds`` simulates
    stragglers or failures: those folds still solve, but do not seed.
    ``straggler_policy="strict"`` (the paper) seeds fold h from fold h-1
    or starts it cold; ``"best_available"`` seeds it from the nearest
    completed fold (the earlier one on a tie). ``chunk_iters`` sets the
    iterations between the host's reads of a fold's done flag (default:
    one chunk of ``max_iter``). ``shrink_every`` turns on active-set
    shrinking inside each fold's solve (0, the default, keeps every iterate
    as without it); seeded folds start compact with ``shrink_on_seed``.

    With ``checkpoint_manager`` every completed fold is saved, and with
    ``chunk_iters`` every ``checkpoint_every``-th chunk of the live fold
    too; a run restarts from the folds and the mid-fold state it finds
    (restored folds report ``restored=True`` and 0.0 times). Mid-fold
    records carry no shrink ledger, so shrinking together with them is
    refused."""
    seeding.SEEDERS[method]   # validate the method name up front
    if shrink_every and checkpoint_manager is not None \
            and chunk_iters is not None:
        raise ValueError(
            "run_cv mid-fold checkpoints do not record the shrink ledger; "
            "use shrink_every=0 here, drop chunk_iters, or switch to a "
            "study-keyed driver (run_cv_batched / run_grid)")
    dev = resolve_device(device)
    X = torch.as_tensor(ds.X, dtype=DTYPE, device=dev)
    y = torch.as_tensor(ds.y, dtype=DTYPE, device=dev)

    chunks = kfold_chunks(ds.n, k, seed=seed)
    n = chunks.size  # truncated n (multiple of k)
    # slice X to the k-fold truncation BEFORE the kernel call, as the
    # reference does (the two slice orders differ in final bits)
    _sync(dev)
    t0 = time.perf_counter()
    K = kernel_matrix(X[:n], X[:n], kind="rbf", gamma=ds.gamma)
    _sync(dev)
    kernel_time = time.perf_counter() - t0
    y = y[:n]
    masks = torch.as_tensor(_fold_masks(chunks), device=dev)
    chunks_dev = torch.as_tensor(chunks, device=dev)

    results: dict[int, SMOResult] = {}
    restored_meta: dict[int, dict] = {}
    folds: list[FoldStat] = []
    start_fold = 0
    resume = None   # (alpha, f, n_iter, seed_from) of an in-flight fold
    if checkpoint_manager is not None:
        # run_cv's records live below _BATCH_BASE; batch and study records
        # are resumable only through run_plan
        cv_steps = [s for s in checkpoint_manager.all_steps()
                    if s < _BATCH_BASE]
        latest = cv_steps[-1] if cv_steps else None
        # every retained done record (the report covers the pre-crash
        # folds, and the strict policy needs fold h-1 to seed fold h); a
        # mid record only when it is the latest
        for s in cv_steps:
            if s % _FOLD_STRIDE != 0 and s != latest:
                continue
            step, tree, extra = checkpoint_manager.restore(step=s)
            # only the same run resumes: a done record survives a method
            # change (seeding never moves the fixed point), a mid record
            # is the method's trajectory
            want = {"k": k, "dataset": ds.name, "seed": seed}
            if extra.get("phase") == "mid":
                want["method"] = method
            got = {key: extra.get(key) for key in want}
            if got != want:
                raise ValueError(
                    f"checkpoint at step {step} belongs to run {got}, cannot "
                    f"resume it as {want}; point the manager at a fresh "
                    "directory or delete the stale checkpoints")
            if extra.get("phase") == "mid":   # only possible for the latest
                start_fold = extra["fold"]
                resume = (torch.as_tensor(tree["alpha"], device=dev),
                          torch.as_tensor(tree["f"], device=dev),
                          int(tree["n_iter"]), extra["seed_from"])
            else:
                results[extra["fold"]] = _result_from_tree(tree, dev)
                restored_meta[extra["fold"]] = extra
                start_fold = max(start_fold, extra["fold"] + 1)

    # the restored folds' stats, for records of this method only (another
    # method's n_iter is that method's trajectory)
    for h in sorted(results):
        if restored_meta[h].get("method") != method:
            continue
        res = results[h]
        correct, total, obj = _eval_fold(K, y, chunks, h, res, ds.C)
        folds.append(FoldStat(
            fold=h, seed_from=restored_meta[h].get("seed_from", -1),
            n_iter=int(res.n_iter), init_time=0.0, solve_time=0.0,
            acc_correct=correct, acc_total=total, objective=obj,
            converged=bool(res.converged), restored=True))

    plan = Plan(sources={"cv": DenseKernel(K)}, y=y, tol=tol,
                shrink_every=shrink_every, shrink_quantum=shrink_quantum,
                shrink_caps=shrink_caps, shrink_on_seed=shrink_on_seed,
                chunk_iters=chunk_iters if chunk_iters is not None
                else max_iter, device=dev)
    for g in sorted(results):
        plan.lane(g, result=results[g])
    # the seed-fold choice is deterministic: live folds run in order (the
    # ``after`` chain), so fold h sees the restored folds and every earlier
    # live fold as completed
    seed_froms: dict[int, int] = {}
    base_counts: dict[int, int] = {}
    done_folds = sorted(results)
    prev_lane = None
    zeros = torch.zeros(n, dtype=DTYPE, device=dev)
    for h in range(start_fold, k):
        avail = [g for g in done_folds if g not in unavailable_folds]
        if resume is not None and h == start_fold:
            seed_from = resume[3]
        elif h == 0 or method == "cold" or not avail:
            seed_from = -1
        elif straggler_policy == "strict":
            seed_from = h - 1 if (h - 1) in avail else -1
        else:  # best_available: nearest completed fold
            seed_from = min(avail, key=lambda g: abs(h - g))
        seed_froms[h] = seed_from
        base_counts[h] = 0
        common = dict(train_mask=masks[h], C=ds.C, max_iter=max_iter,
                      after=prev_lane)
        if resume is not None and h == start_fold:
            alpha0, f0, n_iter0, _ = resume
            base_counts[h] = (n_iter0 // chunk_iters
                              if chunk_iters is not None else 0)
            plan.lane(h, alpha0=alpha0, f0=f0, n_iter0=n_iter0, **common)
        elif seed_from < 0:
            plan.lane(h, alpha0=zeros, f0=-y, **common)
        else:
            S_idx, R_idx, T_idx = _transition_idx(chunks_dev, seed_from, h)
            plan.lane(h, dep=seed_from, transform="fold",
                      params=dict(method=method, S_idx=S_idx, R_idx=R_idx,
                                  T_idx=T_idx), **common)
        done_folds.append(h)
        prev_lane = h

    record = {"method": method, "k": k, "dataset": ds.name, "seed": seed}
    on_lane_chunk = None
    if checkpoint_manager is not None and chunk_iters is not None:
        # the chunk counter starts from the restored n_iter, so a resumed
        # run's records outnumber the pre-crash ones
        counters = dict(base_counts)

        def on_lane_chunk(h, state):
            counters[h] += 1
            if counters[h] % checkpoint_every:
                return
            step = h * _FOLD_STRIDE + min(counters[h], _FOLD_STRIDE - 2) + 1
            # mid records retain apart from done records: frequent, and
            # never evicting what a resume depends on
            checkpoint_manager.save(
                step, {"alpha": state.alpha, "f": state.f,
                       "n_iter": state.n_iter},
                extra_meta={"phase": "mid", "fold": h,
                            "seed_from": seed_froms[h], **record},
                blocking=False, retain_class="mid")

    on_result = None
    if checkpoint_manager is not None:
        def on_result(h, res):
            checkpoint_manager.save(
                (h + 1) * _FOLD_STRIDE,
                {"alpha": res.alpha, "f": res.f, "n_iter": res.n_iter,
                 "converged": res.converged, "b_up": res.b_up,
                 "b_low": res.b_low},
                extra_meta={"phase": "done", "fold": h,
                            "seed_from": seed_froms[h], **record},
                blocking=False, retain_class="done")

    sres = run_plan(plan, on_result=on_result, on_lane_chunk=on_lane_chunk)
    for h in range(start_fold, k):
        res, stat = sres.results[h], sres.stats[h]
        correct, total, obj = _eval_fold(K, y, chunks, h, res, ds.C)
        folds.append(FoldStat(
            fold=h, seed_from=seed_froms[h], n_iter=stat.n_iter,
            init_time=stat.seed_s, solve_time=stat.solve_s,
            acc_correct=correct, acc_total=total, objective=obj,
            converged=stat.converged))
    if checkpoint_manager is not None:
        checkpoint_manager.wait()
    return CVReport(dataset=ds.name, method=method, k=k, n=n,
                    kernel_time=kernel_time, folds=folds,
                    occupancy=sres.occupancy)


def run_cv_batched(ds: SVMDataset, k: int = 10, tol: float = 1e-3,
                   max_iter: int = 5_000_000, seed: int = 0,
                   chunk_iters: int = 4096, schedule: str = "repacked",
                   lane_quantum: int = 4, max_width: int | None = None,
                   source_backend: str = "dense", checkpoint_manager=None,
                   checkpoint_every: int = 1, device=None,
                   shrink_every: int | str = 0, shrink_quantum: int = 128,
                   shrink_caps=None, shrink_on_seed: bool = True) -> CVReport:
    """Cold k-fold CV with all folds solved concurrently; runs on ``cuda``
    unless ``device="cpu"``.

    ``schedule="repacked"`` (method "cold_batched_repacked") runs the folds
    as a k-lane plan on the lane pool: converged folds retire between
    chunks and the live ones are repacked; the width is capped by the cost
    model (width-1 round-robin on the CPU, all live lanes on ``cuda``).
    ``schedule="batched"`` (method "cold_batched") is the fixed-width
    ``smo_solve_batched`` batch. ``source_backend="pallas_rbf"`` (repacked
    only, method "cold_pallas") solves over the matrix-free ``PallasRBF``
    under WSS-1: no (n, n) kernel is built (``kernel_time`` covers the row
    norms only), each iteration is one fused pass over X, and evaluation
    streams test rows through ``rows_at`` and the objective through
    ``matvec``. Per fold, each schedule ends bitwise where ``run_cv(method=
    "cold")``'s solve over the same source would. ``shrink_every``
    (repacked only) shrinks each lane's active set; lanes of one cap bucket
    then run as one launch over their own compact operands. With
    ``checkpoint_manager`` (repacked only), every ``checkpoint_every``-th
    chunk saves all lanes keyed by fold id as one ``"batch_mid"`` record,
    so a crashed run resumes each fold's exact iterates under any packing.
    """
    if schedule not in ("repacked", "batched"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if checkpoint_manager is not None and schedule != "repacked":
        raise ValueError("mid-batch checkpointing requires the repacked "
                         "schedule (snapshots are keyed by scheduler lane)")
    if shrink_every and schedule != "repacked":
        raise ValueError("shrink_every requires the repacked schedule: "
                         "shrinking is a lane-pool transformation, not an "
                         "engine.solve_batched feature")
    if source_backend not in ("dense", "pallas_rbf"):
        raise ValueError(f"unknown source_backend {source_backend!r}")
    if source_backend == "pallas_rbf" and schedule != "repacked":
        raise ValueError("source_backend='pallas_rbf' requires the repacked "
                         "schedule: the streaming source runs through the "
                         "lane pool, not engine.solve_batched on a matrix")
    dev = resolve_device(device)
    X = torch.as_tensor(ds.X, dtype=DTYPE, device=dev)
    y = torch.as_tensor(ds.y, dtype=DTYPE, device=dev)

    chunks = kfold_chunks(ds.n, k, seed=seed)
    n = chunks.size
    # slice before the kernel call (see run_cv)
    _sync(dev)
    t0 = time.perf_counter()
    if source_backend == "pallas_rbf":
        K = None
        source = PallasRBF(X[:n], ds.gamma)
    else:
        K = kernel_matrix(X[:n], X[:n], kind="rbf", gamma=ds.gamma)
        source = DenseKernel(K)
    _sync(dev)
    kernel_time = time.perf_counter() - t0
    y = y[:n]
    masks = torch.as_tensor(_fold_masks(chunks), device=dev)
    zeros = torch.zeros((k, n), dtype=DTYPE, device=dev)

    if schedule == "batched":
        t0 = time.perf_counter()
        res = smo_solve_batched(K, y, masks, ds.C, zeros, -y.repeat(k, 1),
                                tol=tol, max_iter=max_iter,
                                chunk_iters=chunk_iters)
        _sync(dev)
        solve_time = time.perf_counter() - t0
        folds = []
        for h in range(k):
            fold_res = type(res)(*(t[h] for t in res))
            correct, total, obj = _eval_fold(K, y, chunks, h, fold_res, ds.C)
            folds.append(FoldStat(
                fold=h, seed_from=-1, n_iter=int(fold_res.n_iter),
                init_time=0.0, solve_time=solve_time / k,
                acc_correct=correct, acc_total=total, objective=obj,
                converged=bool(fold_res.converged)))
        return CVReport(dataset=ds.name, method="cold_batched", k=k, n=n,
                        kernel_time=kernel_time, folds=folds)

    # ---- repacked schedule: a k-lane cold plan ----
    method = ("cold_pallas" if source_backend == "pallas_rbf"
              else "cold_batched_repacked")
    plan = Plan(sources={"cv": source}, y=y, tol=tol,
                shrink_every=shrink_every, shrink_quantum=shrink_quantum,
                shrink_caps=shrink_caps, shrink_on_seed=shrink_on_seed,
                wss="1" if source_backend == "pallas_rbf" else "2",
                chunk_iters=chunk_iters, lane_quantum=lane_quantum,
                max_width=max_width, device=dev)
    for h in range(k):
        plan.lane(h, train_mask=masks[h], C=ds.C, alpha0=zeros[h], f0=-y,
                  max_iter=max_iter)
    checkpoint = None
    if checkpoint_manager is not None:
        # tol and max_iter are part of the run's identity: retired lanes
        # carry fixed points at the snapshot's tolerance and budget
        checkpoint = StudyCheckpoint(
            manager=checkpoint_manager, every=checkpoint_every,
            retain_class="batch", phase="batch_mid", base_step=_BATCH_BASE,
            meta={"k": k, "dataset": ds.name, "seed": seed, "tol": tol,
                  "max_iter": max_iter, "method": method})
    t0 = time.perf_counter()
    sres = run_plan(plan, checkpoint=checkpoint)
    solve_time = time.perf_counter() - t0

    done_at_start = sres.restored
    live = max(k - len(done_at_start), 1)
    folds = []
    for h in range(k):
        res = sres.results[h]
        correct, total, obj = (
            _eval_fold(K, y, chunks, h, res, ds.C) if K is not None
            else _eval_fold_rows(source, y, chunks, h, res, ds.C))
        folds.append(FoldStat(
            fold=h, seed_from=-1, n_iter=int(res.n_iter), init_time=0.0,
            solve_time=0.0 if h in done_at_start else solve_time / live,
            acc_correct=correct, acc_total=total, objective=obj,
            converged=bool(res.converged), restored=h in done_at_start))
    return CVReport(dataset=ds.name, method=method, k=k, n=n,
                    kernel_time=kernel_time, folds=folds,
                    occupancy=sres.occupancy)


def _result_from_tree(tree, device) -> SMOResult:
    """A done record's ``SMOResult``, its tensors on ``device``."""
    return SMOResult(*(torch.as_tensor(tree[name], device=device)
                       for name in SMOResult._fields))


LOO_METHODS = ("cold", "avg", "top", "ato", "mir", "sir")


def run_loo(ds: SVMDataset, method: str = "sir", rounds: int | None = None,
            tol: float = 1e-3, max_iter: int = 2_000_000, seed: int = 0,
            chunk_iters: int = 4096, max_width: int | None = None,
            checkpoint_manager=None, checkpoint_every: int = 1,
            device=None) -> dict:
    """Leave-one-out CV (paper suppl. Fig. 2) over the first ``rounds``
    instances; runs on ``cuda`` unless ``device="cpu"``. AVG/TOP seed every
    round from the full-data SVM (``"loo_avg"`` / ``"loo_top"``); ATO, MIR
    and SIR chain round t from round t-1 through the ``"fold"`` transform
    (T = the instance returned, R = the instance removed; round 0 enters
    from the full SVM by AVG); cold starts every round from zero.

    The protocol is one plan: the full-data solve is a lane, and the
    AVG/TOP rounds all depend on it alone, so they fan out through the
    pool's batched dispatch. With ``checkpoint_manager`` the plan
    checkpoints as a study (``"study"`` records, every
    ``checkpoint_every``-th chunk); ``seed`` only names those records (the
    protocol draws nothing). Beside the reference's keys, ``converged``
    says whether the full lane and every round converged."""
    if method not in LOO_METHODS:
        raise ValueError(f"unknown LOO method {method!r}")
    dev = resolve_device(device)
    X = torch.as_tensor(ds.X, dtype=DTYPE, device=dev)
    y = torch.as_tensor(ds.y, dtype=DTYPE, device=dev)
    n = ds.n
    rounds = n if rounds is None else min(rounds, n)

    t_start = time.perf_counter()
    K = kernel_matrix(X, X, kind="rbf", gamma=ds.gamma)

    plan = Plan(sources={"loo": DenseKernel(K)}, y=y, tol=tol,
                chunk_iters=chunk_iters, max_width=max_width, device=dev)
    zeros = torch.zeros(n, dtype=DTYPE, device=dev)
    # round t's training mask: every instance but t (one copy to the card)
    masks = torch.as_tensor(~np.eye(rounds, n, dtype=bool), device=dev)
    rows = torch.arange(n, device=dev)
    # full-data SVM (shared by AVG/TOP; also round -1 for the chain methods)
    plan.lane("full", train_mask=torch.ones(n, dtype=torch.bool, device=dev),
              C=ds.C, alpha0=zeros, f0=-y, max_iter=max_iter)
    for t in range(rounds):
        common = dict(train_mask=masks[t], C=ds.C, max_iter=max_iter)
        if method == "cold":
            plan.lane(t, alpha0=zeros, f0=-y, **common)
        elif method in ("avg", "top"):
            plan.lane(t, dep="full", transform=f"loo_{method}",
                      params={"t": t}, **common)
        elif t == 0:
            # first round: remove t from the full SVM (AVG-style entry)
            plan.lane(0, dep="full", transform="loo_avg", params={"t": 0},
                      **common)
        else:
            plan.lane(t, dep=t - 1, transform="fold",
                      params=dict(method=method,
                                  S_idx=torch.cat([rows[:t - 1],
                                                   rows[t + 1:]]),
                                  R_idx=rows[t:t + 1],
                                  T_idx=rows[t - 1:t]), **common)
        plan.evaluate(t, np.asarray([t]))

    checkpoint = None
    if checkpoint_manager is not None:
        checkpoint = StudyCheckpoint(
            manager=checkpoint_manager, every=checkpoint_every,
            meta={"bench": "loo", "dataset": ds.name, "method": method,
                  "rounds": rounds, "seed": seed, "tol": tol,
                  "max_iter": max_iter})
    sres = run_plan(plan, checkpoint=checkpoint)
    total_iters = sum(sres.stats[t].n_iter for t in range(rounds))
    correct = sum(sres.evals[t][0] for t in range(rounds))
    elapsed = time.perf_counter() - t_start
    return {"dataset": ds.name, "method": method, "rounds": rounds,
            "base_iterations": sres.stats["full"].n_iter,
            "iterations": total_iters,
            "elapsed_s": round(elapsed, 4),
            "accuracy": round(correct / rounds, 4),
            "converged": all(st.converged for st in sres.stats.values())}
