"""Alpha-seeded k-fold cross-validation, the paper's protocol.

Mirrors ``src/repro/core/cv.py``: ``FoldStat``, ``CVReport``,
``_transition_idx``, ``_fold_masks``, ``_eval_fold`` and ``run_cv``. The
reference declares the fold chain as a Study plan run by its lane pool;
here ``run_cv`` is the direct loop with the same semantics under the
``strict`` straggler policy: fold 0 starts cold, fold h is seeded from fold
h-1 (``f0 = init_f``), solved, and evaluated on its held-out chunk.
Checkpoints, stragglers, shrinking, the batched schedules and the Study
layer are later slices of the port.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import seeding
from repro_torch.data.svm_suite import SVMDataset, kfold_chunks
from repro_torch.device import DTYPE, resolve_device
from repro_torch.svm import (bias_from_solution, dual_objective, init_f,
                             kernel_matrix, predict, smo_solve)


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


@dataclasses.dataclass
class CVReport:
    dataset: str
    method: str
    k: int
    n: int
    kernel_time: float
    folds: list[FoldStat]

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


def _transition_idx(chunks: np.ndarray, g: int, h: int, device=None):
    """Index sets for seeding fold h from fold g's solution.

    Previous train set = all \\ chunk[g]; new train set = all \\ chunk[h]:
    T (added) = chunk[g], R (removed) = chunk[h], S = the rest.
    """
    k = chunks.shape[0]
    S = np.concatenate([chunks[j] for j in range(k) if j not in (g, h)])
    return tuple(torch.as_tensor(a, device=device)
                 for a in (S, chunks[h], chunks[g]))


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cv(ds: SVMDataset, k: int = 10, method: str = "sir",
           tol: float = 1e-3, max_iter: int = 5_000_000, seed: int = 0,
           device=None) -> CVReport:
    """Run alpha-seeded k-fold CV with ``method`` in {cold, ato, mir, sir}:
    fold 0 starts cold, fold h>0 is seeded from fold h-1 (every fold is
    cold for ``"cold"``). Runs on ``cuda`` unless ``device="cpu"``."""
    seeder = seeding.SEEDERS[method]
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

    folds: list[FoldStat] = []
    prev = None
    for h in range(k):
        t0 = time.perf_counter()
        if h == 0 or method == "cold":
            seed_from = -1
            alpha0, f0 = torch.zeros(n, dtype=DTYPE, device=dev), -y
        else:
            seed_from = h - 1
            S_idx, R_idx, T_idx = _transition_idx(chunks, seed_from, h, dev)
            alpha0 = seeder(K, y, ds.C, prev, S_idx, R_idx, T_idx)
            f0 = init_f(K, y, alpha0)
        _sync(dev)
        t1 = time.perf_counter()
        res = smo_solve(K, y, masks[h], ds.C, alpha0, f0, tol=tol,
                        max_iter=max_iter)
        n_iter = int(res.n_iter)   # syncs
        t2 = time.perf_counter()
        correct, total, obj = _eval_fold(K, y, chunks, h, res, ds.C)
        folds.append(FoldStat(
            fold=h, seed_from=seed_from, n_iter=n_iter, init_time=t1 - t0,
            solve_time=t2 - t1, acc_correct=correct, acc_total=total,
            objective=obj, converged=bool(res.converged)))
        prev = res
    return CVReport(dataset=ds.name, method=method, k=k, n=n,
                    kernel_time=kernel_time, folds=folds)
