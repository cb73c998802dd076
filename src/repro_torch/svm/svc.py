"""Classifier-facing API: the ``SVC`` estimator facade, and the bias,
decision-function and accuracy helpers it is built from.

Mirrors ``src/repro/svm/svc.py``. ``SVC`` fits through the Study API (a
one-lane ``Plan`` through ``run_plan``) and cross-validates through
``run_cv``. The reference's ``kernel_backend`` is ``device`` here: the
port's ``kernel_matrix`` has no backend, the tensor's device decides
(None means ``cuda``; ``"cpu"`` runs the plain PyTorch path).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DTYPE, resolve_device
from repro_torch.svm.engine import SMOResult


def bias_from_solution(res: SMOResult, y, train_mask, C: float):
    """b such that decision(x) = sum_i alpha_i y_i K(x_i, x) + b.

    KKT: for 0 < alpha_i < C, f_i = -b, so b = -mean(f | I_m); if the free
    set is empty fall back to -(b_up + b_low)/2 (LibSVM rule).
    """
    free = train_mask & (res.alpha > 0) & (res.alpha < C)
    n_free = free.sum()
    mean_f = torch.where(free, res.f, 0.0).sum() / torch.clamp_min(n_free, 1)
    fallback = (res.b_up + res.b_low) / 2.0
    return -torch.where(n_free > 0, mean_f, fallback)


def decision_function(K_test_train, y_train, alpha, b):
    return K_test_train @ (alpha * y_train) + b


def predict(K_test_train, y_train, alpha, b):
    return torch.where(decision_function(K_test_train, y_train, alpha, b)
                       >= 0, 1, -1)


def accuracy(pred, y_true):
    return (pred == y_true).to(torch.float64).mean()


class SVC:
    """Small estimator facade over the Study API (scikit-learn-flavoured).

    ``fit`` declares the training solve as a one-lane plan and runs it
    through ``repro_torch.core.study.run_plan`` (the engine, pool and
    evaluation machinery of the CV and grid drivers), then stores the dual
    solution (``result_``), the bias (``b_``), ``n_iter_``, ``converged_``
    and ``classes_``. ``cross_validate`` forwards to ``run_cv`` on the
    estimator's hyper-parameters. Labels may be any two values; they map to
    {-1, +1} by sorted order and back in ``predict``. ``gamma="scale"`` is
    1 / (d Var[X]) with the population variance. ``device`` places the
    kernels and the solve (None: ``cuda``)."""

    def __init__(self, C: float = 1.0, gamma: float | str = "scale",
                 kind: str = "rbf", tol: float = 1e-3,
                 max_iter: int = 10_000_000, device=None,
                 shrink_every: int | str = 0, shrink_quantum: int = 128):
        self.C = float(C)
        self.gamma = gamma
        self.kind = kind
        self.tol = float(tol)
        self.max_iter = int(max_iter)
        self.device = device
        # active-set shrinking (svm/shrink.py): 0 = off, "auto" = the cost
        # model's verdict for the device
        self.shrink_every = shrink_every
        self.shrink_quantum = int(shrink_quantum)

    def _resolve_gamma(self, X) -> float:
        if self.gamma == "scale":   # sklearn convention: 1 / (d * Var[X])
            var = float(torch.var(X, correction=0))
            return float(1.0 / (X.shape[1] * max(var, 1e-12)))
        return float(self.gamma)

    def _encode(self, y) -> np.ndarray:
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if self.classes_.shape[0] != 2:
            raise ValueError(f"SVC is binary; got classes {self.classes_}")
        return np.where(y == self.classes_[1], 1.0, -1.0)

    def fit(self, X, y) -> "SVC":
        from repro_torch.core.study import Plan, run_plan
        from repro_torch.svm.engine import DenseKernel
        from repro_torch.svm.kernels import kernel_matrix

        dev = resolve_device(self.device)
        X = torch.as_tensor(X, dtype=DTYPE, device=dev)
        y_pm = torch.as_tensor(self._encode(y), dtype=DTYPE, device=dev)
        n = X.shape[0]
        self.gamma_ = self._resolve_gamma(X)
        K = kernel_matrix(X, X, kind=self.kind, gamma=self.gamma_)
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        plan = Plan(sources={"fit": DenseKernel(K)}, y=y_pm, tol=self.tol,
                    shrink_every=self.shrink_every,
                    shrink_quantum=self.shrink_quantum, device=dev)
        plan.lane("fit", train_mask=ones, C=self.C,
                  alpha0=torch.zeros(n, dtype=K.dtype, device=dev),
                  f0=-y_pm, max_iter=self.max_iter)
        res = run_plan(plan).results["fit"]
        self.X_ = X
        self.y_ = y_pm
        self.result_ = res
        self.b_ = bias_from_solution(res, y_pm, ones, self.C)
        self.n_iter_ = int(res.n_iter)
        self.converged_ = bool(res.converged)
        return self

    def decision_function(self, X):
        from repro_torch.svm.kernels import kernel_matrix
        Kt = kernel_matrix(torch.as_tensor(X, dtype=DTYPE,
                                           device=self.X_.device),
                           self.X_, kind=self.kind, gamma=self.gamma_)
        return decision_function(Kt, self.y_, self.result_.alpha, self.b_)

    def predict(self, X) -> np.ndarray:
        pm = self.decision_function(X).cpu().numpy() >= 0
        return np.where(pm, self.classes_[1], self.classes_[0])

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))

    def cross_validate(self, X, y, k: int = 10, method: str = "sir", **kw):
        """Alpha-seeded k-fold CV of this estimator's hyper-parameters on
        (X, y): builds the dataset record and forwards to ``run_cv`` (its
        knobs pass through ``**kw``). Returns the ``CVReport``."""
        from repro_torch.core.cv import run_cv
        from repro_torch.data.svm_suite import SVMDataset

        if self.kind != "rbf":
            # run_cv computes an RBF kernel; cross-validating another kernel
            # than fit() trains would score the wrong model
            raise ValueError(
                f"cross_validate supports kind='rbf' only (estimator has "
                f"kind={self.kind!r}); run_cv's kernel is RBF")
        X = np.asarray(X, np.float64)
        y_pm = np.asarray(self._encode(y), np.int64)
        ds = SVMDataset(name="svc", X=X, y=y_pm, C=self.C,
                        gamma=self._resolve_gamma(torch.as_tensor(X)))
        kw.setdefault("device", self.device)
        kw.setdefault("shrink_every", self.shrink_every)
        kw.setdefault("shrink_quantum", self.shrink_quantum)
        return run_cv(ds, k=k, method=method, tol=self.tol,
                      max_iter=self.max_iter, **kw)
