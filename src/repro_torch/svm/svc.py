"""Bias, decision function and accuracy helpers.

Mirrors the helpers of ``src/repro/svm/svc.py``. The ``SVC`` facade runs
through the Study API, which is a later slice of the port.
"""
from __future__ import annotations

import torch

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
