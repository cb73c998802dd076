"""Dense LibSVM-parity SMO solver over the engine.

Mirrors ``src/repro/svm/smo.py``: ``init_f``, ``dual_objective`` and
``smo_solve`` (a ``DenseKernel`` bound to ``engine.solve``). The batched
wrapper is a later slice of the port.
"""
from __future__ import annotations

from repro_torch.svm.engine import DenseKernel, SMOResult, solve


def init_f(K, y, alpha):
    """f_i = sum_j alpha_j y_j K_ij - y_i, for all i (masked or not)."""
    return K @ (alpha * y) - y


def dual_objective(K, y, alpha):
    """Paper Problem (1): sum(alpha) - 0.5 aT Q a with Q_ij = y_i y_j K_ij."""
    v = alpha * y
    return alpha.sum() - 0.5 * (v @ (K @ v))


def smo_solve(K, y, train_mask, C: float, alpha0, f0, tol: float = 1e-3,
              max_iter: int = 10_000_000, wss: str = "2",
              chunk_iters: int | None = None, on_chunk=None,
              n_iter0: int = 0) -> SMOResult:
    """Solve the masked dual SVM with SMO, warm-started at (alpha0, f0).

    ``f0`` must equal ``init_f(K, y, alpha0)``; for a cold start
    ``alpha0 = 0`` gives ``f0 = -y``.
    """
    return solve(DenseKernel(K), y, train_mask, C, alpha0, f0, tol=tol,
                 max_iter=max_iter, wss=wss, chunk_iters=chunk_iters,
                 on_chunk=on_chunk, n_iter0=n_iter0)
