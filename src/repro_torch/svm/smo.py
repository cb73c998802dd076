"""Dense LibSVM-parity SMO solver over the engine.

Mirrors ``src/repro/svm/smo.py``: ``init_f``, ``dual_objective``,
``smo_solve`` (a ``DenseKernel`` bound to ``engine.solve``) and
``smo_solve_batched`` (bound to ``engine.solve_batched``).
"""
from __future__ import annotations

from repro_torch.svm.engine import (DenseKernel, SMOResult, solve,
                                    solve_batched)


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


def smo_solve_batched(K, y, train_masks, Cs, alpha0s, f0s, tol: float = 1e-3,
                      max_iter: int = 10_000_000, wss: str = "2",
                      chunk_iters: int = 4096, n_iter0s=None) -> SMOResult:
    """Solve a batch of folds over one shared kernel matrix concurrently.

    ``train_masks``/``alpha0s``/``f0s`` carry a leading fold axis; ``Cs`` is
    a scalar or (b,) vector. Returns a fold-batched ``SMOResult``; each
    fold is bitwise its own ``smo_solve``. See ``engine.solve_batched``.
    """
    return solve_batched(DenseKernel(K), y, train_masks, Cs, alpha0s, f0s,
                         tol=tol, max_iter=max_iter, wss=wss,
                         chunk_iters=chunk_iters, n_iter0s=n_iter0s)
