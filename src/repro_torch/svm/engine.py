"""The dense SMO engine: state types, optimality, and chunked dispatch.

Mirrors the dense core of ``src/repro/svm/engine.py``: ``SMOResult``,
``EngineState``, ``optimality``, ``DenseKernel``, ``smo_chunk``,
``init_state``, ``finalize`` and ``solve`` (with ``chunk_iters``,
``on_chunk`` and ``n_iter0``). The step itself (WSS-2 and WSS-1, with
``_sets`` and the NaN-guarded first-index ``_argmin``/``_argmax``) is
``kernels/ref.py::smo_step_ref``, kept beside the chunk kernel that runs
it on the card.

A chunk on a CUDA tensor is ONE launch of the device-resident chunk kernel
(``kernels/smo_chunk.py``): the host reads ``done`` only between chunks, as
the reference's jitted ``lax.while_loop`` does. On a CPU tensor it is the
plain per-step loop. The row-streaming sources, the batched lanes and
shrinking are later slices of the port.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.ops import smo_chunk as _smo_chunk_kernel
from repro_torch.kernels.ref import _sets

_INF = math.inf


class SMOResult(NamedTuple):
    alpha: torch.Tensor      # (n,) dual variables (0 outside train_mask)
    f: torch.Tensor          # (n,) optimality indicators, globally consistent
    n_iter: torch.Tensor     # () int64 — SMO iterations executed
    converged: torch.Tensor  # () bool
    b_up: torch.Tensor       # () min f over I_up at exit
    b_low: torch.Tensor      # () max f over I_low at exit


class EngineState(NamedTuple):
    """Resumable solver state — the unit chunks pass between themselves."""
    alpha: torch.Tensor
    f: torch.Tensor
    n_iter: torch.Tensor   # () int64 — updates applied so far
    done: torch.Tensor     # () bool — converged or iteration-capped


def optimality(alpha, f, y, train_mask, C):
    """(b_up, b_low, gap) of a state; gap = -inf when a working pair cannot
    be formed (empty I_up or I_low)."""
    i_up, i_low = _sets(alpha, y, train_mask, C)
    has = i_up.any() & i_low.any()
    b_up = torch.where(i_up, f, _INF).min()
    b_low = torch.where(i_low, f, -_INF).max()
    gap = torch.where(has, b_low - b_up, -_INF)
    return b_up, b_low, gap


class DenseKernel:
    """Precomputed kernel matrix — the LibSVM-parity source."""

    def __init__(self, K):
        self.K = K

    @property
    def dtype(self):
        return self.K.dtype

    def diag(self):
        return torch.diagonal(self.K).contiguous()


def smo_chunk(source, y, train_mask, C, state: EngineState, *,
              n_iters: int, wss: str = "2", tol: float = 1e-3,
              it_cap: int | None = None) -> EngineState:
    """Run up to ``n_iters`` SMO iterations from ``state``; chunk N+1
    continues chunk N's iterate sequence bit-exactly. ``it_cap`` bounds the
    total ``n_iter`` across chunks."""
    if it_cap is None:
        it_cap = torch.iinfo(torch.int32).max
    out = _smo_chunk_kernel(source.K, source.diag(), y, train_mask, float(C),
                            float(tol), int(it_cap), int(n_iters), wss,
                            *state)
    return EngineState(*out)


def init_state(source, y, train_mask, alpha0, f0, n_iter0=0) -> EngineState:
    """Zero alphas outside the training mask, cast to the source dtype,
    reset the done flag."""
    alpha0 = torch.where(train_mask, alpha0, 0.0).to(source.dtype)
    dev = source.K.device
    return EngineState(alpha0, f0.to(source.dtype),
                       torch.tensor(int(n_iter0), dtype=torch.int64,
                                    device=dev),
                       torch.zeros((), dtype=torch.bool, device=dev))


def finalize(state: EngineState, y, train_mask, C, tol) -> SMOResult:
    """Close an ``EngineState`` into an ``SMOResult``; optimality is a pure
    function of (alpha, f)."""
    b_up, b_low, gap = optimality(state.alpha, state.f, y, train_mask, C)
    return SMOResult(alpha=state.alpha, f=state.f, n_iter=state.n_iter,
                     converged=gap <= tol, b_up=b_up, b_low=b_low)


def solve(source, y, train_mask, C, alpha0, f0, *, tol: float = 1e-3,
          max_iter: int = 10_000_000, wss: str = "2",
          chunk_iters: int | None = None, on_chunk=None,
          n_iter0: int = 0) -> SMOResult:
    """Solve the masked dual SVM to convergence over a kernel source.

    ``chunk_iters=None`` dispatches one chunk sized ``max_iter``. With
    ``chunk_iters=m`` the host inspects ``done`` every m iterations and
    calls ``on_chunk(state)`` between chunks. ``n_iter0`` pre-loads the
    iteration counter of a resumed partial solve; ``max_iter`` caps the
    total, so a resumed solve stops where the uninterrupted one would.
    """
    state = init_state(source, y, train_mask, alpha0, f0, n_iter0=n_iter0)
    n = chunk_iters if chunk_iters is not None else max_iter
    while True:
        state = smo_chunk(source, y, train_mask, C, state, n_iters=n,
                          wss=wss, tol=tol, it_cap=max_iter)
        if chunk_iters is None or bool(state.done):
            break
        if on_chunk is not None:
            on_chunk(state)
    return finalize(state, y, train_mask, C, tol)
