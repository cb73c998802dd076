"""The SMO engine: state types, kernel sources, optimality, and chunked
dispatch at one lane and over lanes.

Mirrors ``src/repro/svm/engine.py``: ``SMOResult``, ``EngineState`` (with
the lane helpers ``stack``/``lane``/``gather``/``scatter``),
``optimality``, the sources ``DenseKernel``, ``OnDemandRBF``, ``FusedRBF``
and ``PallasRBF``, ``smo_chunk``, ``chunk_batched`` (the reference's
``chunk_batched_jit``), ``stack_sources``, ``chunk_batched_sources`` (the
reference's ``chunk_batched_sources_jit``), ``init_state``, ``finalize``,
``solve`` and ``solve_batched``. The step itself (WSS-2 and WSS-1, dense
or streaming) is ``kernels/ref.py::smo_step_ref``, kept beside the chunk
kernels that run it on the card.

A chunk on a CUDA tensor runs on the card without a host sync inside it:
over a ``DenseKernel`` it is ONE launch of the dense chunk kernel (a block
per lane); over a row-streaming source (``PallasRBF``) it is ``n_iters``
pairs of launches, the WSS-1 selection and ``fused_smo_step``, issued by
one host call. The host reads ``done`` only between chunks, as the
reference's jitted ``lax.while_loop`` does. On a CPU tensor a chunk is the
plain per-step loop, lane by lane. ``OnDemandRBF`` and ``FusedRBF`` serve
kernel rows (``row``, ``rows2``, ``kij``, ``rows_at``, ``matvec``); solves
go through ``DenseKernel`` or ``PallasRBF``.

Shrinking (``svm/shrink.py``) runs a lane on the rows it keeps active:
``compact(idx)`` gathers a source of the same kind over those rows (pads,
which the reference points at row n, are clamped to the last row here, as
the reference's gathers clamp them), and ``matvec`` reconstructs f over
the full set. Lanes of one (source, cap) group each carry their own
compact operands: ``stack_sources`` stacks them and
``chunk_batched_sources`` runs them in ONE launch of the chunk kernels'
per-lane form (``smo_chunk_sources`` / ``smo_stream_chunk_sources``) on the
card, the plain step loop lane by lane on the CPU.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels.ops import (fused_smo_step, smo_chunk_lanes,
                                     smo_chunk_sources, smo_stream_chunk,
                                     smo_stream_chunk_sources)
from repro_torch.kernels.ops import smo_chunk as _smo_chunk_kernel
from repro_torch.kernels.ref import _sets, rbf_kij_ref
from repro_torch.kernels.smo_chunk import (pad_rows, seq_norms, stream_plan,
                                           stream_route)

_INF = math.inf
_INT32_MAX = 2 ** 31 - 1
#: entries of K a compaction gathers at once (a slab of rows: 128 MB)
GATHER_ELEMS = 1 << 24


class SMOResult(NamedTuple):
    alpha: torch.Tensor      # (n,) dual variables (0 outside train_mask)
    f: torch.Tensor          # (n,) optimality indicators, globally consistent
    n_iter: torch.Tensor     # () int64 — SMO iterations executed
    converged: torch.Tensor  # () bool
    b_up: torch.Tensor       # () min f over I_up at exit
    b_low: torch.Tensor      # () max f over I_low at exit


class EngineState(NamedTuple):
    """Resumable solver state — the unit chunks pass between themselves.
    A batched state carries a leading lane axis on every field; the lane
    pool ``stack``s single-lane states into a batch and ``lane``-extracts
    them back; ``gather``/``scatter`` compact a batch to a lane subset and
    write it back (new tensors, as the reference's functional updates)."""
    alpha: torch.Tensor
    f: torch.Tensor
    n_iter: torch.Tensor   # () int64 — updates applied so far
    done: torch.Tensor     # () bool — converged or iteration-capped

    @staticmethod
    def stack(states: "list[EngineState]") -> "EngineState":
        """Pack single-lane states into a batched state (axis 0 = lane)."""
        return EngineState(*(torch.stack(xs) for xs in zip(*states)))

    def lane(self, i) -> "EngineState":
        """Lane ``i`` of a batched state as a single-lane state."""
        return EngineState(*(t[i] for t in self))

    def gather(self, idx) -> "EngineState":
        """The lanes in ``idx`` of a batched state (repacking)."""
        idx = torch.as_tensor(idx, device=self.alpha.device)
        return EngineState(*(t[idx] for t in self))

    def scatter(self, idx, sub: "EngineState") -> "EngineState":
        """A copy of this batch with the lanes of ``sub`` at ``idx``."""
        idx = torch.as_tensor(idx, device=self.alpha.device)
        out = [t.clone() for t in self]
        for t, s in zip(out, sub):
            t[idx] = s
        return EngineState(*out)


def optimality(alpha, f, y, train_mask, C):
    """(b_up, b_low, gap) of a state; gap = -inf when a working pair cannot
    be formed (empty I_up or I_low)."""
    i_up, i_low = _sets(alpha, y, train_mask, C)
    has = i_up.any() & i_low.any()
    b_up = torch.where(i_up, f, _INF).min()
    b_low = torch.where(i_low, f, -_INF).max()
    gap = torch.where(has, b_low - b_up, -_INF)
    return b_up, b_low, gap


# --------------------------------------------------------------------------
# kernel sources
# --------------------------------------------------------------------------

class DenseKernel:
    """Precomputed kernel matrix — the LibSVM-parity source."""

    fused = False
    streams_rows = False

    def __init__(self, K):
        self.K = K

    @property
    def dtype(self):
        return self.K.dtype

    @property
    def device(self):
        return self.K.device

    @property
    def nbytes(self) -> int:
        """Bytes held resident (what the source cache budgets)."""
        return self.K.numel() * self.K.element_size()

    def diag(self):
        return torch.diagonal(self.K).contiguous()

    def row(self, i):
        return self.K[i]

    def rows_at(self, idx):
        """Kernel row slab K[idx, :]."""
        return self.K[torch.as_tensor(idx, device=self.K.device)]

    def matvec(self, v):
        """``K @ v`` — the unshrink reconstruction path (``shrink.py``)."""
        return self.K @ v

    def compact(self, idx) -> "DenseKernel":
        """The kernel restricted to rows and columns ``idx`` (the active
        set); pads past the last row clamp to it, inert under the compact
        validity mask. Gathered in slabs of rows (``GATHER_ELEMS`` entries
        of K at a time) straight into the (cap, cap) result: neither
        ``K[idx][:, idx]``'s (cap, n) intermediate (7.5 GB at cap 29,000 of
        adult's n = 32,560) nor the (cap, cap) int64 index pair that
        torch's broadcast 2-D index ``K[idx[:, None], idx[None, :]]``
        builds."""
        K = self.K
        idx = _clamped(idx, K.shape[0], K.device)
        cap = idx.shape[0]
        out = torch.empty((cap, cap), dtype=K.dtype, device=K.device)
        step = max(1, GATHER_ELEMS // K.shape[1])
        for r in range(0, cap, step):
            torch.index_select(K.index_select(0, idx[r:r + step]), 1, idx,
                               out=out[r:r + step])
        return DenseKernel(out)

    def to(self, device) -> "DenseKernel":
        return DenseKernel(torch.as_tensor(self.K, device=device))


class OnDemandRBF:
    """RBF kernel rows recomputed from X (K_ii = 1); holds X and its row
    norms only. ``rows_at`` and ``matvec`` stream row slabs, O(t n) or
    O(block n) transient memory, never n^2 resident."""

    fused = False
    streams_rows = False

    def __init__(self, X, gamma: float, sq_norms=None):
        self.X = X
        self.gamma = float(gamma)
        self.sq_norms = torch.sum(X * X, -1) if sq_norms is None \
            else sq_norms

    @property
    def dtype(self):
        return self.X.dtype

    @property
    def device(self):
        return self.X.device

    @property
    def nbytes(self) -> int:
        """Resident bytes are X's, not n^2 kernel bytes."""
        return self.X.numel() * self.X.element_size()

    def diag(self):
        return torch.ones(self.X.shape[0], dtype=self.X.dtype,
                          device=self.X.device)

    def row(self, i):
        xi = self.X[i]
        d2 = torch.clamp_min(self.sq_norms + torch.sum(xi * xi)
                             - 2.0 * (self.X @ xi), 0.0)
        return torch.exp(-self.gamma * d2)

    def rows2(self, i, j):
        """Both kernel rows in one pass over X."""
        xij = self.X[[int(i), int(j)]]
        d2 = torch.clamp_min(self.sq_norms[:, None]
                             + torch.sum(xij * xij, 1)[None]
                             - 2.0 * (self.X @ xij.T), 0.0)
        K2 = torch.exp(-self.gamma * d2)
        return K2[:, 0], K2[:, 1]

    def kij(self, i, j):
        """K[i, j] by the ``rows2`` expression at row j (the reference's
        interpret-mode ``kij``; the card's selection kernel computes the
        same expression)."""
        return rbf_kij_ref(self.X, self.sq_norms, self.gamma, i, j)

    def _slab(self, Xb, sqb):
        """exp(-gamma * max(|xb|^2 + |x|^2 - 2 xb.x, 0)) for the rows Xb,
        rounded as the reference's expression, with one (t, n) temporary
        besides the result."""
        t = sqb[:, None] + self.sq_norms[None]
        t.sub_((Xb @ self.X.T).mul_(2.0))
        return t.clamp_min_(0.0).mul_(-self.gamma).exp_()

    def rows_at(self, idx):
        """Kernel row slab K[idx, :] -> (t, n): the evaluation path for
        K-less sources."""
        Xi = self.X[torch.as_tensor(idx, device=self.X.device)]
        return self._slab(Xi, torch.sum(Xi * Xi, -1))

    def matvec(self, v, *, block: int = 2048):
        """Streaming ``K @ v``: row blocks of K formed and reduced at once,
        O(block n) transient memory."""
        n = self.X.shape[0]
        return torch.cat([
            self._slab(self.X[s:s + block], self.sq_norms[s:s + block]) @ v
            for s in range(0, n, block)])

    def compact(self, idx):
        """The same source kind over ``X[idx]`` (the active set: a compact
        row-streaming source streams only the active rows); pads past the
        last row clamp to it, inert under the compact validity mask."""
        idx = _clamped(idx, self.X.shape[0], self.X.device)
        return type(self)(self.X[idx], self.gamma, self.sq_norms[idx])

    def to(self, device):
        return type(self)(torch.as_tensor(self.X, device=device), self.gamma,
                          torch.as_tensor(self.sq_norms, device=device))


class FusedRBF(OnDemandRBF):
    """One-pass two-row RBF evaluation; forces WSS-1 pair selection (the
    second index must come from f alone so both rows stream together)."""

    fused = True


class PallasRBF(FusedRBF):
    """Row-streaming RBF source over the fused step kernel: each SMO
    iteration is one pass over X that computes the WSS-1 pair's kernel rows
    and applies ``f += delta * (K_i - K_j)`` in the same launch
    (``kernels/smo_step.py``); the rows never reach memory. ``streams_rows``
    routes the engine's update through ``update_f(f, i, j, delta)`` and
    ``kij(i, j)``; selection must be WSS-1 (``fused``)."""

    streams_rows = True

    @functools.cached_property
    def X_rows(self):
        """X as the persistent streaming chunk reads it (``pad_rows``),
        made once for every chunk over this source."""
        return pad_rows(self.X)

    @functools.cached_property
    def seq_norms(self):
        """|x|^2 summed in order of k (``seq_norms``), the table the
        streaming chunk's kernels read, made once for every chunk."""
        return seq_norms(self.X)

    def update_f(self, f, i, j, delta):
        return fused_smo_step(f, self.X, self.X[[int(i), int(j)]],
                              self.sq_norms, delta, self.gamma)

    def compact(self, idx) -> "PallasRBF":
        """``OnDemandRBF.compact`` with the streaming chunk's tables: the
        ordered-norm table gathered (it is row by row, so the gather is
        bitwise the table of the compact X) and ``pad_rows`` of the
        compact X built once for its chunks."""
        out = super().compact(idx)
        idx = _clamped(idx, self.X.shape[0], self.X.device)
        out.__dict__["seq_norms"] = self.seq_norms[idx]
        out.__dict__["X_rows"] = pad_rows(out.X)
        return out


def _clamped(idx, n: int, device):
    """Compaction indices on ``device``, pads past the last row clamped to
    it (the reference's gathers clamp its pads, index n, the same way)."""
    return torch.as_tensor(idx, device=device).clamp_max(n - 1)


def stack_lanes(ts, width: int):
    """``ts`` stacked along a new leading axis of ``width`` slots; the
    slots past them zeroed."""
    out = ts[0].new_empty((width, *ts[0].shape))
    torch.stack(ts, out=out[:len(ts)])
    out[len(ts):].zero_()
    return out


def stack_sources(sources, width: int | None = None):
    """Stack same-kind compact sources of the same shape along a new
    leading lane axis of ``width`` slots (``chunk_batched_sources``'
    operand; one a source by default): a ``DenseKernel`` over K (width,
    cap, cap), or a ``PallasRBF`` over X (width, cap, d) with its norms and
    ordered norms stacked (one gamma). Slots past the sources hold zeros:
    they are pad lanes', which are done and never read. X is laid out as
    the route that will read it wants it, in one copy: where the
    persistent route places the lanes, X is a view of its padded rows
    (``X_rows``); else contiguous, for the pair route, with no padded
    rows."""
    first = sources[0]
    width = len(sources) if width is None else int(width)
    if isinstance(first, DenseKernel):
        return DenseKernel(stack_lanes([s.K for s in sources], width))
    if not isinstance(first, PallasRBF) \
            or any(s.gamma != first.gamma for s in sources):
        raise ValueError("stack_sources: DenseKernel, or PallasRBF of one "
                         "gamma")
    cap, d = first.X.shape
    persistent = first.X.device.type == "cuda" and stream_route(
        cap, d, 1, stream_plan(cap, d, 1, width)[0], None) == "persistent"
    if persistent:
        rows = first.X.new_zeros((width, cap, d + d % 2))
        for i, s in enumerate(sources):
            rows[i, :, :d].copy_(s.X)
        X = rows[..., :d]
    else:
        X = stack_lanes([s.X for s in sources], width)
    out = PallasRBF(X, first.gamma,
                    stack_lanes([s.sq_norms for s in sources], width))
    out.__dict__["seq_norms"] = stack_lanes([s.seq_norms for s in sources],
                                            width)
    if persistent:
        out.__dict__["X_rows"] = X
    return out


# --------------------------------------------------------------------------
# chunks
# --------------------------------------------------------------------------

def _check_source(source, wss: str) -> None:
    if getattr(source, "fused", False) and wss == "2":
        raise ValueError("fused kernel sources evaluate both rows in one "
                         "pass and require WSS-1 (wss='1')")
    if not (isinstance(source, DenseKernel) or source.streams_rows):
        raise ValueError(f"{type(source).__name__} serves kernel rows only: "
                         "solve through DenseKernel or PallasRBF")


def chunk_batched(source, y, train_masks, Cs, tol, it_caps,
                  states: EngineState, n_iters: int,
                  wss: str) -> EngineState:
    """One chunk over a batch of lanes sharing ``source`` and ``y``:
    per-lane ``train_masks`` (b, n), ``Cs`` (b,) and ``it_caps`` (b,) (a
    scalar broadcasts). A done lane passes through unchanged, so each lane
    is bitwise the same whatever it is packed with."""
    _check_source(source, wss)
    b = train_masks.shape[0]
    Cs = torch.as_tensor(Cs, dtype=torch.float64).reshape(-1).expand(b)
    it_caps = torch.as_tensor(it_caps, dtype=torch.int64).reshape(-1) \
        .expand(b)
    if source.streams_rows:
        out = smo_stream_chunk(source.X, source.sq_norms, source.gamma, y,
                               train_masks, Cs, float(tol), it_caps,
                               int(n_iters), *states,
                               X_rows=getattr(source, "X_rows", None),
                               X_norms=source.seq_norms)
    else:
        out = smo_chunk_lanes(source.K, source.diag(), y, train_masks, Cs,
                              float(tol), it_caps, int(n_iters), wss,
                              *states)
    return EngineState(*out)


def chunk_batched_sources(sources, ys, train_masks, Cs, tol, it_caps,
                          states: EngineState, n_iters: int,
                          wss: str) -> EngineState:
    """One chunk over a batch of lanes that each carry their OWN kernel
    operands: ``sources`` is a stacked source (``stack_sources``, leading
    axis = lane), ``ys`` (b, cap); masks, Cs, caps and states as for
    ``chunk_batched``. On a CUDA tensor one launch of the per-lane chunk
    kernel; on a CPU tensor the plain step loop lane by lane. Each lane is
    bitwise its own ``smo_chunk`` over its own source."""
    _check_source(sources, wss)
    b = train_masks.shape[0]
    Cs = torch.as_tensor(Cs, dtype=torch.float64).reshape(-1).expand(b)
    it_caps = torch.as_tensor(it_caps, dtype=torch.int64).reshape(-1) \
        .expand(b)
    if sources.streams_rows:
        out = smo_stream_chunk_sources(
            sources.X, sources.sq_norms, sources.gamma, ys, train_masks, Cs,
            float(tol), it_caps, int(n_iters), *states,
            # the padded rows where ``stack_sources`` made them (the
            # persistent route's), else none: the pair route reads X
            X_rows=sources.__dict__.get("X_rows"),
            X_norms=sources.seq_norms)
    else:
        K = sources.K
        out = smo_chunk_sources(K, torch.diagonal(K, dim1=1, dim2=2), ys,
                                train_masks, Cs, float(tol), it_caps,
                                int(n_iters), wss, *states)
    return EngineState(*out)


def smo_chunk(source, y, train_mask, C, state: EngineState, *,
              n_iters: int, wss: str = "2", tol: float = 1e-3,
              it_cap: int | None = None) -> EngineState:
    """Run up to ``n_iters`` SMO iterations from ``state``; chunk N+1
    continues chunk N's iterate sequence bit-exactly. ``it_cap`` bounds the
    total ``n_iter`` across chunks."""
    _check_source(source, wss)
    if it_cap is None:
        it_cap = _INT32_MAX
    if source.streams_rows:
        return chunk_batched(source, y, train_mask[None], [float(C)], tol,
                             [int(it_cap)], EngineState.stack([state]),
                             n_iters, wss).lane(0)
    out = _smo_chunk_kernel(source.K, source.diag(), y, train_mask, float(C),
                            float(tol), int(it_cap), int(n_iters), wss,
                            *state)
    return EngineState(*out)


# --------------------------------------------------------------------------
# drivers: single solve / batched solve
# --------------------------------------------------------------------------

def init_state(source, y, train_mask, alpha0, f0, n_iter0=0) -> EngineState:
    """Zero alphas outside the training mask, cast to the source dtype,
    reset the done flag."""
    alpha0 = torch.where(train_mask, alpha0, 0.0).to(source.dtype)
    dev = source.device
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


def solve_batched(source, y, train_masks, Cs, alpha0s, f0s, *,
                  tol: float = 1e-3, max_iter: int = 10_000_000,
                  wss: str = "2", chunk_iters: int = 4096,
                  on_chunk=None, n_iter0s=None) -> SMOResult:
    """Solve a batch of folds concurrently over one shared kernel source.

    ``train_masks`` (b, n), ``Cs`` () or (b,), ``alpha0s``/``f0s`` (b, n).
    Each chunk advances every unconverged lane up to ``chunk_iters``
    iterations; converged lanes freeze, so each lane ends bitwise where its
    own ``solve`` would. Returns a batched ``SMOResult`` (leading axis =
    lane). ``n_iter0s`` (() or (b,)) pre-loads per-lane iteration counters;
    ``max_iter`` caps the total including the preload.
    """
    _check_source(source, wss)
    b, n = train_masks.shape
    dev = source.device
    Cs = torch.as_tensor(Cs, dtype=torch.float64).expand(b).tolist()
    alpha0s = torch.where(train_masks, alpha0s, 0.0).to(source.dtype)
    n_iter0s = torch.as_tensor(0 if n_iter0s is None else n_iter0s,
                               dtype=torch.int64).expand(b).to(dev)
    states = EngineState(alpha0s, f0s.to(source.dtype), n_iter0s,
                         torch.zeros(b, dtype=torch.bool, device=dev))
    while True:
        states = chunk_batched(source, y, train_masks, Cs, tol, max_iter,
                               states, chunk_iters, wss)
        if bool(states.done.all()):
            break
        if on_chunk is not None:
            on_chunk(states)
    opt = [optimality(states.alpha[l], states.f[l], y, train_masks[l], Cs[l])
           for l in range(b)]
    b_up, b_low, gap = (torch.stack(t) for t in zip(*opt))
    return SMOResult(alpha=states.alpha, f=states.f, n_iter=states.n_iter,
                     converged=gap <= tol, b_up=b_up, b_low=b_low)
