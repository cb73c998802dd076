"""Bucketed active-set shrinking for the SMO engine (LIBSVM heuristic).

Mirrors ``src/repro/svm/shrink.py``: ``DEFAULT_SHRINK_EVERY``,
``UNSHRINK_LIMIT``, ``bucket_cap``, ``pick_cap``, ``possible_caps``,
``active_set``, ``seed_active_mask``, ``_gap_of``, ``reconstruct_f``,
``LaneShrink``, ``seed_shrink``, ``advance`` and ``solve_shrunk``, with the
same contracts.

A seeded solve starts near optimal: most alphas sit at their bounds from
iteration zero, yet every iteration still pays a pass over all n rows.
Shrinking runs a lane on the rows that can still move, so an iteration
costs in proportion to the active set, the quantity seeding makes small.
It is a problem transformation at chunk granularity: the chunk programs
are untouched (``shrink_every=0`` is ``engine.solve`` verbatim), and a
shrunk lane runs the same chunks over a gathered compact subproblem.

* **heuristic** — at exact multiples of ``shrink_every`` iterations (the
  chunk's iteration cap stops there), a variable is shrunk when it is
  bound-locked against the current (b_up, b_low): in I_up only with f >
  b_low, or in I_low only with f < b_up. Free variables never shrink and
  the maximal violating pair stays, so the compact gap equals the full gap
  when the lane shrinks.
* **bucketed compaction** — the active rows are placed by a prefix sum (no
  host sync) into ``cap`` slots, ``cap`` the smallest ``shrink_quantum``
  multiple at or above the active count (or the smallest declared
  ``shrink_caps`` entry). The reference's pads point at row n, which its
  gathers clamp to the last row and its scatters drop; torch raises on an
  index of n, so the gathers here clamp the pads to n - 1 (the same
  values) and the scatters write only the rows that were placed.
* **reconstruction** — the compact chunks run at ``10 * tol``; when the
  active gap closes there, f is reconstructed over the full set as ``K @
  (alpha * y) - y`` (the source's K, or its streaming ``matvec``), the lane
  unshrinks and finishes on the full set at ``tol``, so the result keeps
  ``engine.solve``'s full-set contract. ``UNSHRINK_LIMIT`` cycles pin a
  lane to the full set for the endgame.
* **host reads** — the lifecycle reads the host only where the reference
  does: a chunk's done flag and iteration count at its end (one read), a
  gap and an active count at a boundary. Each is counted in
  ``HOST_SYNCS``; the gathers and scatters in between never sync.

The compact iterates are a pure function of the active values, so up to
the first reconstruction a lane is bitwise the reference's; the
reconstruction's product sums in another library's order, so later
iterates agree to the last bits of f (see ``tests/test_torch_shrink.py``).
The lane pool (``svm/scheduler.py``) drives this per lane through
``LaneShrink`` and ``advance``; ``solve_shrunk`` is the solo driver.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ref import _sets
from repro_torch.svm.engine import (EngineState, SMOResult, finalize,
                                    init_state, optimality, smo_chunk, solve)

#: heuristic cadence when shrinking is enabled without an explicit period
#: (``shrink_every="auto"`` resolves here when the cost model approves)
DEFAULT_SHRINK_EVERY = 1024

#: shrink/unshrink cycles per lane before the endgame pins to the full set
UNSHRINK_LIMIT = 4

#: the shrink lifecycle's host reads: a chunk's (done, n_iter) at its end,
#: a gap, an active count
HOST_SYNCS = {"chunk_end": 0, "gap": 0, "active": 0}

_INF = math.inf


def _read_gap(alpha, f, y, mask, C) -> float:
    HOST_SYNCS["gap"] += 1
    return float(_gap_of(alpha, f, y, mask, C))


def _read_count(active) -> int:
    HOST_SYNCS["active"] += 1
    return int(active.sum())


def _read_end(state: EngineState) -> tuple[bool, int]:
    """A chunk's done flag and iteration count, in one read."""
    HOST_SYNCS["chunk_end"] += 1
    done, n_it = torch.stack((state.done.to(torch.int64),
                              state.n_iter)).tolist()
    return bool(done), int(n_it)


# --------------------------------------------------------------- bucketing

def bucket_cap(m: int, quantum: int = 128) -> int:
    """Smallest ``quantum`` multiple >= ``m`` (>= one quantum): the compact
    buffer's capacity for an active count of ``m``."""
    q = max(int(quantum), 1)
    return -(-max(int(m), 1) // q) * q


def pick_cap(m: int, n: int, quantum: int = 128, caps=None) -> int | None:
    """Capacity bucket for ``m`` active of ``n`` rows, or None when
    compaction would not reduce the shape (bucket >= n, or no declared cap
    fits); with ``caps`` the smallest declared cap that fits."""
    m, n = int(m), int(n)
    if caps:
        fit = [int(c) for c in caps if m <= int(c) < n]
        return min(fit) if fit else None
    cap = bucket_cap(m, quantum)
    return cap if cap < n else None


def possible_caps(n: int, quantum: int = 128, caps=None) -> tuple[int, ...]:
    """Every compact capacity ``pick_cap`` can produce for ``n`` rows."""
    n = int(n)
    if caps:
        return tuple(sorted({int(c) for c in caps if 0 < int(c) < n}))
    q = max(int(quantum), 1)
    return tuple(range(q, n, q))


# --------------------------------------------------------------- heuristic

def active_set(alpha, f, y, train_mask, C):
    """(active, gap): the LIBSVM shrink heuristic against the current
    (b_up, b_low). A variable is bound-locked (inactive) in I_up only with
    f > b_low, or in I_low only with f < b_up; free variables and the
    maximal violating pair stay active; rows outside ``train_mask`` never
    are."""
    i_up, i_low = _sets(alpha, y, train_mask, C)
    has = i_up.any() & i_low.any()
    b_up = torch.where(i_up, f, _INF).min()
    b_low = torch.where(i_low, f, -_INF).max()
    gap = torch.where(has, b_low - b_up, -_INF)
    locked = (i_up & ~i_low & (f > b_low)) | (i_low & ~i_up & (f < b_up))
    return train_mask & ~locked, gap


def seed_active_mask(alpha0, f0, y, train_mask, C):
    """Initial active mask of a seeded lane (the seeding -> shrinking
    handoff): bound-locked seeded alphas start shrunk. Re-exported by
    ``core/seeding.py``; the pool applies it at admission when
    ``shrink_on_seed`` is set."""
    active, _ = active_set(alpha0, f0, y, train_mask, C)
    return active


def _gap_of(alpha, f, y, mask, C):
    return optimality(alpha, f, y, mask, C)[2]


# ----------------------------------------------------------- reconstruction

def reconstruct_f(source, y, alpha):
    """Full-set ``f = K @ (alpha * y) - y`` for unshrinking: the dense K
    where the source holds one, else its streaming ``matvec`` (O(block n)
    transient memory, never n^2)."""
    K = getattr(source, "K", None)
    if K is not None:
        return K @ (alpha * y) - y
    mv = getattr(source, "matvec", None)
    if callable(mv):
        return mv(alpha * y) - y
    raise ValueError("source has neither K nor matvec; cannot reconstruct "
                     "f to unshrink")


def _place(active, cap: int):
    """The rows where ``active`` holds, ascending, in ``cap`` slots, pads =
    n (the reference's ``jnp.nonzero(size=cap, fill_value=n)``), by a
    prefix sum and a scatter: no host sync."""
    n = active.shape[0]
    pos = torch.cumsum(active, 0) - 1
    slot = torch.where(active & (pos < cap), pos, cap)
    idx = torch.full((cap + 1,), n, dtype=torch.int64, device=active.device)
    idx.scatter_(0, slot, torch.arange(n, device=active.device))
    return idx[:cap]


# ------------------------------------------------------------- lane ledger

class LaneShrink:
    """Host-side shrink ledger for ONE lane: the active mask, the bucketed
    compact buffer (indices, operands, state) and the lifecycle flags. The
    full-shape ``EngineState`` mirror stays with the caller; ``advance``
    keeps it fresh by scattering the compact state back after every chunk
    (alpha and the active rows of f are current, inactive f is stale until
    reconstruction). ``n_iter`` mirrors the lane's iteration count on the
    host (read at each chunk's end), so the next chunk's cap costs no
    read."""

    def __init__(self, n: int, *, every: int, quantum: int = 128,
                 caps=None, unshrink_limit: int = UNSHRINK_LIMIT,
                 n_iter: int = 0):
        self.n = int(n)
        self.every = max(int(every), 1)
        self.quantum = int(quantum)
        self.caps = tuple(int(c) for c in caps) if caps else None
        self.unshrink_limit = int(unshrink_limit)
        self.n_iter = int(n_iter)
        self.active = None            # (n,) bool — None until first shrink
        self.cap = 0                  # compact capacity; 0 = unshrunk
        self.m = 0                    # live active count (<= cap)
        self.placed = 0               # rows idx holds (the rest are pads)
        self.idx = None               # (cap,) int64; pads = n
        self.cmask = None             # (cap,) bool validity mask
        self.cy = None                # (cap,) compact labels
        self.csrc = None              # compact kernel source
        self.cstate = None            # compact EngineState
        self.no_shrink = False        # endgame: full-set polish only
        self.unshrinks = 0

    @property
    def shrunk(self) -> bool:
        return self.cap > 0

    def it_cap(self, n_iter: int, max_iter: int) -> int:
        """Iteration cap for the next dispatch: the next heuristic boundary
        (a pure function of ``n_iter``, not of the chunk schedule)."""
        if self.no_shrink and not self.shrunk:
            return int(max_iter)
        boundary = (int(n_iter) // self.every + 1) * self.every
        return min(int(max_iter), boundary)

    def mark(self, active, m: int) -> bool:
        """Adopt an active mask from a full-set heuristic evaluation;
        returns True when a (re)compaction is now pending (the gather runs
        lazily at the next dispatch, in ``enter``)."""
        cap = pick_cap(m, self.n, self.quantum, self.caps)
        if cap is None:
            return False
        self.active = active.to(torch.bool)
        self.m = int(m)
        if self.shrunk and cap >= self.cap:
            return False
        self.cap = cap
        self.idx = self.csrc = self.cstate = None
        return True

    def enter(self, source, y, full: EngineState) -> None:
        """Gather the compact subproblem from the full-state mirror: the
        active rows in ``cap`` slots (pads gather the last row, inert under
        ``cmask``), operands through the source's ``compact``."""
        idx = _place(self.active, self.cap)
        self.idx = idx
        self.placed = self.m
        dev = full.alpha.device
        self.cmask = torch.arange(self.cap, device=dev) < self.m
        at = idx.clamp_max(self.n - 1)
        self.cy = y[at]
        self.csrc = source.compact(idx)
        self.cstate = EngineState(full.alpha[at], full.f[at], full.n_iter,
                                  torch.zeros((), dtype=torch.bool,
                                              device=dev))

    def scatter(self, full: EngineState) -> EngineState:
        """The full mirror with the compact state written back (the placed
        rows only: pads are dropped, valid indices unique)."""
        st, rows = self.cstate, self.idx[:self.placed]
        alpha, f = full.alpha.clone(), full.f.clone()
        alpha[rows] = st.alpha[:self.placed]
        f[rows] = st.f[:self.placed]
        return EngineState(alpha, f, st.n_iter, full.done)

    def tighten(self, active_c, m_new: int) -> None:
        """A boundary evaluation inside compact mode: the mask tightens in
        place (value-identical whether or not the buffer re-buckets), and
        the buffer re-gathers only when the bucket drops."""
        self.cmask = self.cmask & active_c
        self.m = int(m_new)
        active = torch.zeros(self.n, dtype=torch.bool,
                             device=self.cmask.device)
        active[self.idx[:self.placed]] = self.cmask[:self.placed]
        self.active = active
        cap = pick_cap(self.m, self.n, self.quantum, self.caps)
        if cap is not None and cap < self.cap:
            # the old compact operands go before the new ones are gathered
            self.cap = cap
            self.idx = self.csrc = self.cstate = None

    def unshrink(self) -> None:
        self.cap = 0
        self.m = self.placed = 0
        self.idx = self.cmask = self.cy = self.csrc = self.cstate = None
        self.active = None
        self.unshrinks += 1
        if self.unshrinks >= self.unshrink_limit:
            self.no_shrink = True


def seed_shrink(ls: LaneShrink, y, train_mask, C, state: EngineState, *,
                tol: float) -> None:
    """The admission handoff: evaluate the heuristic on the seeded (alpha0,
    f0). A lane already inside the ``10 * tol`` endgame never shrinks;
    otherwise bound-locked seeded alphas start shrunk."""
    gap = _read_gap(state.alpha, state.f, y, train_mask, float(C))
    if math.isnan(gap) or gap <= 10.0 * tol:
        ls.no_shrink = True
        return
    active, _ = active_set(state.alpha, state.f, y, train_mask, float(C))
    ls.mark(active, _read_count(active))


def advance(ls: LaneShrink, source, y, train_mask, C, full: EngineState, *,
            tol: float, max_iter: int):
    """Post-chunk lifecycle for one shrink-enabled lane. Returns
    ``(full_state, verdict)``, verdict ``"run"`` or ``"retire"`` (full-set
    converged, NaN-poisoned or iteration-capped: the state is
    reconstructed and finalizable).

    Shrunk lane, chunk done: the compact chunk ran at ``10 * tol``, so done
    means the active gap closed (reconstruct + unshrink), the budget ran
    out (reconstruct + retire), or the next boundary was hit (tighten the
    mask against the compact (b_up, b_low)). Unshrunk lane, chunk done:
    true convergence retires; a boundary evaluates the full-set mask and
    may enter compaction."""
    stol = 10.0 * tol
    C = float(C)
    if ls.shrunk:
        st = ls.cstate
        full = ls.scatter(full)
        done, n_it = _read_end(st)
        ls.n_iter = n_it
        if not done:
            return full, "run"
        gap_c = _read_gap(st.alpha, st.f, ls.cy, ls.cmask, C)
        if gap_c <= stol or math.isnan(gap_c) or n_it >= max_iter:
            # the active gap closed within 10*tol (or the budget ran out):
            # reconstruct f over the FULL set and unshrink
            f_full = reconstruct_f(source, y, full.alpha)
            full = EngineState(full.alpha, f_full, st.n_iter,
                               torch.zeros_like(st.done))
            ls.unshrink()
            gap = _read_gap(full.alpha, full.f, y, train_mask, C)
            if gap <= tol or math.isnan(gap) or n_it >= max_iter:
                return full._replace(done=torch.ones_like(st.done)), \
                    "retire"
            if gap <= stol:
                ls.no_shrink = True    # endgame: polish the full set
            return full, "run"
        # heuristic boundary inside compact mode
        act_c, _ = active_set(st.alpha, st.f, ls.cy, ls.cmask, C)
        ls.cstate = st._replace(done=torch.zeros_like(st.done))
        m_new = _read_count(act_c)
        if m_new < ls.m:
            ls.tighten(act_c, m_new)
        return full, "run"

    done, n_it = _read_end(full)
    ls.n_iter = n_it
    if not done:
        return full, "run"
    gap = _read_gap(full.alpha, full.f, y, train_mask, C)
    if gap <= tol or math.isnan(gap) or n_it >= max_iter:
        return full, "retire"
    full = full._replace(done=torch.zeros_like(full.done))
    if ls.no_shrink:
        return full, "run"
    if gap <= stol:
        ls.no_shrink = True            # already in the endgame
        return full, "run"
    active, _ = active_set(full.alpha, full.f, y, train_mask, C)
    ls.mark(active, _read_count(active))
    return full, "run"


# ------------------------------------------------------------- solo driver

def solve_shrunk(source, y, train_mask, C, alpha0, f0, *, tol: float = 1e-3,
                 max_iter: int = 10_000_000, wss: str = "2",
                 chunk_iters: int = 4096,
                 shrink_every: int = DEFAULT_SHRINK_EVERY,
                 shrink_quantum: int = 128, shrink_caps=None,
                 shrink_on_seed: bool = True,
                 n_iter0: int = 0) -> SMOResult:
    """``engine.solve`` with active-set shrinking: the driver the pool's
    shrink path is bitwise equal to. ``shrink_every=0`` is ``engine.solve``
    verbatim. The result keeps ``solve``'s full-set contract: f globally
    consistent (reconstructed at unshrink), ``converged`` judged on the
    full-set gap at ``tol``."""
    if not shrink_every:
        return solve(source, y, train_mask, C, alpha0, f0, tol=tol,
                     max_iter=max_iter, wss=wss, chunk_iters=chunk_iters,
                     n_iter0=n_iter0)
    state = init_state(source, y, train_mask, alpha0, f0, n_iter0=n_iter0)
    ls = LaneShrink(int(state.alpha.shape[0]), every=shrink_every,
                    quantum=shrink_quantum, caps=shrink_caps,
                    n_iter=n_iter0)
    if shrink_on_seed:
        seed_shrink(ls, y, train_mask, C, state, tol=tol)
    while True:
        if ls.cap and ls.idx is None:
            ls.enter(source, y, state)
        it = ls.it_cap(ls.n_iter, max_iter)
        if ls.shrunk:
            ls.cstate = smo_chunk(ls.csrc, ls.cy, ls.cmask, C, ls.cstate,
                                  n_iters=chunk_iters, wss=wss,
                                  tol=10.0 * tol, it_cap=it)
        else:
            state = smo_chunk(source, y, train_mask, C, state,
                              n_iters=chunk_iters, wss=wss, tol=tol,
                              it_cap=it)
        state, verdict = advance(ls, source, y, train_mask, C, state,
                                 tol=tol, max_iter=max_iter)
        if verdict == "retire":
            return finalize(state, y, train_mask, C, tol)
