"""Alpha-seeding algorithms (the paper's contribution).

Mirrors ``src/repro/core/seeding.py``: ``water_fill``, ``_box``,
``repair_equality``, ``_bias``, ``scale_seed_C``, ``cold_seed``,
``mir_seed``, ``sir_seed``, ``ato_seed_ref`` (the host-side pinv loop,
the oracle), ``ato_seed`` and ``ato_seed_batch`` over ``_ato_ramp`` (one
lane, or a row of lanes), the LOO seeders ``avg_seed_loo`` and
``top_seed_loo``, ``SEEDERS``, and the named seed transforms
``TRANSFORMS`` (``fold``, ``scale_C``, ``loo_avg``, ``loo_top``) with
``register_transform``, and the re-export of shrinking's
``seed_active_mask``.

All seeders share one contract::

    alpha0 = seeder(K, y, C, prev, S_idx, R_idx, T_idx)

where ``prev`` is fold h's ``SMOResult`` (its ``f`` is consistent with its
``alpha`` for ALL instances) and the index tensors partition the instances
for the transition h -> h+1: ``S_idx`` shared, ``R_idx`` removed (fold h+1's
test chunk), ``T_idx`` added (fold h's test chunk). Every seed keeps the box
``0 <= alpha <= C`` and ``sum(y * alpha) = 0`` over S + T.

Where the reference's arithmetic is not reproducible bit for bit:

* ``mir_seed``: ``jnp.linalg.lstsq`` is an SVD pseudo-inverse with cutoff
  ``eps * max(M, N) * s[0]``; the port takes the same SVD path (never
  ``gels``, which assumes full rank and is the only CUDA driver of
  ``torch.linalg.lstsq``). The SVD itself differs in the last bits.
* ``sir_seed``'s random fallback draws the reference's priorities bit for
  bit (``jax.random.uniform(PRNGKey(seed))``, reproduced in numpy by
  ``core/threefry.py``), so it is not among these.
* ``ato_seed``: ``torch.linalg.solve_ex`` of the bordered KKT system, an
  LU like the reference's, in another library; ``ato_seed_batch`` solves
  its lanes' systems as one batched LU, which may round otherwise again,
  and ``ato_seed_ref`` takes ``torch.linalg.pinv`` (an SVD, with
  ``jnp.linalg.pinv``'s cutoff).
* ``avg_seed_loo``: the spill's sums run in another order.

The reference runs its seeding loops as jitted device loops; so does the
port. On the card ``water_fill``, SIR's greedy pass, the two halves of
ATO's ramp step (over a row of lanes; one lane for ``ato_seed``) and the
LOO seeders' spills are kernels (``kernels/seeding.py``, one launch each;
on the CPU their plain versions), and ATO's ramp is enqueued in chunks of steps with its
stop flag on the device. A seed makes at most these host syncs, each
counted in ``HOST_SYNCS`` and let through a
``torch.cuda.set_sync_debug_mode("error")``: ATO's ``m_cap`` (once; once
for a whole row of lanes), its stop flag (once a chunk), and MIR's SVD
(its error check, once). ``ato_seed_ref`` is the oracle and reads the
host every step, as the reference's does.
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch

from repro_torch.core.threefry import uniform
from repro_torch.kernels.ops import (ato_apply_lanes, ato_system_lanes,
                                     avg_spill_loo, sir_greedy,
                                     top_spill_loo, water_fill)
from repro_torch.kernels.ref import AtoCarry, AtoSystem
from repro_torch.kernels.seeding import ato_system_buffers
from repro_torch.svm.engine import SMOResult

#: the seeders' host syncs since the last reset, by the read that made it
HOST_SYNCS = {"ato_m_cap": 0, "ato_flag": 0, "mir_svd": 0}
#: the most ramp steps enqueued between two reads of ATO's stop flag: the
#: chunks double from 1 up to it (a ramp often stops after a step or two,
#: and every step enqueued past the flag still pays its LU)
ATO_CHUNK = 8


@contextlib.contextmanager
def _host_read(what: str, like):
    """One of the seeders' counted host syncs (``HOST_SYNCS``). On the card
    it lifts ``torch.cuda.set_sync_debug_mode`` for its span, so a caller
    that sets ``"error"`` sees every other sync raise."""
    HOST_SYNCS[what] += 1
    if like.device.type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


# --------------------------------------------------------------------------
# constraint repair
# --------------------------------------------------------------------------

def _box(y, C):
    """Box for beta = y * alpha: y=+1 -> [0, C]; y=-1 -> [-C, 0]."""
    c = torch.full_like(y, C)   # a Python C would become float32 in where
    hi = torch.where(y > 0, c, 0.0)
    return hi - c, hi           # C - C = +0.0, 0.0 - C = -C: exact


def repair_equality(alpha0, y, C, S_idx, T_idx):
    """Make sum(y*alpha) over S+T exactly 0, touching T first (paper), and
    only spilling into S in the infeasible corner case (label-skewed folds).
    Both stages are no-ops when already satisfied."""
    beta = y * alpha0
    beta_S, y_S, y_T = beta[S_idx], y[S_idx], y[T_idx]
    s_S = beta_S.sum()
    lo_T, hi_T = _box(y_T, C)
    beta_T = water_fill(beta[T_idx], lo_T, hi_T, -s_S)
    alpha0 = alpha0.index_copy(0, T_idx, y_T * beta_T)
    # residual (only nonzero if -s_S was outside T's box-feasible range)
    resid = s_S + beta_T.sum()
    lo_S, hi_S = _box(y_S, C)
    beta_S = water_fill(beta_S, lo_S, hi_S, s_S - resid)
    return alpha0.index_copy(0, S_idx, y_S * beta_S)


def _bias(prev: SMOResult, y, train_mask, C):
    """b with f_i = b on the free set (paper Constraint 5)."""
    free = train_mask & (prev.alpha > 0) & (prev.alpha < C)
    nf = free.sum()
    mean_f = torch.where(free, prev.f, 0.0).sum() / torch.clamp_min(nf, 1)
    return torch.where(nf > 0, mean_f, 0.5 * (prev.b_up + prev.b_low))


# --------------------------------------------------------------------------
# grid transitions: seed across adjacent C cells (same fold, same gamma)
# --------------------------------------------------------------------------

def scale_seed_C(alpha, y, C_old, C_new, train_mask):
    """Warm-start the (C_new, gamma) grid cell from the (C_old, gamma)
    solution of the SAME fold: ``alpha * C_new / C_old`` (bounded SVs sit
    at C, which scales linearly), clipped to the new box, then water-filled
    back to ``sum(y * alpha) = 0``. Rows outside ``train_mask`` stay 0.
    No host sync."""
    s = float(C_new) / float(C_old)
    beta = y * alpha * s
    lo, hi = _box(y, float(C_new))
    lo = torch.where(train_mask, lo, 0.0)
    hi = torch.where(train_mask, hi, 0.0)
    beta = water_fill(torch.clamp(beta, lo, hi), lo, hi, 0.0)
    return y * beta


# --------------------------------------------------------------------------
# cold start (the LibSVM baseline)
# --------------------------------------------------------------------------

def cold_seed(K, y, C, prev, S_idx, R_idx, T_idx, **_):
    return torch.zeros_like(y, dtype=K.dtype)


# --------------------------------------------------------------------------
# MIR — Multiple Instance Replacement (paper Eq. 13-18, Algorithm 2)
# --------------------------------------------------------------------------

def _lstsq_svd(A, b):
    """Minimum-norm least squares through the SVD with the cutoff of
    ``jnp.linalg.lstsq``: singular values below ``eps * max(M, N) * s[0]``
    (or zero) count as zero."""
    M, N = A.shape
    rcond = torch.finfo(A.dtype).eps * max(M, N)
    with _host_read("mir_svd", A):   # its error check reads the device
        u, s, vt = torch.linalg.svd(A, full_matrices=False)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    return vt.T @ (s_inv * (u.T @ b))


def mir_seed(K, y, C, prev: SMOResult, S_idx, R_idx, T_idx):
    """Keep alpha_S; solve one least-squares system for alpha'_T.

    Eq. 17, divided through by y_i, in terms of beta_t = y_t alpha'_t:
    K[X,T] @ beta_T = df + K[X,R] @ beta_R, plus the equality row
    1^T beta_T = 1^T beta_R, with df_i = b - f_i on I_u + I_l and 0 on I_m
    (rows over the previous training set X = S + R). Then the box and
    equality constraints are repaired (the paper's AdjustAlpha).
    """
    X_idx = torch.cat([S_idx, R_idx])
    alpha, f = prev.alpha, prev.f
    mask_prev = torch.zeros(y.shape, dtype=torch.bool,
                            device=y.device).index_fill_(0, X_idx, True)
    b = _bias(prev, y, mask_prev, C)
    free = (alpha > 0) & (alpha < C)
    df = torch.where(free, 0.0, b - f)[X_idx]

    beta_R = (y * alpha)[R_idx]
    K_X = K[X_idx]
    rhs = df + K_X[:, R_idx] @ beta_R
    A = K_X[:, T_idx]
    # the equality constraint as one more row of the LS system
    A_full = torch.cat([A, torch.ones((1, T_idx.shape[0]), dtype=K.dtype,
                                      device=K.device)], 0)
    rhs_full = torch.cat([rhs, beta_R.sum()[None]], 0)
    beta_T = _lstsq_svd(A_full, rhs_full)

    lo, hi = _box(y[T_idx], C)
    beta_T = water_fill(torch.clamp(beta_T, lo, hi), lo, hi, beta_R.sum())
    alpha0 = torch.zeros_like(alpha).index_copy(0, S_idx, alpha[S_idx])
    alpha0 = alpha0.index_copy(0, T_idx, y[T_idx] * beta_T)
    return repair_equality(alpha0, y, C, S_idx, T_idx)


# --------------------------------------------------------------------------
# SIR — Single Instance Replacement (paper Eq. 19-21, Algorithm 3)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _priority(seed: int, t_n: int, dtype, pinned: bool):
    """SIR's fallback draw (``threefry.uniform``), made once a (seed, |T|,
    dtype) and kept in pinned memory for the card."""
    p = torch.from_numpy(uniform(
        seed, t_n, "float32" if dtype == torch.float32 else "float64"))
    return p.pin_memory() if pinned else p


def sir_seed(K, y, C, prev: SMOResult, S_idx, R_idx, T_idx,
             rng_key: int | None = None, fallback: str = "random", *,
             priority=None):
    """Greedy replacement: each removed x_r hands its alpha to the most
    similar (max kernel value) unused same-label x_t, then the constraints
    are repaired.

    When no unused same-label x_t is left, ``fallback="random"`` (the
    paper's rule) picks the unused x_t of highest random ``priority``;
    ``"skip"`` drops that alpha and lets the repair absorb the mass.
    ``priority`` (|T|,) defaults to the reference's draw,
    ``jax.random.uniform(PRNGKey(rng_key), (|T|,), K.dtype)`` (``rng_key``
    an int seed, 0 when None), made on the host by ``threefry.uniform``,
    so the draw is the reference's on any device; it is kept pinned and
    copied to the card without waiting on the stream.
    """
    if fallback not in ("random", "skip"):
        raise ValueError(f"fallback must be 'random' or 'skip', got {fallback!r}")
    if priority is None:
        priority = _priority(0 if rng_key is None else int(rng_key),
                             T_idx.shape[0], K.dtype, K.device.type == "cuda")
        priority = priority.to(K.device, non_blocking=True)
    else:
        priority = torch.as_tensor(priority, dtype=K.dtype).to(K.device)
    y_T = y[T_idx]
    # K is read through the indices: on the card no (|R|, n) rows or (|R|,
    # |T|) block is gathered; on the CPU the block is, in one index
    beta_T = sir_greedy(K, y[R_idx], y_T, prev.alpha[R_idx], priority,
                        fallback, R_idx, T_idx)

    lo, hi = _box(y_T, C)
    beta_T = water_fill(torch.clamp(beta_T, lo, hi), lo, hi,
                        (y * prev.alpha)[R_idx].sum())
    alpha0 = torch.zeros_like(prev.alpha).index_copy(0, S_idx,
                                                     prev.alpha[S_idx])
    alpha0 = alpha0.index_copy(0, T_idx, y_T * beta_T)
    return repair_equality(alpha0, y, C, S_idx, T_idx)


# --------------------------------------------------------------------------
# ATO — Adjusting Alpha Towards Optimum (paper Eq. 7-11, Algorithm 1)
# --------------------------------------------------------------------------

def ato_seed_ref(K, y, C, prev: SMOResult, S_idx, R_idx, T_idx,
                 max_steps: int = 30, tol: float = 1e-3):
    """Karasuyama/Takeuchi-style incremental-decremental ramp, the
    reference's host-side oracle (paper-faithful pinv least squares): the
    working sets change size every step, read from the host. Ends when R
    is drained, at eta >= 1 or after ``max_steps`` (alpha_R then clamped
    to 0), then repairs the equality constraint."""
    y = y.to(K.dtype)
    alpha, f = prev.alpha.clone(), prev.f.clone()
    n = y.shape[0]
    in_S, in_T, in_R = _transition_masks(n, S_idx, R_idx, T_idx, K.device)
    T_active = in_T.clone()
    R_active = in_R & (alpha > 0)
    alpha = torch.where(in_T, 0.0, alpha)
    where = lambda m: torch.nonzero(m).squeeze(1)  # noqa: E731

    for _ in range(max_steps):
        if not bool(R_active.any()) and not bool(T_active.any()):
            break
        train_now = in_S | (in_T & ~T_active)
        free = train_now & (alpha > 0) & (alpha < C)
        b = (torch.where(free, f, 0.0).sum() / torch.clamp_min(free.sum(), 1)
             if bool(free.any()) else 0.5 * (prev.b_up + prev.b_low))

        M, Tc, Rc = where(free), where(T_active), where(R_active)
        vT = C - alpha[Tc]                     # per-unit ramp-up of alpha_T
        vR = -alpha[Rc]                        # per-unit ramp-down of alpha_R
        # Phi = pinv([y_M; Q_MM]) [y_T y_R; Q_MT Q_MR] [C1-a_T; -a_R] (Eq.10)
        if M.numel() > 0:
            yM = y[M]
            K_M = K[M]
            Q_MM = (yM[:, None] * yM[None, :]) * K_M[:, M]
            Q_MT = (yM[:, None] * y[Tc][None, :]) * K_M[:, Tc]
            Q_MR = (yM[:, None] * y[Rc][None, :]) * K_M[:, Rc]
            A1 = torch.cat([yM[None, :], Q_MM], 0)
            rhs = torch.cat([(y[Tc] @ vT + y[Rc] @ vR)[None],
                             Q_MT @ vT + Q_MR @ vR], 0)
            rtol = 10.0 * max(A1.shape) * torch.finfo(K.dtype).eps
            Phi = torch.linalg.pinv(A1, rtol=rtol) @ rhs
        # per-unit df (Eq. 11 divided by y_i): g_i = -sum_M y_m Phi_m K_im
        #   + sum_T y_t (C-a_t) K_it - sum_R y_r a_r K_ir
        g = K[:, Tc] @ (y[Tc] * vT) + K[:, Rc] @ (y[Rc] * vR)
        if M.numel() > 0:
            g = g - K[:, M] @ (y[M] * Phi)
        # step size: smallest eta>0 putting some bound instance's f at b (Eq.5)
        bound = train_now & ~free
        live = g.abs() > 1e-12
        safe_g = torch.where(live, g, 1.0)
        etas = torch.where(bound & live, (b - f) / safe_g, math.inf)
        etas = torch.where(etas > 1e-12, etas, math.inf)
        eta = float(torch.clamp_max(etas.min(), 1.0))
        if not math.isfinite(eta):
            eta = 1.0
        if M.numel() > 0:
            alpha = alpha.index_add(0, M, -eta * Phi)
        alpha = alpha.index_add(0, Tc, eta * vT)
        alpha = alpha.index_add(0, Rc, eta * vR)
        alpha = torch.clamp(alpha, 0.0, C)
        f = f + eta * g
        # retire drained R instances; graduate T instances that meet Eq. 5
        R_active = R_active & (alpha > 1e-12 * max(C, 1.0))
        fT, aT, yT = f[Tc], alpha[Tc], y[Tc]
        ok_m = (aT > 0) & (aT < C) & ((fT - b).abs() <= tol)
        ok_u = ((yT > 0) & (aT <= 0) | ((yT < 0) & (aT >= C))) \
            & (fT >= b - tol)
        ok_l = ((yT > 0) & (aT >= C) | ((yT < 0) & (aT <= 0))) \
            & (fT <= b + tol)
        T_active = T_active.index_copy(0, Tc, ~(ok_m | ok_u | ok_l))
        if eta >= 1.0:
            break

    alpha = torch.where(in_R, 0.0, alpha)   # R must leave the training set
    return repair_equality(alpha, y, C, S_idx, T_idx)


def _bucket_cap(m: int, n: int) -> int:
    """Smallest multiple of 128 >= m, clamped to [1, n]: the padded size of
    the ramp's working set."""
    cap = max(128, -(-m // 128) * 128)
    return max(1, min(cap, n))


def _ato_step(K, y, Cs, tol, b_fallback, in_S, in_T, m_cap, max_steps,
              alpha, f, T_act, R_act, done, step, zeros, s: AtoSystem,
              carried: bool):
    """One ramp step over a row of lanes, in place on the state (alpha, f,
    T_act, R_act (lanes, n); done, step (lanes,)) and on the step's system
    ``s`` (``ato_system_buffers``); Cs and b_fallback (lanes,). No host
    sync, two launches of the ramp's own kernels: ``ato_system_lanes``
    writes the system (``carried``: B alone, from the working set that the
    step before left in ``s``; else every field, from the state), the
    working sets are compacted on the device, the LU is one batched solve
    that reports no errors (a non-finite solve falls back to Phi = 0), and
    the fused ``ato_apply_lanes`` takes the step size, the alpha and f
    updates (M, T-active and R-active are disjoint: one update of alpha)
    and the next step's working set. The kernel products are taken lane
    by lane, so a lane is what a one-lane ramp gives it but for the batched
    LU. A lane that is done passes through unchanged."""
    ato_system_lanes(K, y, Cs, alpha, f, b_fallback, in_S, in_T, T_act,
                     R_act, m_cap, out=s,
                     _route="carried" if carried else "compact")
    r = s.rhs[:, 1:]
    for idx, w, r_l in zip(s.idx, s.w, r):
        torch.mv(K.index_select(0, idx), w, out=r_l)
    r.mul_(s.yM)                     # r = yM * (K_M: @ w), each lane
    sol = torch.linalg.solve_ex(s.B, s.rhs, check_errors=False).result
    sol = sol[:, 1:]
    Phi = torch.where(s.lane & torch.isfinite(sol), sol, 0.0)
    Phi_full = zeros.scatter_add(1, s.idx, Phi)
    # per-unit df (Eq. 11 divided by y_i), one kernel matvec a lane
    u = s.w - y * Phi_full
    g = torch.empty_like(u)
    for u_l, g_l in zip(u, g):
        torch.mv(K, u_l, out=g_l)
    ato_apply_lanes(g, f, alpha, s.v, Phi_full, y, s.b, Cs, tol, s.train_now,
                    s.free, T_act, R_act, done, step, max_steps,
                    carry=AtoCarry(K, in_S, in_T, b_fallback, s))


def _ato_ramp(K, y, Cs, alpha, f, b_fallback, in_S, in_T, in_R, tol,
              m_cap: int, max_steps: int, chunk: int | None = None):
    """Fixed-shape ATO ramp over a row of lanes (alpha, f (lanes, n); Cs,
    b_fallback (lanes,)) sharing one fold transition and ``m_cap``: the
    reference's while_loop (``_ato_seed_batch_jit`` vmaps it). The M/T/R
    index sets are masks, and the per-step least squares is a bordered KKT
    solve over the working set padded to ``m_cap >= |free S at entry| +
    |T|`` (exact: a bounded row never becomes free, graduated T rows can).

    The steps are enqueued in chunks, ``chunk`` at a time (default: 1, 2,
    4, then ``ATO_CHUNK``); each lane's stop flag (the reference's loop
    condition: no R or T row active, eta >= 1, or ``max_steps`` steps)
    lives on the device, a lane that is done freezes, and the host reads
    the flags once a chunk and stops when every lane is done. Steps past a
    lane's stop are the identity, so the result does not depend on the
    chunks. The alpha and f updates, ``alpha + eta * (v - Phi)`` and ``f +
    eta * g``, are rounded by the reference as one FMA each, as the fused
    ``ato_apply_lanes`` rounds them. The step's system lives in one set of
    buffers for the whole ramp: the first step computes it from the state,
    each later one takes the working set the step before left there.
    """
    lanes, n = alpha.shape
    T_act = in_T.expand(lanes, n).clone()
    R_act = in_R & (alpha > 0)
    alpha = torch.where(in_T, 0.0, alpha)
    f = f.clone()
    done = ~(R_act.any(1) | T_act.any(1))
    if max_steps <= 0:
        done.fill_(True)
    step = torch.zeros(lanes, dtype=torch.int64, device=K.device)
    zeros = torch.zeros_like(alpha)
    s = ato_system_buffers(lanes, n, m_cap, K.device)
    size, carried = chunk or 1, False
    while True:
        for _ in range(size):
            _ato_step(K, y, Cs, tol, b_fallback, in_S, in_T, m_cap,
                      max_steps, alpha, f, T_act, R_act, done, step, zeros,
                      s, carried)
            carried = True
        with _host_read("ato_flag", K):
            if bool(done.all()):
                break
        size = chunk or min(2 * size, ATO_CHUNK)
    return torch.where(in_R, 0.0, alpha)   # R must leave the training set


def _transition_masks(n, S_idx, R_idx, T_idx, device):
    masks = []
    for idx in (S_idx, T_idx, R_idx):
        masks.append(torch.zeros(n, dtype=torch.bool, device=device)
                     .index_fill_(0, idx, True))   # no copy from the host
    return tuple(masks)


def ato_seed(K, y, C, prev: SMOResult, S_idx, R_idx, T_idx,
             max_steps: int = 30, tol: float = 1e-3,
             chunk: int | None = None):
    """ATO: ramp alpha_T up and alpha_R down along the KKT path (paper
    Algorithm 1, ``_ato_ramp`` over one lane), then repair the equality
    constraint."""
    y = y.to(K.dtype)
    n = y.shape[0]
    in_S, in_T, in_R = _transition_masks(n, S_idx, R_idx, T_idx, K.device)
    with _host_read("ato_m_cap", K):   # sizes the pad, as the reference's
        nf0 = int((in_S & (prev.alpha > 0) & (prev.alpha < C)).sum())
    m_cap = _bucket_cap(nf0 + int(T_idx.shape[0]), n)
    b_fb = torch.as_tensor(0.5 * (prev.b_up + prev.b_low), dtype=K.dtype,
                           device=K.device)
    out = _ato_ramp(K, y, _on_device([float(C)], K.dtype, K.device),
                    prev.alpha[None], prev.f[None], b_fb.reshape(1), in_S,
                    in_T, in_R, tol, m_cap, int(max_steps), chunk)
    return repair_equality(out[0], y, C, S_idx, T_idx)


def _on_device(values, dtype, dev):
    """A host sequence as a tensor on ``dev``, copied from pinned memory
    without waiting on the stream (no sync)."""
    t = torch.tensor(values, dtype=dtype)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def ato_seed_batch(K, y, Cs, prev: SMOResult, S_idx, R_idx, T_idx,
                   max_steps: int = 30, tol: float = 1e-3,
                   bucket_by_lane: bool = True, chunk: int | None = None):
    """Batched ATO over lanes sharing one fold transition, the grid's C-row
    case: ``prev`` is a batched ``SMOResult`` (leading axis = lane, one per
    C value) and ``Cs`` the lanes' C values (numbers). Returns the seeds
    (lanes, n).

    ``bucket_by_lane=True`` pads each lane's working set to its own
    ``_bucket_cap(|free S|_l + |T|, n)`` (the solo ``ato_seed``'s exact
    bound) and ramps each group of lanes of one cap together; ``False``
    pads every lane to the widest cap in one group. The lanes' free counts
    come to the host in one read. Each group is one ramp (``_ato_ramp``):
    per step one launch of each half of the step for all its lanes and one
    batched LU. Each lane is held to the solo ``ato_seed``
    within the ATO bar (the batched LU may round otherwise).
    """
    y = y.to(K.dtype)
    n, dev = y.shape[0], K.device
    C_list = [float(c) for c in Cs]
    lanes = len(C_list)
    Cs_dev = _on_device(C_list, K.dtype, dev)
    in_S, in_T, in_R = _transition_masks(n, S_idx, R_idx, T_idx, dev)
    free0 = in_S & (prev.alpha > 0) & (prev.alpha < Cs_dev[:, None])
    with _host_read("ato_m_cap", K):   # one (lanes,) read sizes every pad
        nf0s = free0.sum(1).tolist()
    t_sz = int(T_idx.shape[0])
    b_fbs = 0.5 * (prev.b_up + prev.b_low)
    if bucket_by_lane:
        caps = [_bucket_cap(nf + t_sz, n) for nf in nf0s]
    else:
        caps = [_bucket_cap(max(nf0s) + t_sz, n)] * lanes
    out = torch.empty_like(prev.alpha)
    for cap in sorted(set(caps)):
        sel = [l for l in range(lanes) if caps[l] == cap]
        pick = lambda t: torch.stack([t[l] for l in sel])  # noqa: E731
        ramp = _ato_ramp(K, y, _on_device([C_list[l] for l in sel],
                                                K.dtype, dev),
                               pick(prev.alpha), pick(prev.f), pick(b_fbs),
                               in_S, in_T, in_R, tol, cap, int(max_steps),
                               chunk)
        for i, l in enumerate(sel):
            out[l] = repair_equality(ramp[i], y, C_list[l], S_idx, T_idx)
    return out


# --------------------------------------------------------------------------
# LOO baselines: AVG (DeCoste & Wagstaff 2000) and TOP (Lee et al. 2004)
# --------------------------------------------------------------------------

def avg_seed_loo(K, y, C, alpha, t: int):
    """Remove instance t; distribute beta_t = y_t alpha_t uniformly over the
    free set, 8 rounds of spilling what the boxes refuse, then water-fill
    (paper suppl.). The prologue and the spill are ``avg_spill_loo``: one
    launch on the card. No host sync."""
    beta, lo, hi = avg_spill_loo(y, alpha, C, int(t))
    return y * water_fill(beta, lo, hi, 0.0)


def top_seed_loo(K, y, C, alpha, t: int):
    """Remove instance t; spill beta_t into instances by descending kernel
    similarity K(x_j, x_t) until absorbed, then water-fill (paper suppl.,
    TOP). The order is a stable argsort, as ``jnp.argsort`` is, with row t
    (similarity -inf) last; the prologue, the order and the spill are
    ``top_spill_loo``: one launch on the card. No host sync."""
    beta, lo, hi = top_spill_loo(K, y, alpha, C, int(t))
    return y * water_fill(beta, lo, hi, 0.0)


SEEDERS = {"cold": cold_seed, "ato": ato_seed, "ato_ref": ato_seed_ref,
           "mir": mir_seed, "sir": sir_seed}

# Seeding -> shrinking handoff: a seeded start implies an initial active
# set. Rows the seeder left bound-locked against the seeded (b_up, b_low)
# start shrunk; the pool evaluates this at admission (``shrink_on_seed``)
# through the heuristic the solver uses mid-run. Re-exported so that
# seeding-layer callers can read the mask a transform implies.
from repro_torch.svm.shrink import seed_active_mask  # noqa: E402,F401


# --------------------------------------------------------------------------
# named seed transforms — the Study API's admission vocabulary
# --------------------------------------------------------------------------
#
# A transform maps a retired lane's ``SMOResult`` to the next lane's start
# point under one contract::
#
#     alpha0 = TRANSFORMS[name](K, y, C, prev, **params)
#
# where (K, y) come from the depending lane's kernel source, C is ITS box
# bound, and ``params`` are the plan-declared keyword arguments (index
# sets, the neighbour C, the held-out instance). Plans name transforms
# (plus params) instead of closures, so a lane graph is data.
# ``repro_torch.core.study`` finishes the admission with
# ``f0 = init_f(K, y, alpha0)``.

TRANSFORMS: dict[str, callable] = {}


def register_transform(name: str):
    """Register a seed transform under ``name`` (see TRANSFORMS above)."""
    def deco(fn):
        TRANSFORMS[name] = fn
        return fn
    return deco


@register_transform("fold")
def fold_transform(K, y, C, prev, *, method, S_idx, R_idx, T_idx):
    """The paper's fold-transition seeders by name: ``method`` picks the
    SEEDERS entry, the index sets describe the h-1 -> h transition."""
    return SEEDERS[method](K, y, C, prev, S_idx, R_idx, T_idx)


@register_transform("scale_C")
def scale_C_transform(K, y, C, prev, *, C_old, train_mask):
    """C-adjacent grid warm start: scale the (C_old, gamma) solution of the
    SAME fold to this lane's C (``scale_seed_C``)."""
    return scale_seed_C(prev.alpha, y, C_old, C, train_mask)


#: scale_C never touches K, so the Study API admits it on K-less
#: (row-streaming) sources, deriving f0 from the source's streaming matvec
scale_C_transform.kernel_free = True


@register_transform("loo_avg")
def loo_avg_transform(K, y, C, prev, *, t):
    """LOO round entry (DeCoste & Wagstaff AVG): remove instance ``t`` from
    ``prev``'s solution, spreading its mass over the free set."""
    return avg_seed_loo(K, y, C, prev.alpha, t)


@register_transform("loo_top")
def loo_top_transform(K, y, C, prev, *, t):
    """LOO round entry (Lee et al. TOP): spill instance ``t``'s mass by
    descending kernel similarity."""
    return top_seed_loo(K, y, C, prev.alpha, t)
