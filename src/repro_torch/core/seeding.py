"""Alpha-seeding algorithms (the paper's contribution).

Mirrors ``src/repro/core/seeding.py``: ``water_fill``, ``_box``,
``repair_equality``, ``_bias``, ``cold_seed``, ``mir_seed``, ``sir_seed``,
``ato_seed`` over ``_ato_ramp``, and ``SEEDERS``. ``ato_seed_ref``,
``ato_seed_batch``, ``scale_seed_C``, the LOO seeders and ``TRANSFORMS``
are later slices of the port.

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
  LU like the reference's, in another library.

The reference runs its seeding loops as jitted device loops; so does the
port. On the card ``water_fill``, SIR's greedy pass and the two halves of
ATO's ramp step are kernels (``kernels/seeding.py``, one launch each; on
the CPU their plain versions), and ATO's ramp is enqueued in chunks of
steps with its stop flag on the device. A seed makes at most these host
syncs, each counted in ``HOST_SYNCS`` and let through a
``torch.cuda.set_sync_debug_mode("error")``: ATO's ``m_cap`` (once), its
stop flag (once a chunk), and MIR's SVD (its error check, once).
"""
from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.core.threefry import uniform
from repro_torch.kernels.ops import (ato_apply, ato_system, sir_greedy,
                                     smo_f_update, water_fill)
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
    K_RT = K[R_idx][:, T_idx]
    y_T = y[T_idx]
    beta_T = sir_greedy(K_RT, y[R_idx], y_T, prev.alpha[R_idx], priority,
                        fallback)

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

def _bucket_cap(m: int, n: int) -> int:
    """Smallest multiple of 128 >= m, clamped to [1, n]: the padded size of
    the ramp's working set."""
    cap = max(128, -(-m // 128) * 128)
    return max(1, min(cap, n))


def _ato_step(K, y, C, tol, b_fallback, in_S, in_T, m_cap, max_steps,
              alpha, f, T_act, R_act, done, step, zeros):
    """One ramp step, in place on the state (alpha, f, T_act, R_act, done,
    step). No host sync: the working set is compacted on the device, the
    LU reports no errors (a non-finite solve falls back to Phi = 0), and a
    step that starts done leaves the state as it is (``ato_apply``'s eta =
    0 makes the alpha update the identity)."""
    s = ato_system(K, y, C, alpha, f, b_fallback, in_S, in_T, T_act, R_act,
                   m_cap)
    r = s.rhs[1:]
    torch.mv(K.index_select(0, s.idx), s.w, out=r)
    r.mul_(s.yM)                     # r = yM * (K_M: @ w)
    sol = torch.linalg.solve_ex(s.B, s.rhs, check_errors=False).result
    Phi = torch.where(s.lane & torch.isfinite(sol[1:]), sol[1:], 0.0)
    Phi_full = zeros.index_add(0, s.idx, Phi)
    # per-unit df (Eq. 11 divided by y_i), one kernel matvec
    g = K @ (s.w - y * Phi_full)
    eta = ato_apply(g, f, alpha, s.v, Phi_full, y, s.b, C, tol, s.train_now,
                    s.free, T_act, R_act, done, step, max_steps)
    # M, T-active and R-active are disjoint: one fused update
    torch.clamp(smo_f_update(alpha, s.v, Phi_full, eta), 0.0, C, out=alpha)


def _ato_ramp(K, y, C, alpha, f, b_fallback, in_S, in_T, in_R, tol,
              m_cap: int, max_steps: int, chunk: int | None = None):
    """Fixed-shape ATO ramp: the M/T/R index sets are masks, and the
    per-step least squares is a bordered KKT solve over the working set
    padded to ``m_cap >= |free S at entry| + |T|`` (exact: a bounded row
    never becomes free, graduated T rows can).

    The steps are enqueued in chunks, ``chunk`` at a time (default: 1, 2,
    4, then ``ATO_CHUNK``); the stop flag (the reference's loop condition:
    no R or T row active, eta >= 1, or ``max_steps`` steps) lives on the
    device and the host reads it once a chunk. Steps past it are the
    identity, so the result does not depend on the chunks. The alpha and
    f updates, ``alpha + eta * (v - Phi)`` and ``f + eta * g``, are rounded
    by the reference as one FMA each: the first goes through
    ``smo_f_update``, the second is ``ato_apply``'s.
    """
    n = y.shape[0]
    T_act, R_act = in_T.clone(), in_R & (alpha > 0)
    alpha = torch.where(in_T, 0.0, alpha)
    f = f.clone()
    done = ~(R_act.any() | T_act.any())
    if max_steps <= 0:
        done.fill_(True)
    step = torch.zeros((), dtype=torch.int64, device=K.device)
    zeros = torch.zeros(n, dtype=K.dtype, device=K.device)
    size = chunk or 1
    while True:
        for _ in range(size):
            _ato_step(K, y, C, tol, b_fallback, in_S, in_T, m_cap, max_steps,
                      alpha, f, T_act, R_act, done, step, zeros)
        with _host_read("ato_flag", K):
            if bool(done):
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
    Algorithm 1, ``_ato_ramp``), then repair the equality constraint."""
    y = y.to(K.dtype)
    n = y.shape[0]
    in_S, in_T, in_R = _transition_masks(n, S_idx, R_idx, T_idx, K.device)
    with _host_read("ato_m_cap", K):   # sizes the pad, as the reference's
        nf0 = int((in_S & (prev.alpha > 0) & (prev.alpha < C)).sum())
    m_cap = _bucket_cap(nf0 + int(T_idx.shape[0]), n)
    b_fb = 0.5 * (prev.b_up + prev.b_low)
    out = _ato_ramp(K, y, C, prev.alpha, prev.f, b_fb, in_S, in_T, in_R, tol,
                    m_cap, int(max_steps), chunk)
    return repair_equality(out, y, C, S_idx, T_idx)


SEEDERS = {"cold": cold_seed, "ato": ato_seed, "mir": mir_seed,
           "sir": sir_seed}
