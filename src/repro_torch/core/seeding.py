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
* ``sir_seed``'s random fallback: the reference draws
  ``jax.random.uniform(PRNGKey(0))``; the port draws from a CPU
  ``torch.Generator`` (seed 0 by default), so the same seed gives the same
  priorities on any device, or takes the priority vector itself.
* ``ato_seed``: ``torch.linalg.solve`` of the bordered KKT system, an LU
  like the reference's, in another library.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ops import smo_f_update
from repro_torch.svm.engine import SMOResult

_INF = math.inf


# --------------------------------------------------------------------------
# constraint repair
# --------------------------------------------------------------------------

def water_fill(beta, lo, hi, target, iters: int = 100):
    """Return clip(beta - c, lo, hi) with scalar c s.t. the sum == target.

    ``sum(clip(beta - c, lo, hi))`` is monotone non-increasing in c, so c is
    found by bisection, on the device (no host sync). ``target`` is clamped
    to the feasible [sum(lo), sum(hi)] first.
    """
    target = torch.as_tensor(target, dtype=beta.dtype, device=beta.device)
    target = torch.minimum(torch.maximum(target, lo.sum()), hi.sum())
    c_lo = (beta - hi).min() - 1.0   # => all at hi: sum maximal
    c_hi = (beta - lo).max() + 1.0   # => all at lo: sum minimal
    for _ in range(iters):
        c = 0.5 * (c_lo + c_hi)
        too_big = torch.clamp(beta - c, lo, hi).sum() > target
        c_lo, c_hi = torch.where(too_big, c, c_lo), torch.where(too_big, c_hi, c)
    c = 0.5 * (c_lo + c_hi)
    out = torch.clamp(beta - c, lo, hi)
    # final exact touch-up on the single freest coordinate to kill bisection
    # residue (keeps sum(y*alpha)=0 at fp-exact level for the solver)
    resid = target - out.sum()
    room = torch.where(resid >= 0, hi - out, out - lo)
    j = torch.argmax(room)
    fix = torch.sign(resid) * torch.minimum(resid.abs(), room[j])
    return out.index_add(0, j.view(1), fix.view(1))


def _box(y, C):
    """Box for beta = y * alpha: y=+1 -> [0, C]; y=-1 -> [-C, 0]."""
    c = torch.full_like(y, C)   # a Python C would become float32 in where
    return torch.where(y > 0, 0.0, -c), torch.where(y > 0, c, 0.0)


def repair_equality(alpha0, y, C, S_idx, T_idx):
    """Make sum(y*alpha) over S+T exactly 0, touching T first (paper), and
    only spilling into S in the infeasible corner case (label-skewed folds).
    Both stages are no-ops when already satisfied."""
    beta = y * alpha0
    s_S = beta[S_idx].sum()
    lo_T, hi_T = _box(y[T_idx], C)
    beta_T = water_fill(beta[T_idx], lo_T, hi_T, -s_S)
    alpha0 = alpha0.index_copy(0, T_idx, y[T_idx] * beta_T)
    # residual (only nonzero if -s_S was outside T's box-feasible range)
    resid = s_S + beta_T.sum()
    lo_S, hi_S = _box(y[S_idx], C)
    beta_S = water_fill(beta[S_idx], lo_S, hi_S, beta[S_idx].sum() - resid)
    return alpha0.index_copy(0, S_idx, y[S_idx] * beta_S)


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
    mask_prev = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    mask_prev[X_idx] = True
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

def sir_seed(K, y, C, prev: SMOResult, S_idx, R_idx, T_idx, *,
             generator: torch.Generator | None = None, priority=None,
             fallback: str = "random"):
    """Greedy replacement: each removed x_r hands its alpha to the most
    similar (max kernel value) unused same-label x_t, then the constraints
    are repaired.

    When no unused same-label x_t is left, ``fallback="random"`` (the
    paper's rule) picks the unused x_t of highest random ``priority``;
    ``"skip"`` drops that alpha and lets the repair absorb the mass.
    ``priority`` (|T|,) defaults to ``torch.rand`` from ``generator``, a
    CPU generator (seed 0 when None), so the draw is device-independent.
    """
    if fallback not in ("random", "skip"):
        raise ValueError(f"fallback must be 'random' or 'skip', got {fallback!r}")
    m, t_n = R_idx.shape[0], T_idx.shape[0]
    if priority is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        priority = torch.rand(t_n, generator=generator, dtype=K.dtype)
    priority = torch.as_tensor(priority, dtype=K.dtype).to(K.device)
    K_RT = K[R_idx][:, T_idx]
    y_T = y[T_idx]
    same = y[R_idx][:, None] == y_T[None, :]
    alpha_R = prev.alpha[R_idx]

    beta_T = torch.zeros(t_n, dtype=K.dtype, device=K.device)
    used = torch.zeros(t_n, dtype=torch.bool, device=K.device)
    for r in range(m):   # sequential by nature; no host sync inside
        scores = torch.where(same[r] & ~used, K_RT[r], -_INF)
        t_best = torch.argmax(scores)
        found = scores[t_best] > -_INF
        t_rand = torch.argmax(torch.where(~used, priority, -_INF))
        t = torch.where(found, t_best, t_rand)
        write = (~used).any()
        if fallback == "skip":
            write = write & found
        beta_T[t] = torch.where(write, y_T[t] * alpha_R[r], beta_T[t])
        used[t] = used[t] | write

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


def _ato_ramp(K, y, C, alpha, f, b_fallback, in_S, in_T, in_R, tol,
              m_cap: int, max_steps: int):
    """Fixed-shape ATO ramp: the M/T/R index sets are masks, and the
    per-step least squares is a bordered KKT solve over the working set
    padded to ``m_cap >= |free S at entry| + |T|`` (exact: a bounded row
    never becomes free, graduated T rows can).

    The alpha and f updates, ``alpha + eta * (v - Phi)`` and
    ``f + eta * g``, are rounded by the reference as one FMA each. The
    alpha update has the rank-2 form and goes through ``smo_f_update``,
    which is that FMA on either device; the f update is ``torch.addcmul``,
    the same single rounding on the CPU.
    """
    n = y.shape[0]
    thresh = 1e-12 * max(C, 1.0)
    valid = torch.arange(m_cap, device=K.device)
    zeros = torch.zeros(n, dtype=K.dtype, device=K.device)

    T_act, R_act = in_T, in_R & (alpha > 0)
    alpha = torch.where(in_T, 0.0, alpha)
    for _ in range(max_steps):
        if not bool(R_act.any() | T_act.any()):
            break
        train_now = in_S | (in_T & ~T_act)
        free = train_now & (alpha > 0) & (alpha < C)
        nf = free.sum()
        b = torch.where(nf > 0,
                        torch.where(free, f, 0.0).sum() / torch.clamp_min(nf, 1),
                        b_fallback)
        # ramp directions: T ramps up to C, R ramps down to 0 (per unit eta)
        v = torch.where(T_act, C - alpha, 0.0) - torch.where(R_act, alpha, 0.0)
        w = y * v
        # working set M padded to m_cap (padding lanes gather row 0 but are
        # masked out of every product below)
        nz = torch.nonzero(free).flatten()
        idx = torch.zeros(m_cap, dtype=torch.long, device=K.device)
        idx[:nz.shape[0]] = nz
        lane = valid < nf
        yM = torch.where(lane, y[idx], 0.0)
        K_M = K[idx]
        Q = (yM[:, None] * yM[None, :]) * K_M[:, idx]
        # bordered KKT system for (db, Phi), the equality row exact:
        #     [0    yM^T] [db ]   [sum(w)        ]
        #     [yM   Q_MM] [Phi] = [yM * (K_M: @ w)]
        # padding lanes carry an identity diagonal and zero rhs; a tiny
        # relative ridge keeps the LU finite on duplicate instances, and a
        # non-finite solve falls back to Phi = 0
        lam = 1e-10 * (1.0 + torch.diagonal(Q).abs().max())
        B = torch.zeros((m_cap + 1, m_cap + 1), dtype=K.dtype, device=K.device)
        B[0, 0] = torch.where(nf > 0, 0.0, 1.0)
        B[0, 1:] = yM
        B[1:, 0] = yM
        B[1:, 1:] = Q + torch.diag(torch.where(lane, lam, 1.0))
        r0 = torch.where(nf > 0, w.sum(), 0.0)
        r = yM * (K_M @ w)
        sol = torch.linalg.solve(B, torch.cat([r0[None], r]))
        Phi = torch.where(lane & torch.isfinite(sol[1:]), sol[1:], 0.0)
        Phi_full = zeros.index_add(0, idx, torch.where(lane, Phi, 0.0))
        # per-unit df (Eq. 11 divided by y_i), one kernel matvec
        g = K @ (w - y * Phi_full)
        # step size: smallest eta>0 putting some bound instance's f at b
        bound = train_now & ~free
        live = g.abs() > 1e-12
        safe_g = torch.where(live, g, 1.0)
        etas = torch.where(bound & live, (b - f) / safe_g, _INF)
        etas = torch.where(etas > 1e-12, etas, _INF)
        eta = torch.clamp_max(etas.min(), 1.0)
        eta = torch.where(torch.isfinite(eta), eta, 1.0)
        # apply (M, T-active, R-active are disjoint: one fused update)
        alpha = torch.clamp(smo_f_update(alpha, v, Phi_full, eta), 0.0, C)
        f = torch.addcmul(f, g, eta)
        # retire drained R instances; graduate T instances that meet Eq. 5
        R_act = R_act & (alpha > thresh)
        ok_m = (alpha > 0) & (alpha < C) & ((f - b).abs() <= tol)
        ok_u = (((y > 0) & (alpha <= 0)) | ((y < 0) & (alpha >= C))) \
            & (f >= b - tol)
        ok_l = (((y > 0) & (alpha >= C)) | ((y < 0) & (alpha <= 0))) \
            & (f <= b + tol)
        T_act = T_act & ~(ok_m | ok_u | ok_l)
        if bool(eta >= 1.0):
            break
    return torch.where(in_R, 0.0, alpha)   # R must leave the training set


def _transition_masks(n, S_idx, R_idx, T_idx, device):
    masks = []
    for idx in (S_idx, T_idx, R_idx):
        m = torch.zeros(n, dtype=torch.bool, device=device)
        m[idx] = True
        masks.append(m)
    return tuple(masks)


def ato_seed(K, y, C, prev: SMOResult, S_idx, R_idx, T_idx,
             max_steps: int = 30, tol: float = 1e-3):
    """ATO: ramp alpha_T up and alpha_R down along the KKT path (paper
    Algorithm 1, ``_ato_ramp``), then repair the equality constraint."""
    y = y.to(K.dtype)
    n = y.shape[0]
    in_S, in_T, in_R = _transition_masks(n, S_idx, R_idx, T_idx, K.device)
    nf0 = int((in_S & (prev.alpha > 0) & (prev.alpha < C)).sum())
    m_cap = _bucket_cap(nf0 + int(T_idx.shape[0]), n)
    b_fb = 0.5 * (prev.b_up + prev.b_low)
    out = _ato_ramp(K, y, C, prev.alpha, prev.f, b_fb, in_S, in_T, in_R, tol,
                    m_cap, int(max_steps))
    return repair_equality(out, y, C, S_idx, T_idx)


SEEDERS = {"cold": cold_seed, "ato": ato_seed, "mir": mir_seed,
           "sir": sir_seed}
