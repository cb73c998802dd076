"""Plain PyTorch versions of every kernel of the port.

Mirrors ``src/repro/kernels/ref.py`` (the jnp oracles) and adds the dense
SMO step and chunk loop that ``csrc/smo_chunk.cu`` replaces (the reference
keeps them in ``src/repro/svm/engine.py::_step`` / ``smo_chunk``). On a CPU
tensor the wrappers in ``ops.py`` run these; on the card ``chip_smoke.py``
holds each kernel against them on the same inputs.

Rounding contract (what makes the dense engine bitwise equal to the JAX
reference on a shared K): XLA-CPU contracts the f-update
``f + delta * (K_i - K_j)`` into one FMA, so it is written here as
``torch.addcmul`` and in CUDA as ``fma``; every other expression is rounded
op by op, in the reference's order.
"""
from __future__ import annotations

import math

import torch

_INF = math.inf
_TAU = 1e-12


def rbf_kernel_matrix_ref(X, Z, gamma):
    """K[i,j] = exp(-gamma * max(|x_i|^2 + |z_j|^2 - 2 x_i.z_j, 0))."""
    xn = torch.sum(X * X, -1)[:, None]
    zn = torch.sum(Z * Z, -1)[None, :]
    d2 = torch.clamp_min(xn + zn - 2.0 * (X @ Z.T), 0.0)
    return torch.exp(-gamma * d2)


def smo_f_update_ref(f, K_i, K_j, delta):
    """The SMO rank-2 indicator update ``f + delta * (K_i - K_j)``, as one
    fused multiply-add per element (the rounding XLA-CPU gives the
    reference)."""
    delta = torch.as_tensor(delta, dtype=f.dtype, device=f.device)
    return torch.addcmul(f, K_i - K_j, delta)


# --------------------------------------------------------------------------
# the dense SMO step (reference: svm/engine.py _sets, _argmin, _argmax, _step)
# --------------------------------------------------------------------------

def _sets(alpha, y, mask, C):
    """I_up / I_low membership (paper Eq. 4): I_up = I_u + I_m, I_low = I_l + I_m."""
    pos, neg = y > 0, y < 0
    at_lo, at_hi = alpha <= 0.0, alpha >= C
    # mask > x is mask & ~x on booleans, in one op
    i_up = mask > torch.where(pos, at_hi, neg & at_lo)
    i_low = mask > torch.where(pos, at_lo, neg & at_hi)
    return i_up, i_low


def _first_nan_or(v, fallback):
    """The first NaN index of ``v`` if it has one, else ``fallback`` — the
    reference's NaN guard (a NaN entry wins, as in ``jnp.argmin``)."""
    nan = torch.isnan(v)
    return torch.where(nan.any(), nan.to(torch.uint8).argmax(), fallback)


def _argmin(v):
    """First index of the minimum (``torch.argmin`` returns the first of
    equal minima), NaN-guarded: a NaN entry is selected, never an
    out-of-range index."""
    return _first_nan_or(v, v.argmin())


def _argmax(v):
    """First index of the maximum; NaN-guarded like ``_argmin``."""
    return _first_nan_or(v, v.argmax())


def _nan_min(a: float, b: float) -> float:
    """``jnp.minimum`` on host floats: NaN in, NaN out."""
    return a + b if (a != a or b != b) else (b if b < a else a)


def _nan_max(a: float, b: float) -> float:
    """``jnp.maximum`` on host floats: NaN in, NaN out."""
    return a + b if (a != a or b != b) else (b if b > a else a)


def smo_step_ref(K, diag, y, mask, C, tol, it_cap, wss, alpha, f, it,
                 update_f=smo_f_update_ref):
    """One SMO iteration on a dense K: WSS pair selection + box-clipped
    rank-2 update. ``it`` is the host iteration count; returns
    ``(alpha, f, done)``.

    A state that is optimal, iteration-capped or NaN-poisoned comes back
    unchanged with ``done`` True (the reference's freeze). The freeze test
    and the scalar part of the update run on the host in Python floats,
    which round as the reference's f64 scalars do: the plain version is
    the oracle, and one host read per step is cheap on the CPU.
    """
    i_up, i_low = _sets(alpha, y, mask, C)
    v_up = torch.where(i_up, f, _INF)
    v_low = torch.where(i_low, f, -_INF)
    b_up, b_low = float(v_up.min()), float(v_low.max())  # NaN propagates
    gap = b_low - b_up if bool(i_up.any()) and bool(i_low.any()) else -_INF
    if gap <= tol or it >= it_cap or math.isnan(gap):
        return alpha, f, True

    # no NaN in v_up here (it would make gap NaN), so _argmin's NaN guard
    # is moot; WSS-2's gain can still hold one (a NaN row of K or diag)
    i = int(_argmin(v_up))
    if wss == "2":
        # LibSVM WSS-2: among j in I_low with f_j > f_i, maximise
        # (f_j - f_i)^2 / eta_j
        diff = f - f[i]
        eta = torch.clamp_min(diag[i] + diag - 2.0 * K[i], _TAU)
        gain = torch.where(i_low & (diff > 0), diff * diff / eta, -_INF)
        j = int(_argmax(gain))
    else:
        # WSS-1 (maximal violating pair)
        j = int(_argmax(v_low))

    f_i, f_j, a_i, a_j, y_i, y_j, d_i, d_j = torch.stack(
        (f[i], f[j], alpha[i], alpha[j], y[i], y[j], diag[i],
         diag[j])).tolist()
    eta_ij = _nan_max(d_i + d_j - 2.0 * float(K[i, j]), _TAU)
    delta = (f_j - f_i) / eta_ij
    hi_i = C - a_i if y_i > 0 else a_i
    hi_j = a_j if y_j > 0 else C - a_j
    delta = _nan_max(_nan_min(_nan_min(delta, hi_i), hi_j), 0.0)
    alpha = alpha.clone()
    alpha[i] = a_i + y_i * delta
    alpha[j] = float(alpha[j]) + -y_j * delta   # j == i sees the new value
    alpha = torch.clamp(alpha, 0.0, C)   # kill fp dust at the box boundary
    # the rank-2 update keeps f consistent for ALL rows (masked ones too)
    return alpha, update_f(f, K[i], K[j], delta), False


def smo_chunk_ref(K, diag, y, mask, C, tol, it_cap, n_iters, wss, alpha, f,
                  n_iter, done, update_f=smo_f_update_ref):
    """Up to ``n_iters`` SMO steps from ``(alpha, f, n_iter, done)``: the
    loop that the chunk kernel runs on the card in one launch. Returns the
    new state; ``update_f`` lets the card's copy of this loop route the
    f-update through the ``smo_f_update`` kernel."""
    it, stop = int(n_iter), bool(done)
    for _ in range(n_iters):
        if stop:
            break
        alpha, f, stop = smo_step_ref(K, diag, y, mask, C, tol, it_cap, wss,
                                      alpha, f, it, update_f)
        it += 0 if stop else 1
    return (alpha, f, torch.tensor(it, dtype=torch.int64, device=f.device),
            torch.tensor(stop, device=f.device))
