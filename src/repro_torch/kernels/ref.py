"""Plain PyTorch versions of every kernel of the port.

Mirrors ``src/repro/kernels/ref.py`` (the jnp oracles) and adds the SMO
step and chunk loop that ``csrc/smo_chunk.cu`` and ``csrc/smo_step.cu``
replace (the reference keeps them in ``src/repro/svm/engine.py::_step`` /
``smo_chunk``): the dense step, and the streaming WSS-1 step whose K[i, j]
and f-update come from X. On a CPU tensor the wrappers in ``ops.py`` run
these; on the card ``chip_smoke.py`` holds each kernel against them on the
same inputs.

Rounding contract (what makes the dense engine bitwise equal to the JAX
reference on a shared K): XLA-CPU contracts the f-update
``f + delta * (K_i - K_j)`` into one FMA, so it is written here as
``torch.addcmul`` and in CUDA as ``fma``; every other expression is rounded
op by op, in the reference's order.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

_INF = math.inf
_TAU = 1e-12


def rbf_kernel_matrix_ref(X, Z, gamma):
    """K[i,j] = exp(-gamma * max(|x_i|^2 + |z_j|^2 - 2 x_i.z_j, 0))."""
    xn = torch.sum(X * X, -1)[:, None]
    zn = torch.sum(Z * Z, -1)[None, :]
    d2 = torch.clamp_min(xn + zn - 2.0 * (X @ Z.T), 0.0)
    return torch.exp(-gamma * d2)


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q (B, H, S, D), k and v (B, KV, T, D) -> (B, H, S, D): plain softmax
    attention, as the reference's oracle computes it. Scores are the
    product in the input dtype cast to float32 and divided by sqrt(D); the
    mask (causal ``t <= s``, window ``t > s - window``) writes -1e30; the
    float32 softmax is cast to the input dtype before the product with v.
    With KV < H, q head h reads kv head ``h // (H // KV)`` (the reference
    broadcasts kv heads before its call; the result is the same)."""
    H, KV = q.shape[1], k.shape[1]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    S, T = q.shape[2], k.shape[2]
    scores = torch.einsum("bhsd,bhtd->bhst", q, k).float()
    scores = scores / math.sqrt(q.shape[-1])
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs.to(q.dtype), v)


def smo_f_update_ref(f, K_i, K_j, delta):
    """The SMO rank-2 indicator update ``f + delta * (K_i - K_j)``, as one
    fused multiply-add per element (the rounding XLA-CPU gives the
    reference)."""
    delta = torch.as_tensor(delta, dtype=f.dtype, device=f.device)
    return torch.addcmul(f, K_i - K_j, delta)


def fused_smo_step_ref(f, X, xij, sq_norms, delta, gamma, done=None):
    """The fused pair-rows + rank-2 update (``FusedRBF.rows2``'s expression):
    ``f + delta * (K2[:, 0] - K2[:, 1])`` with
    ``K2 = exp(-gamma * max(|x|^2 + |x_{i,j}|^2 - 2 X [x_i; x_j]^T, 0))``.

    One lane: f (n,), xij (2, d), delta a scalar. Lanes: f (b, n), xij
    (b, 2, d), delta (b,), and ``done`` (b,) bool keeps a lane's f as it
    is. The last step is one FMA per element (``torch.addcmul``), as XLA-CPU
    rounds the reference's expression."""
    if f.dim() == 2:
        return torch.stack([
            f[l] if done is not None and bool(done[l]) else
            fused_smo_step_ref(f[l], X, xij[l], sq_norms, delta[l], gamma)
            for l in range(f.shape[0])])
    cross = X @ xij.T
    d2 = torch.clamp_min(sq_norms[:, None] + torch.sum(xij * xij, 1)[None]
                         - 2.0 * cross, 0.0)
    K2 = torch.exp(-gamma * d2)
    delta = torch.as_tensor(delta, dtype=f.dtype, device=f.device)
    return torch.addcmul(f, K2[:, 0] - K2[:, 1], delta)


def rbf_kij_ref(X, sq_norms, gamma, i, j):
    """K[i, j] of an RBF source without a row in scope: the ``rows2``
    expression at row j, ``exp(-gamma * max(|x_j|^2 + |x_i|^2 - 2 x_j.x_i,
    0))`` (the reference's interpret-mode ``PallasRBF.kij``), not the
    ``|x_i - x_j|^2`` form."""
    xi = X[i]
    d2 = torch.clamp_min(sq_norms[j] + torch.sum(xi * xi)
                         - 2.0 * torch.dot(X[j], xi), 0.0)
    return torch.exp(-gamma * d2)


# --------------------------------------------------------------------------
# the SMO step (reference: svm/engine.py _sets, _argmin, _argmax, _step)
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


def smo_select_ref(K, diag, y, mask, C, tol, it_cap, wss, alpha, f, it,
                   stream=None):
    """The selection half of one SMO iteration: the freeze test, the WSS
    pair, the clipped delta and the new alpha (box-clipped). Returns
    ``(alpha, i, j, delta, done)``; a frozen state comes back unchanged
    with ``done`` True (and i = j = None, delta = 0).

    Over a dense K, or, with ``stream = (X, sq_norms, gamma)``, over a
    row-streaming RBF source (the reference's ``streams_rows`` branch; K is
    None and ``wss`` must be "1"): K[i, j] then comes from ``rbf_kij_ref``.

    The freeze test and the scalar part of the update run on the host in
    Python floats, which round as the reference's f64 scalars do: the plain
    version is the oracle, and one host read per step is cheap on the CPU.
    """
    i_up, i_low = _sets(alpha, y, mask, C)
    v_up = torch.where(i_up, f, _INF)
    v_low = torch.where(i_low, f, -_INF)
    b_up, b_low = float(v_up.min()), float(v_low.max())  # NaN propagates
    gap = b_low - b_up if bool(i_up.any()) and bool(i_low.any()) else -_INF
    if gap <= tol or it >= it_cap or math.isnan(gap):
        return alpha, None, None, 0.0, True

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

    k_ij = rbf_kij_ref(*stream, i, j) if stream is not None else K[i, j]
    f_i, f_j, a_i, a_j, y_i, y_j, d_i, d_j, k_ij = torch.stack(
        (f[i], f[j], alpha[i], alpha[j], y[i], y[j], diag[i],
         diag[j], k_ij)).tolist()
    eta_ij = _nan_max(d_i + d_j - 2.0 * k_ij, _TAU)
    delta = (f_j - f_i) / eta_ij
    hi_i = C - a_i if y_i > 0 else a_i
    hi_j = a_j if y_j > 0 else C - a_j
    delta = _nan_max(_nan_min(_nan_min(delta, hi_i), hi_j), 0.0)
    alpha = alpha.clone()
    alpha[i] = a_i + y_i * delta
    alpha[j] = float(alpha[j]) + -y_j * delta   # j == i sees the new value
    alpha = torch.clamp(alpha, 0.0, C)   # kill fp dust at the box boundary
    return alpha, i, j, delta, False


def smo_select_lanes_ref(X, sq_norms, gamma, y, masks, Cs, tol, it_caps,
                         alphas, fs, n_iter, done):
    """The selection kernel's plain version (``kernels/smo_chunk.py::
    smo_select``): ``smo_select_ref`` of the streaming step for each of b
    lanes; returns new ``(alphas, n_iter, done, xij, delta)``, the pair rows
    and delta zero for a lane that did not step."""
    b, d = masks.shape[0], X.shape[1]
    ones = torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
    Cs = torch.as_tensor(Cs, dtype=torch.float64).reshape(-1).tolist()
    caps = torch.as_tensor(it_caps).reshape(-1).tolist()
    alphas, n_iter, done = alphas.clone(), n_iter.clone(), done.clone()
    xij = torch.zeros((b, 2, d), dtype=X.dtype, device=X.device)
    delta = torch.zeros(b, dtype=X.dtype, device=X.device)
    for l in range(b):
        if bool(done[l]):
            continue
        a, i, j, dl, stop = smo_select_ref(
            None, ones, y, masks[l], Cs[l], tol, caps[l], "1", alphas[l],
            fs[l], int(n_iter[l]), (X, sq_norms, float(gamma)))
        if stop:
            done[l] = True
            continue
        alphas[l], xij[l], delta[l] = a, X[[i, j]], dl
        n_iter[l] += 1
    return alphas, n_iter, done, xij, delta


def smo_step_ref(K, diag, y, mask, C, tol, it_cap, wss, alpha, f, it,
                 update_f=smo_f_update_ref, stream=None):
    """One SMO iteration: ``smo_select_ref``, then the rank-2 f-update
    (``update_f`` over K's rows, or ``fused_smo_step_ref`` from X with a
    ``stream``). ``it`` is the host iteration count; returns ``(alpha, f,
    done)``. A frozen state comes back unchanged with ``done`` True."""
    alpha, i, j, delta, done = smo_select_ref(K, diag, y, mask, C, tol,
                                              it_cap, wss, alpha, f, it,
                                              stream)
    if done:
        return alpha, f, True
    # the rank-2 update keeps f consistent for ALL rows (masked ones too)
    if stream is not None:
        X, sq_norms, gamma = stream
        return alpha, fused_smo_step_ref(f, X, X[[i, j]], sq_norms, delta,
                                         gamma), False
    return alpha, update_f(f, K[i], K[j], delta), False


def smo_chunk_ref(K, diag, y, mask, C, tol, it_cap, n_iters, wss, alpha, f,
                  n_iter, done, update_f=smo_f_update_ref, stream=None):
    """Up to ``n_iters`` SMO steps from ``(alpha, f, n_iter, done)``: the
    loop that the chunk kernels run on the card. Returns the new state;
    ``update_f`` lets the card's copy of this loop route the dense f-update
    through the ``smo_f_update`` kernel; ``stream`` selects the streaming
    step (see ``smo_step_ref``)."""
    it, stop = int(n_iter), bool(done)
    for _ in range(n_iters):
        if stop:
            break
        alpha, f, stop = smo_step_ref(K, diag, y, mask, C, tol, it_cap, wss,
                                      alpha, f, it, update_f, stream)
        it += 0 if stop else 1
    return (alpha, f, torch.tensor(it, dtype=torch.int64, device=f.device),
            torch.tensor(stop, device=f.device))


def smo_chunk_sources_ref(K, diag, y, masks, Cs, tol, it_caps, n_iters, wss,
                          alphas, fs, n_iter, done, stream=None,
                          update_f=smo_f_update_ref):
    """The plain version of the chunk over lanes that each carry their own
    operands (``smo_chunk_sources`` / ``smo_stream_chunk_sources``): lane
    l runs ``smo_chunk_ref`` on K[l], diag[l] and y[l], or with ``stream =
    (X, sq_norms, gamma)`` (X (b, n, d), sq_norms (b, n)) on its own
    (X[l], sq_norms[l], gamma). Returns the stacked new state; ``update_f``
    as for ``smo_chunk_ref``."""
    Cs = torch.as_tensor(Cs, dtype=torch.float64).reshape(-1).tolist()
    caps = torch.as_tensor(it_caps).reshape(-1).tolist()
    outs = []
    for l in range(masks.shape[0]):
        if stream is not None:
            X, sq, gamma = stream
            ones = torch.ones(X.shape[1], dtype=X.dtype, device=X.device)
            out = smo_chunk_ref(None, ones, y[l], masks[l], Cs[l], tol,
                                caps[l], n_iters, "1", alphas[l], fs[l],
                                n_iter[l], done[l],
                                stream=(X[l], sq[l], gamma))
        else:
            out = smo_chunk_ref(K[l], diag[l], y[l], masks[l], Cs[l], tol,
                                caps[l], n_iters, wss, alphas[l], fs[l],
                                n_iter[l], done[l], update_f=update_f)
        outs.append(out)
    return tuple(torch.stack(t) for t in zip(*outs))


# --------------------------------------------------------------------------
# alpha seeding's device loops (reference: core/seeding.py water_fill,
# sir_seed's greedy pass, _ato_ramp's step; csrc/seeding.cu)
# --------------------------------------------------------------------------

def _same_bits(a, b) -> bool:
    return torch.equal(a.view(torch.int64), b.view(torch.int64))


def water_fill_ref(beta, lo, hi, target, iters: int = 100,
                   stop_early: bool = True):
    """Return clip(beta - c, lo, hi) with scalar c s.t. the sum == target.

    ``sum(clip(beta - c, lo, hi))`` is monotone non-increasing in c, so c is
    found by bisection (at most ``iters`` steps); ``target`` is clamped to
    the feasible [sum(lo), sum(hi)] first. Once a step leaves (c_lo, c_hi)
    as they were, every later step does too, so ``stop_early`` stops there
    (the result is the same bit for bit; the check reads the device)."""
    target, c_lo, c_hi = _water_fill_start(beta, lo, hi, target)
    for _ in range(iters):
        c = 0.5 * (c_lo + c_hi)
        too_big = torch.clamp(beta - c, lo, hi).sum() > target
        n_lo = torch.where(too_big, c, c_lo)
        n_hi = torch.where(too_big, c_hi, c)
        if stop_early and _same_bits(n_lo, c_lo) and _same_bits(n_hi, c_hi):
            break
        c_lo, c_hi = n_lo, n_hi
    return _water_fill_finish(beta, lo, hi, target, c_lo, c_hi)


def _water_fill_start(beta, lo, hi, target):
    """The clamped target and the bisection's first (c_lo, c_hi)."""
    target = torch.as_tensor(target, dtype=beta.dtype, device=beta.device)
    target = torch.minimum(torch.maximum(target, lo.sum()), hi.sum())
    c_lo = (beta - hi).min() - 1.0   # => all at hi: sum maximal
    c_hi = (beta - lo).max() + 1.0   # => all at lo: sum minimal
    return target, c_lo, c_hi


def _water_fill_finish(beta, lo, hi, target, c_lo, c_hi):
    """clip(beta - c, lo, hi) at c = the midpoint of (c_lo, c_hi), then
    the residue on the freest coordinate."""
    c = 0.5 * (c_lo + c_hi)
    out = torch.clamp(beta - c, lo, hi)
    # final exact touch-up on the single freest coordinate to kill bisection
    # residue (keeps sum(y*alpha)=0 at fp-exact level for the solver)
    resid = target - out.sum()
    room = torch.where(resid >= 0, hi - out, out - lo)
    j = torch.argmax(room)
    fix = torch.sign(resid) * torch.minimum(resid.abs(), room[j])
    return out.index_add(0, j.view(1), fix.view(1))


def water_fill_levels_ref(beta, lo, hi, target, iters: int = 100,
                          stop_early: bool = True, levels: int = 1):
    """``water_fill_ref`` in the card kernel's rounds (only tests use it):
    a round sums the 2^levels - 1 midpoints of the next ``levels`` levels
    of the bisection tree (node q's children: 2q + 1 for c_hi = mid, 2q + 2
    for c_lo = mid), each midpoint 0.5 (lo + hi) of the interval its path
    reaches, then walks the outcomes: at most ``iters`` steps in all,
    stopping (``stop_early``) at the first that leaves (c_lo, c_hi) as they
    were. Each sum is the one-level loop's, so the result is its bit for
    bit."""
    target, c_lo, c_hi = _water_fill_start(beta, lo, hi, target)
    k, moving = 0, True
    while k < iters and moving:
        ivl, mids, sums = [(c_lo, c_hi)], [], []
        for q in range(2 ** levels - 1):
            a, z = ivl[q]
            mid = 0.5 * (a + z)
            mids.append(mid)
            sums.append(torch.clamp(beta - mid, lo, hi).sum())
            ivl += [(a, mid), (mid, z)]
        q = 0
        for _ in range(levels):
            if k == iters:
                break
            too_big = sums[q] > target
            n_lo = torch.where(too_big, mids[q], c_lo)
            n_hi = torch.where(too_big, c_hi, mids[q])
            if stop_early and _same_bits(n_lo, c_lo) \
                    and _same_bits(n_hi, c_hi):
                moving = False
                break
            c_lo, c_hi = n_lo, n_hi
            k += 1
            q = 2 * q + 1 + int(too_big)
    return _water_fill_finish(beta, lo, hi, target, c_lo, c_hi)


def sir_greedy_ref(K_RT, y_R, y_T, alpha_R, priority, fallback="random"):
    """SIR's greedy pass: removed row r (in order) hands ``y_T[t] *
    alpha_R[r]`` to the unused same-label t of largest ``K_RT[r, t]`` (the
    lowest t on a tie, as ``argmax`` picks), or, with none left, to the
    unused t of largest ``priority`` (``fallback="skip"``: to none).
    Returns beta_T (|T|,)."""
    m, t_n = K_RT.shape
    same = y_R[:, None] == y_T[None, :]
    beta_T = torch.zeros(t_n, dtype=K_RT.dtype, device=K_RT.device)
    used = torch.zeros(t_n, dtype=torch.bool, device=K_RT.device)
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
    return beta_T


#: an empty place of a candidate list (``sir_lists_ref``)
SIR_NONE = 2 ** 31 - 1


def _label_class(y) -> int:
    return 0 if y == 1.0 else (1 if y == -1.0 else 2)


def _argmax_order(v):
    """The indices of ``v`` in ``argmax``'s order: NaN first (lower index
    first), then the larger value, then the lower index (-0.0 == 0.0)."""
    idx = torch.arange(v.shape[0])
    nan = torch.isnan(v)
    rest = idx[~nan]
    srt = torch.sort(v[~nan], descending=True, stable=True).indices
    return torch.cat([idx[nan], rest[srt]])


def sir_lists_ref(K_RT, y_R, y_T, L: int, used=None, rows=None):
    """The card pass's first phase (csrc/seeding.cu ``sir_lists``): each
    removed row's candidates (same label, not in ``used``, value above
    -inf; NaN is one) in ``argmax``'s order, the first ``L`` as an (m, L)
    int32 list padded with ``SIR_NONE``, and its head (m, 2) int32: the
    count of candidates, and min(NaN candidates, L) | the row label's
    class << 8 (y = 1: 0, -1: 1, else 2); for the ``rows`` given (default
    all), the others left as padding."""
    K_RT, y_R, y_T = K_RT.cpu(), y_R.cpu(), y_T.cpu()
    m, t = K_RT.shape
    free = torch.ones(t, dtype=torch.bool) if used is None else ~used
    lists = torch.full((m, L), SIR_NONE, dtype=torch.int32)
    head = torch.zeros((m, 2), dtype=torch.int32)
    for r in (range(m) if rows is None else rows):
        cand = torch.nonzero((y_T == y_R[r]) & free
                             & (K_RT[r] != -_INF)).flatten()
        vals = K_RT[r, cand]
        top = cand[_argmax_order(vals)][:L]
        lists[r, :top.shape[0]] = top.to(torch.int32)
        nnan = int(torch.isnan(vals).sum())
        head[r, 0] = cand.shape[0]
        head[r, 1] = min(nnan, L) | (_label_class(float(y_R[r])) << 8)
    return lists, head


def sir_greedy_lists_ref(K_RT, y_R, y_T, alpha_R, priority,
                         fallback="random", L: int = 32, events=None,
                         segment: int = 0):
    """``sir_greedy_ref`` in the card kernel's phases (only tests use
    it), over segments of ``segment`` removed rows (0: one): at a
    segment's start ``sir_lists_ref``'s lists of its rows over the t still
    unused, then the walk over its rows: the pick is the first unused
    entry of row r's list (a NaN entry: none found); a list all used of a
    row with more than L candidates is rescanned (the unused same-label t
    of largest value) unless its label has no unused t left; a row with
    none found takes the first unused t of the priority order (``skip``:
    none). ``events`` (a dict) gets the counts of rescanned and fallback
    rows. Returns beta_T, the plain pass's bit for bit."""
    K_RT, y_R, y_T = K_RT.cpu(), y_R.cpu(), y_T.cpu()
    alpha_R, priority = alpha_R.cpu(), priority.cpu()
    m, t = K_RT.shape
    seg = segment if segment > 0 else max(m, 1)
    order = _argmax_order(priority).tolist()
    used = torch.zeros(t, dtype=torch.bool)
    picks = [-1] * m
    left = [int((y_T == 1.0).sum()), int((y_T == -1.0).sum()), 0]
    fp = rescans = fallbacks = 0
    for r in range(m):
        if r % seg == 0:
            lists, head = sir_lists_ref(K_RT, y_R, y_T, L, used,
                                        range(r, min(r + seg, m)))
        cnt, hy = int(head[r, 0]), int(head[r, 1])
        nn, cls = hy & 0xFF, hy >> 8
        ent = lists[r, :min(cnt, L)].long()
        unused = torch.nonzero(~used[ent]).flatten()
        pick = -1
        if unused.numel():
            if int(unused[0]) >= nn:
                pick = int(ent[unused[0]])
        elif cnt > L and (cls == 2 or left[cls] > 0):
            rescans += 1
            scores = torch.where((y_T == y_R[r]) & ~used, K_RT[r], -_INF)
            j = int(torch.argmax(scores))
            if scores[j] > -_INF:
                pick = j
        if pick < 0:
            fallbacks += 1
            while fallback == "random" and fp < t and used[order[fp]]:
                fp += 1
            if fallback == "random" and fp < t:
                pick = order[fp]
        if pick >= 0:
            used[pick] = True
            picks[r] = pick
            pc = _label_class(float(y_T[pick]))
            if pc < 2:
                left[pc] -= 1
    beta_T = torch.zeros(t, dtype=K_RT.dtype)
    for r, p in enumerate(picks):
        if p >= 0:
            beta_T[p] = y_T[p] * alpha_R[r]
    if events is not None:
        events.update(rescans=rescans, fallbacks=fallbacks)
    return beta_T


def compact_ref(mask, m_cap: int):
    """The indices where ``mask`` holds, ascending, padded with 0 to
    ``m_cap`` (``torch.nonzero`` padded, as ``jnp.nonzero(size=m_cap)``
    gives), by a prefix sum and a scatter: no host sync."""
    pos = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (pos < m_cap), pos, m_cap)
    idx = torch.zeros(m_cap + 1, dtype=torch.long, device=mask.device)
    idx.scatter_(0, slot, torch.arange(mask.shape[0], device=mask.device))
    return idx[:m_cap]


class AtoSystem(NamedTuple):
    """One ATO ramp step's system (a lane of ``ato_system_lanes``): masks
    over n, the bias b, directions v and w = y * v, the working set idx (m_cap,) with its
    lanes and labels yM, the ridge lam on its diagonal, the bordered matrix
    B (m_cap+1, m_cap+1) and the right-hand side rhs (m_cap+1,) with rhs[0]
    = r0 set (rhs[1:] is the caller's)."""
    train_now: torch.Tensor
    free: torch.Tensor
    nf: torch.Tensor
    b: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    idx: torch.Tensor
    lane: torch.Tensor
    yM: torch.Tensor
    lam: torch.Tensor
    B: torch.Tensor
    rhs: torch.Tensor


#: the fields of an ``AtoSystem`` that the fused ``ato_apply_lanes`` hands
#: the next step (with rhs[0]); the carried route then writes B alone
ATO_CARRIED = ("train_now", "free", "nf", "b", "v", "w", "idx", "lane", "yM",
               "lam")


class AtoCarry(NamedTuple):
    """What the fused ``ato_apply_lanes`` reads beside a ramp step's state
    to hand the next step its working set: K (its diagonal), the
    transition's in_S and in_T, each lane's b_fallback, and the step's
    system ``s``, whose ``ATO_CARRIED`` fields and rhs[:, 0] it rewrites in
    place for every lane that was not done."""
    K: torch.Tensor
    in_S: torch.Tensor
    in_T: torch.Tensor
    b_fallback: torch.Tensor
    s: AtoSystem


def ato_system_ref(K, y, C, alpha, f, b_fallback, in_S, in_T, T_act, R_act,
                   m_cap: int) -> AtoSystem:
    """The first half of an ATO ramp step (``_ato_ramp``'s body up to the
    solve): the bordered KKT system for (db, Phi),

        [0    yM^T] [db ]   [sum(w)        ]
        [yM   Q_MM] [Phi] = [yM * (K_M: @ w)]

    over the free set padded to ``m_cap`` (padding lanes gather row 0, carry
    an identity diagonal and zero rhs); a tiny relative ridge keeps the LU
    finite on duplicate instances."""
    train_now = in_S | (in_T & ~T_act)
    free = train_now & (alpha > 0) & (alpha < C)
    nf = free.sum()
    b = torch.where(nf > 0,
                    torch.where(free, f, 0.0).sum() / torch.clamp_min(nf, 1),
                    b_fallback)
    # ramp directions: T ramps up to C, R ramps down to 0 (per unit eta)
    v = torch.where(T_act, C - alpha, 0.0) - torch.where(R_act, alpha, 0.0)
    w = y * v
    idx = compact_ref(free, m_cap)
    lane = torch.arange(m_cap, device=K.device) < nf
    yM = torch.where(lane, y[idx], 0.0)
    Q = (yM[:, None] * yM[None, :]) * K[idx][:, idx]
    lam = 1e-10 * (1.0 + torch.diagonal(Q).abs().max())
    B = torch.zeros((m_cap + 1, m_cap + 1), dtype=K.dtype, device=K.device)
    B[0, 0] = torch.where(nf > 0, 0.0, 1.0)
    B[0, 1:] = yM
    B[1:, 0] = yM
    B[1:, 1:] = Q + torch.diag(torch.where(lane, lam, 1.0))
    rhs = torch.zeros(m_cap + 1, dtype=K.dtype, device=K.device)
    rhs[0] = torch.where(nf > 0, w.sum(), 0.0)
    return AtoSystem(train_now, free, nf, b, v, w, idx, lane, yM, lam, B, rhs)


class AtoCarried(NamedTuple):
    """The working set ``ato_carry_ref`` builds: ``ATO_CARRIED``'s fields
    and r0 (rhs[0])."""
    train_now: torch.Tensor
    free: torch.Tensor
    nf: torch.Tensor
    b: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    idx: torch.Tensor
    lane: torch.Tensor
    yM: torch.Tensor
    lam: torch.Tensor
    r0: torch.Tensor


def ato_carry_ref(K, y, C, alpha, f, b_fallback, in_S, in_T, T_act, R_act,
                  m_cap: int) -> AtoCarried:
    """The next step's working set as the fused ``ato_apply`` builds it
    from the rows it holds after its update (alpha', f', T_act', R_act'):
    each row's masks and directions, the free rows placed by their rank
    among the free rows (a running count, as the kernel's ballots give it)
    up to ``m_cap``, the rest of idx padded with row 0, and lam from K's
    diagonal over the placed rows and, where there is padding, row 0's
    entry times a zero label. Equal to ``ato_system_ref`` on that state in
    every field but B and rhs[1:]."""
    train_now = in_S | (in_T & ~T_act)
    free = train_now & (alpha > 0) & (alpha < C)
    v = torch.where(T_act, C - alpha, 0.0) - torch.where(R_act, alpha, 0.0)
    w = y * v
    nf = free.sum()
    rank = torch.cumsum(free, 0) - 1
    placed = free & (rank < m_cap)
    rows = torch.arange(y.shape[0], device=y.device)
    idx = torch.zeros(m_cap, dtype=torch.long, device=y.device)
    idx[rank[placed]] = rows[placed]
    lane = torch.arange(m_cap, device=y.device) < nf
    yM = torch.where(lane, y[idx], 0.0)
    diag = torch.diagonal(K)
    terms = ((y * y) * diag)[placed].abs()
    if int(nf) < m_cap:
        terms = torch.cat([terms, ((0.0 * 0.0) * diag[:1]).abs()])
    lam = 1e-10 * (1.0 + terms.max())
    b = torch.where(nf > 0,
                    torch.where(free, f, 0.0).sum() / torch.clamp_min(nf, 1),
                    b_fallback)
    r0 = torch.where(nf > 0, w.sum(), 0.0)
    return AtoCarried(train_now, free, nf, b, v, w, idx, lane, yM, lam, r0)


def ato_b_ref(K, idx, yM, nf, lam):
    """The carried ``ato_system_lanes`` route's B over a row of lanes, from
    the working set alone (idx, yM (lanes, m_cap); nf, lam (lanes,)): the
    bordered matrix ``ato_system_ref`` builds, entry for entry."""
    lanes, m_cap = idx.shape
    lane = torch.arange(m_cap, device=idx.device)[None] < nf[:, None]
    Q = (yM[:, :, None] * yM[:, None, :]) * torch.stack(
        [K[i][:, i] for i in idx])
    B = torch.zeros((lanes, m_cap + 1, m_cap + 1), dtype=K.dtype,
                    device=K.device)
    B[:, 0, 0] = torch.where(nf > 0, 0.0, 1.0)
    B[:, 0, 1:] = yM
    B[:, 1:, 0] = yM
    B[:, 1:, 1:] = Q + torch.diag_embed(torch.where(lane, lam[:, None], 1.0))
    return B


def ato_apply_ref(g, f, alpha, v, Phi_full, y, b, C, tol, train_now, free,
                  T_act, R_act, done, step, max_steps: int,
                  carry: AtoCarry | None = None):
    """The second half of an ATO ramp step, in place on f, T_act, R_act,
    done and step; returns eta. The step size is the smallest eta > 1e-12
    putting some bound row's f at b (capped at 1, non-finite -> 1); f moves
    by ``f + eta * g`` (one rounding, ``torch.addcmul``); with alpha' =
    clip(alpha + eta (v - Phi), 0, C) (one rounding too), drained R rows
    retire and T rows meeting Eq. 5 graduate. done is set once eta >= 1,
    step reaches max_steps or no R or T row is active; a step that starts
    done changes nothing and returns eta = 0.

    Without ``carry`` (the split route) alpha is left to the caller (the
    ``smo_f_update`` and clamp that followed it). With ``carry`` (the fused
    route, one lane's ``AtoCarry``) alpha' is stored too, and the step's
    system ``carry.s`` takes the next step's working set
    (``ato_carry_ref`` of the state left), rhs[0] included."""
    bound = train_now & ~free
    live = g.abs() > 1e-12
    safe_g = torch.where(live, g, 1.0)
    etas = torch.where(bound & live, (b - f) / safe_g, _INF)
    etas = torch.where(etas > 1e-12, etas, _INF)
    eta = torch.clamp_max(etas.min(), 1.0)
    eta = torch.where(torch.isfinite(eta), eta, 1.0)
    a_new = torch.clamp(smo_f_update_ref(alpha, v, Phi_full, eta), 0.0, C)
    f_new = torch.addcmul(f, g, eta)
    R_new = R_act & (a_new > 1e-12 * max(C, 1.0))
    ok_m = (a_new > 0) & (a_new < C) & ((f_new - b).abs() <= tol)
    ok_u = (((y > 0) & (a_new <= 0)) | ((y < 0) & (a_new >= C))) \
        & (f_new >= b - tol)
    ok_l = (((y > 0) & (a_new >= C)) | ((y < 0) & (a_new <= 0))) \
        & (f_new <= b + tol)
    T_new = T_act & ~(ok_m | ok_u | ok_l)
    step_new = step + 1
    done_new = (eta >= 1.0) | (step_new >= max_steps) | ~(R_new.any()
                                                          | T_new.any())
    if carry is not None:
        alpha.copy_(torch.where(done, alpha, a_new))
        nxt = ato_carry_ref(carry.K, y, C, a_new, f_new, carry.b_fallback,
                            carry.in_S, carry.in_T, T_new, R_new,
                            carry.s.idx.shape[0])
        for key in ATO_CARRIED:
            t = getattr(carry.s, key)
            t.copy_(torch.where(done, t, getattr(nxt, key)))
        carry.s.rhs[0] = torch.where(done, carry.s.rhs[0], nxt.r0)
    f.copy_(torch.where(done, f, f_new))
    R_act.copy_(torch.where(done, R_act, R_new))
    T_act.copy_(torch.where(done, T_act, T_new))
    step.copy_(torch.where(done, step, step_new))
    eta = torch.where(done, 0.0, eta)
    done.copy_(done | done_new)
    return eta


def ato_system_lanes_ref(K, y, Cs, alpha, f, b_fallback, in_S, in_T, T_act,
                         R_act, m_cap: int) -> AtoSystem:
    """``ato_system_ref`` over a row of lanes sharing K, y and the
    transition (in_S, in_T): alpha, f, T_act, R_act (lanes, n), Cs and
    b_fallback (lanes,); every field of the result gains a leading lane
    axis. Each lane is ``ato_system_ref`` of its own slice."""
    parts = [ato_system_ref(K, y, C, alpha[l], f[l], b_fallback[l], in_S,
                            in_T, T_act[l], R_act[l], m_cap)
             for l, C in enumerate(torch.as_tensor(Cs).tolist())]
    return AtoSystem(*(torch.stack(xs) for xs in zip(*parts)))


def ato_apply_lanes_ref(g, f, alpha, v, Phi_full, y, b, Cs, tol, train_now,
                        free, T_act, R_act, done, step, max_steps: int,
                        carry: AtoCarry | None = None):
    """``ato_apply_ref`` over a row of lanes, in place on each lane's row of
    f, T_act, R_act and its entry of done and step (y is shared, Cs and b
    are per lane); returns eta (lanes,). With ``carry`` (the fused route:
    ``carry.s`` the lanes' system, whose v, b, train_now and free these
    are) also on alpha and on each lane's slice of ``carry.s``."""
    def lane_carry(l):
        if carry is None:
            return None
        return carry._replace(b_fallback=carry.b_fallback[l],
                              s=AtoSystem(*(t[l] for t in carry.s)))
    return torch.stack([
        ato_apply_ref(g[l], f[l], alpha[l], v[l], Phi_full[l], y, b[l], C,
                      tol, train_now[l], free[l], T_act[l], R_act[l], done[l],
                      step[l], max_steps, lane_carry(l))
        for l, C in enumerate(torch.as_tensor(Cs).tolist())])


def avg_spill_ref(beta, lo, hi, free0, resid, rounds: int = 8):
    """avg_seed_loo's spill (DeCoste & Wagstaff AVG): ``rounds`` times,
    spread the residual ``resid`` (0-d) uniformly over the free rows that
    have room in its direction, each add clipped to the row's box [lo, hi];
    what the boxes refuse carries to the next round. Returns beta."""
    resid = torch.as_tensor(resid, dtype=beta.dtype, device=beta.device)
    for _ in range(rounds):
        room = torch.where(resid >= 0, hi - beta, beta - lo)
        can = free0 & (room > 1e-15)
        share = resid / torch.clamp_min(can.sum(), 1)
        add = torch.clamp(torch.where(can, share, 0.0), -(beta - lo),
                          hi - beta)
        beta = beta + add
        resid = resid - add.sum()
    return beta


def top_spill_ref(order, beta, lo, hi, resid):
    """top_seed_loo's spill (Lee et al. TOP): walk the rows in ``order``
    (all but the last, the held-out row), each taking as much of the
    residual ``resid`` (0-d) as its box [lo, hi] has room for. Returns
    beta."""
    resid = torch.as_tensor(resid, dtype=beta.dtype, device=beta.device)
    beta = beta.clone()
    for j in order[:-1]:      # sequential by nature; no host sync inside
        room = torch.where(resid >= 0, hi[j] - beta[j], lo[j] - beta[j])
        take = torch.clamp(resid, torch.clamp_max(room, 0.0),
                           torch.clamp_min(room, 0.0))
        beta[j] = beta[j] + take
        resid = resid - take
    return beta


def loo_start_ref(y, alpha, C, t: int):
    """The LOO seeders' prologue: beta = y * alpha with row t taken out (its
    mass is the residual ``resid``, 0-d), the box [lo, hi] of beta (y > 0:
    [0, C], else [-C, 0]; C - C = +0.0 and 0.0 - C = -C, exact) with row t
    closed, and the free rows free0 = 0 < alpha < C but row t."""
    beta = y * alpha
    resid = beta[t].clone()
    beta.select(0, t).fill_(0.0)
    c = torch.full_like(y, C)   # a Python C would become float32 in where
    hi = torch.where(y > 0, c, 0.0)
    lo = hi - c
    lo.select(0, t).fill_(0.0)
    hi.select(0, t).fill_(0.0)
    free0 = (alpha > 0) & (alpha < C)
    free0.select(0, t).fill_(False)
    return beta, resid, lo, hi, free0


def loo_order_ref(sim, t: int):
    """TOP's order: the rows by descending similarity ``sim`` (K[:, t]),
    ties by the lower index, row t (-inf) last, as ``jnp.argsort`` gives
    it: a stable argsort of -sim."""
    sim = sim.clone()
    sim.select(0, t).fill_(-_INF)
    return torch.argsort(-sim, stable=True)


def avg_spill_loo_ref(y, alpha, C, t: int):
    """avg_seed_loo from alpha to water_fill's input (``avg_spill``'s fused
    route): the prologue, then ``avg_spill_ref``'s 8 rounds. Returns beta,
    lo, hi."""
    beta, resid, lo, hi, free0 = loo_start_ref(y, alpha, C, t)
    return avg_spill_ref(beta, lo, hi, free0, resid), lo, hi


def top_spill_loo_ref(K, y, alpha, C, t: int):
    """top_seed_loo from alpha to water_fill's input (``top_spill``'s fused
    route): the prologue, the order of column t, then ``top_spill_ref``.
    Returns beta, lo, hi."""
    beta, resid, lo, hi, _ = loo_start_ref(y, alpha, C, t)
    order = loo_order_ref(K[:, t], t)
    return top_spill_ref(order, beta, lo, hi, resid), lo, hi


def selective_scan_ref(u, dt, A, Bp, Cp, h0=None):
    """Mamba's selective scan with its C contraction, a float32 loop over
    t: ``h_t = exp(dt_t A) h_{t-1} + x(dt_t u_t) B_t`` from ``h0`` (zeros
    when None), ``y_t = sum_n h_t[n] C_t[n]`` rounded to u's dtype once.
    u, dt (B, S, Din) and Bp, Cp (B, S, St) in one dtype, A (Din, St)
    float32, h0 (B, Din, St) float32. Returns (y (B, S, Din), the final
    state (B, Din, St) float32).

    The reference's rounding points (``src/repro/models/ssm.py:86-88,
    :107``): ``dt * u`` is rounded to the inputs' dtype before it is
    widened, the state is float32, and ``a h + b`` is one FMA
    (``addcmul``), as XLA-CPU contracts it. The reference composes a chunk
    of 256 steps by an associative scan and sums over n in its dot's
    order; this loop takes the steps in sequence."""
    Bsz, S, Din = u.shape
    St = A.shape[-1]
    h = torch.zeros((Bsz, Din, St), dtype=torch.float32, device=u.device) \
        if h0 is None else h0.float()
    dtf = dt.float()
    dtu = (dt * u).float()
    Bf, Cf = Bp.float(), Cp.float()
    A = A.float()
    y = torch.empty((Bsz, S, Din), dtype=torch.float32, device=u.device)
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * A)
        h = torch.addcmul(dtu[:, t, :, None] * Bf[:, t, None, :], dA, h)
        y[:, t] = torch.einsum("ben,bn->be", h, Cf[:, t])
    return y.to(u.dtype), h


def log_sigmoid_ref(x):
    """``jax.nn.log_sigmoid``: -softplus(-x), with torch's softplus (within
    an ulp of jax's ``logaddexp(x, 0)``)."""
    return -F.softplus(-x)


def slstm_step_ref(gz, gi, gf, go, rz, bf, carry):
    """One sLSTM step (``src/repro/models/xlstm.py::_slstm_step``, ``:116``)
    from its input projections gz, gi, gf, go (B, D) in x's dtype, the
    recurrent weight rz (D, D), the forget bias bf (D,) and carry (c, n, h,
    m): c, n, m float32, h in x's dtype. Returns the next carry. The
    reference's rounding points: ``h @ rz`` and ``gz + r`` and the tanh and
    the sigmoid each in x's dtype; the gates' exponents float32; XLA-CPU
    contracts ``fp * c + ip * z`` and ``fp * n + ip`` into one FMA each
    (``addcmul``); ``c / max(n, 1e-6)`` rounded to x's dtype before the
    output gate multiplies it there."""
    c, n, h, m = carry
    zt = torch.tanh(gz + h @ rz)
    it = gi.float()
    ft = log_sigmoid_ref(gf.float() + bf.float())
    ot = torch.sigmoid(go)
    m1 = torch.maximum(ft + m, it)
    ip = torch.exp(it - m1)
    fp = torch.exp(ft + m - m1)
    c1 = torch.addcmul(ip * zt.float(), fp, c)
    n1 = torch.addcmul(ip, fp, n)
    h1 = ot * (c1 / torch.clamp_min(n1, 1e-6)).to(gz.dtype)
    return c1, n1, h1, m1


def slstm_scan_ref(gz, gi, gf, go, rz, bf, carry=None):
    """The sLSTM recurrence over S steps, a loop of ``slstm_step_ref``:
    gz, gi, gf, go (B, S, D) in x's dtype, from ``carry`` (c, n, h, m),
    zeros when None (the reference's prefill starts from m = 0). Returns
    (hs (B, S, D) in x's dtype, the final carry)."""
    B, S, D = gz.shape
    if carry is None:
        zero = torch.zeros((B, D), dtype=torch.float32, device=gz.device)
        carry = (zero, zero, zero.to(gz.dtype), zero)
    hs = torch.empty_like(gz)
    for t in range(S):
        carry = slstm_step_ref(gz[:, t], gi[:, t], gf[:, t], go[:, t], rz,
                               bf, carry)
        hs[:, t] = carry[2]
    return hs, carry


@functools.lru_cache(maxsize=None)
def mlstm_scale(dh: int, dtype) -> float:
    """mLSTM's score scale 1/sqrt(dh) as the reference's prefill applies it:
    a weakly typed float32, so rounded to the scores' dtype (bf16:
    0.05102539 at dh = 384)."""
    s = 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32))
    return float(s.to(dtype))


def mlstm_parallel_ref(q, k, v, logi, logf, rows=None):
    """mLSTM's parallel stabilized form (``src/repro/models/xlstm.py:53-66``)
    for query rows ``rows`` = (start, stop) (all when None) against their
    keys j <= i: q, k, v (B, S, H, dh) in x's dtype, logi and logf (B, S,
    H) float32 -> h (B, stop - start, H, dh) in x's dtype. ``F`` the
    cumsum of logf; ``Dm_ij = (F_i - F_j) + logi_j`` (j <= i, else -inf);
    ``m_i = max_j Dm_ij``; ``w = exp(Dm - m)``; the scores ``x(x(q.k) *
    x(scale))``; ``sw = f32(scores) w``; ``h = x(x(sum_j x(sw) v_j) /
    x(max(|sum_j sw|, exp(-m))))``, x() rounding to x's dtype. The rows
    materialise (B, R, stop, H) tensors: the card holds a range of rows
    at a time."""
    B, S, H, dh = q.shape
    start, stop = (0, S) if rows is None else rows
    Fc = torch.cumsum(logf, dim=1)
    Fi, Fj = Fc[:, start:stop], Fc[:, :stop]
    Dm = (Fi[:, :, None, :] - Fj[:, None, :, :]) + logi[:, None, :stop, :]
    i = torch.arange(start, stop, device=q.device)
    causal = torch.arange(stop, device=q.device)[None, :] <= i[:, None]
    Dm = torch.where(causal[None, :, :, None], Dm, -_INF)
    m = Dm.amax(dim=2, keepdim=True)
    w = torch.exp(Dm - m)
    del Dm
    scores = torch.einsum("bshk,bthk->bsth", q[:, start:stop], k[:, :stop]) \
        * mlstm_scale(dh, q.dtype)
    sw = scores.float() * w
    del scores, w
    num = torch.einsum("bsth,bthk->bshk", sw.to(q.dtype), v[:, :stop])
    den = torch.maximum(sw.sum(dim=2).abs(), torch.exp(-m[:, :, 0, :]))
    return num / den[..., None].to(q.dtype)
