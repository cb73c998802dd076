"""Alpha seeding's device loops on the card, built from ``csrc/seeding.cu``:
``water_fill`` (the bisection of ``src/repro/core/seeding.py:61``),
``sir_greedy`` (SIR's greedy pass, ``:225``), and ``ato_system`` /
``ato_apply``, the two halves of ATO's ramp step around its LU solve
(``:361-420``). Each is one launch and makes no host sync.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version (``ref.water_fill_ref``,
``sir_greedy_ref``, ``ato_system_ref``, ``ato_apply_ref``). Float64 only,
as the seeders run.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (AtoSystem, ato_apply_ref, ato_system_ref,
                                     sir_greedy_ref, water_fill_ref)

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double


def _device(name: str, t) -> bool:
    """True on the card, False on the CPU; raises on any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _need(name: str, dev, **tensors) -> None:
    """Each tensor (given as ``name=(tensor, dtype)``) on ``dev``,
    contiguous, of its dtype."""
    for key, (t, dtype) in tensors.items():
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous {dtype} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")


def _scalar(x, like):
    """A float64 0-d tensor on ``like``'s device; a Python number is filled
    in on the device (no copy from the host, so no sync)."""
    if isinstance(x, torch.Tensor):
        return x.to(like.device, torch.float64).reshape(()).contiguous()
    return torch.full((), float(x), dtype=torch.float64, device=like.device)


def water_fill(beta, lo, hi, target, iters: int = 100):
    """clip(beta - c, lo, hi) with scalar c s.t. the sum == clip(target,
    sum(lo), sum(hi)), c by at most ``iters`` bisection steps, then the
    residue put on the freest coordinate. ``target`` is a number or a 0-d
    tensor (kept on the device). On the card: one block, one launch; sums
    in the block's order, so within ``1e-12 * max(C, 1)`` of the plain
    version elementwise."""
    if not _device("water_fill", beta):
        return water_fill_ref(beta, lo, hi, target, iters)
    dev = beta.device
    _need("water_fill", dev, beta=(beta, torch.float64),
          lo=(lo, torch.float64), hi=(hi, torch.float64))
    n = beta.shape[0]
    if lo.shape != beta.shape or hi.shape != beta.shape or beta.dim() != 1:
        raise ValueError("water_fill: beta, lo and hi must be (n,) alike")
    tgt = _scalar(target, beta)
    out = torch.empty_like(beta)
    fn = _build.entry("seeding", "water_fill_f64", _P, _P, _P, _P, _P, _I,
                      _I, _P)
    _build.check(fn(beta.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                    tgt.data_ptr(), out.data_ptr(), n, int(iters),
                    _build.stream_ptr(beta)), "water_fill")
    water_fill.launches += 1
    return out


def sir_greedy(K_RT, y_R, y_T, alpha_R, priority, fallback: str = "random"):
    """SIR's greedy pass (``ref.sir_greedy_ref``): beta_T (|T|,) from the
    (|R|, |T|) kernel block, the labels, alpha_R and the fallback
    priorities. It only compares and copies, so the card's result is the
    plain version's bit for bit."""
    if fallback not in ("random", "skip"):
        raise ValueError("fallback must be 'random' or 'skip', "
                         f"got {fallback!r}")
    if not _device("sir_greedy", K_RT):
        return sir_greedy_ref(K_RT, y_R, y_T, alpha_R, priority, fallback)
    dev = K_RT.device
    f64 = torch.float64
    _need("sir_greedy", dev, K_RT=(K_RT, f64), y_R=(y_R, f64),
          y_T=(y_T, f64), alpha_R=(alpha_R, f64), priority=(priority, f64))
    m, t = K_RT.shape
    if y_R.shape != (m,) or alpha_R.shape != (m,) or y_T.shape != (t,) \
            or priority.shape != (t,):
        raise ValueError("sir_greedy: shapes must be K_RT (m, t), y_R and "
                         "alpha_R (m,), y_T and priority (t,)")
    t_max = _build.entry("seeding", "sir_greedy_max_t")()
    if t > t_max:
        raise ValueError(f"sir_greedy: |T| = {t} is past the kernel's "
                         f"{t_max}")
    beta_T = torch.empty(t, dtype=f64, device=dev)
    fn = _build.entry("seeding", "sir_greedy_f64", _P, _L, _P, _P, _P, _P,
                      _P, _I, _I, _I, _P)
    _build.check(fn(K_RT.data_ptr(), t, y_R.data_ptr(), y_T.data_ptr(),
                    alpha_R.data_ptr(), priority.data_ptr(),
                    beta_T.data_ptr(), m, t, int(fallback == "skip"),
                    _build.stream_ptr(K_RT)), "sir_greedy")
    sir_greedy.launches += 1
    return beta_T


def ato_system(K, y, C: float, alpha, f, b_fallback, in_S, in_T, T_act,
               R_act, m_cap: int) -> AtoSystem:
    """The first half of an ATO ramp step (``ref.ato_system_ref``): masks,
    b, v, w, the free set compacted into ``idx`` (ascending, padded with
    row 0, as ``torch.nonzero`` gives with no sync), lanes, yM, the
    bordered KKT matrix B and rhs[0]. On the card every output but b and
    rhs[0] (sums in the block's order) is the plain version's bit for
    bit."""
    if not _device("ato_system", K):
        return ato_system_ref(K, y, C, alpha, f, b_fallback, in_S, in_T,
                              T_act, R_act, m_cap)
    dev, f64, b8 = K.device, torch.float64, torch.bool
    bfb = _scalar(b_fallback, K)
    _need("ato_system", dev, K=(K, f64), y=(y, f64), alpha=(alpha, f64),
          f=(f, f64), in_S=(in_S, b8), in_T=(in_T, b8), T_act=(T_act, b8),
          R_act=(R_act, b8))
    n = y.shape[0]
    if K.shape != (n, n):
        raise ValueError(f"ato_system: K must be ({n}, {n})")
    cap = _build.entry("seeding", "ato_system_max_m_cap")()
    if not 0 < m_cap <= min(n, cap):
        raise ValueError(f"ato_system: m_cap {m_cap} outside [1, "
                         f"{min(n, cap)}]")
    e = lambda *s, dt=f64: torch.empty(s, dtype=dt, device=dev)  # noqa: E731
    out = AtoSystem(train_now=e(n, dt=b8), free=e(n, dt=b8),
                    nf=e(dt=torch.int64), b=e(), v=e(n), w=e(n),
                    idx=e(m_cap, dt=torch.int64), lane=e(m_cap, dt=b8),
                    yM=e(m_cap), B=e(m_cap + 1, m_cap + 1), rhs=e(m_cap + 1))
    fn = _build.entry("seeding", "ato_system_f64", _P, _I, _P, _P, _P, _P,
                      _P, _P, _P, _P, _D, _I, *([_P] * 11), _P)
    _build.check(fn(K.data_ptr(), n, y.data_ptr(), alpha.data_ptr(),
                    f.data_ptr(), bfb.data_ptr(), in_S.data_ptr(),
                    in_T.data_ptr(), T_act.data_ptr(), R_act.data_ptr(),
                    float(C), int(m_cap),
                    *(t.data_ptr() for t in out), _build.stream_ptr(K)),
                 "ato_system")
    ato_system.launches += 1
    return out


def ato_apply(g, f, alpha, v, Phi_full, y, b, C: float, tol: float,
              train_now, free, T_act, R_act, done, step, max_steps: int):
    """The second half of an ATO ramp step (``ref.ato_apply_ref``), in place
    on f, T_act, R_act, done (0-d bool) and step (0-d int64); returns eta
    (0-d). A step that starts done changes nothing and returns 0. On the
    card every output is the plain version's bit for bit."""
    if not _device("ato_apply", f):
        return ato_apply_ref(g, f, alpha, v, Phi_full, y, b, C, tol,
                             train_now, free, T_act, R_act, done, step,
                             max_steps)
    dev, f64, b8 = f.device, torch.float64, torch.bool
    _need("ato_apply", dev, g=(g, f64), f=(f, f64), alpha=(alpha, f64),
          v=(v, f64), Phi_full=(Phi_full, f64), y=(y, f64), b=(b, f64),
          train_now=(train_now, b8), free=(free, b8), T_act=(T_act, b8),
          R_act=(R_act, b8), done=(done, b8), step=(step, torch.int64))
    n = f.shape[0]
    eta = torch.empty((), dtype=f64, device=dev)
    fn = _build.entry("seeding", "ato_apply_f64", *([_P] * 14), _I, _D, _D,
                      _D, _L, _P)
    _build.check(fn(g.data_ptr(), f.data_ptr(), alpha.data_ptr(),
                    v.data_ptr(), Phi_full.data_ptr(), y.data_ptr(),
                    b.data_ptr(), train_now.data_ptr(), free.data_ptr(),
                    T_act.data_ptr(), R_act.data_ptr(), done.data_ptr(),
                    step.data_ptr(), eta.data_ptr(), n, float(C), float(tol),
                    1e-12 * max(C, 1.0), int(max_steps),
                    _build.stream_ptr(f)), "ato_apply")
    ato_apply.launches += 1
    return eta


for _w in (water_fill, sir_greedy, ato_system, ato_apply):
    _w.launches = 0
