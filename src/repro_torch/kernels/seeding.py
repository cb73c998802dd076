"""Alpha seeding's device loops on the card, built from ``csrc/seeding.cu``:
``water_fill`` (the bisection of ``src/repro/core/seeding.py:61``),
``sir_greedy`` (SIR's greedy pass, ``:225``), ``ato_system_lanes`` /
``ato_apply_lanes``, the two halves of ATO's ramp step around its LU
solve over a row of lanes (``:361-420``, and the batched ramp, ``:435``;
the solo ramp is one lane), and the LOO seeders' spills ``avg_spill``
(``:548``) and ``top_spill`` (``:573``). Each is one launch
(``sir_greedy``: a list pass and a walk a segment of the removed rows,
and a ranking of the fallback's priorities under ``"random"``) and makes
no host sync. ATO's two halves have two routes each: a ramp takes
``ato_system_lanes``' ``compact`` route on its first step and its
``carried`` route (B alone) after it, and ``ato_apply_lanes``' ``fused``
route, which also updates alpha and hands the next step its working set;
standalone calls take ``compact`` and ``split`` (today's kernels, the
witnesses). The spills too: the seeders call ``avg_spill_loo`` and
``top_spill_loo``, route ``fused``, each its seeder's whole device work
from alpha to ``water_fill``'s input (the prologue from y, alpha, C and
t; TOP's order of column t found on chip); ``avg_spill`` and
``top_spill`` on a prologue and an order formed by plain ops are route
``split`` (the witnesses, and TOP past ``TOP_FUSED_MAX_ROWS``).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version (``ref.water_fill_ref``,
``sir_greedy_ref``, ``ato_system_lanes_ref``, ``ato_apply_lanes_ref``,
``avg_spill_ref``, ``top_spill_ref``, ``avg_spill_loo_ref``,
``top_spill_loo_ref``). Float64 only, as the seeders run.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (ATO_CARRIED, AtoCarry, AtoSystem,
                                     ato_apply_lanes_ref,
                                     ato_system_lanes_ref, avg_spill_loo_ref,
                                     avg_spill_ref, loo_order_ref,
                                     loo_start_ref, sir_greedy_ref,
                                     sir_lists_ref, top_spill_loo_ref,
                                     top_spill_ref, water_fill_ref)

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


def _ptr(t) -> int:
    """A tensor's data pointer, 0 for none."""
    return 0 if t is None else t.data_ptr()


def _scalar(x, like):
    """A float64 0-d tensor on ``like``'s device; a Python number is filled
    in on the device (no copy from the host, so no sync)."""
    if isinstance(x, torch.Tensor):
        return x.to(like.device, torch.float64).reshape(()).contiguous()
    return torch.full((), float(x), dtype=torch.float64, device=like.device)


#: water_fill's bisection levels a round that a call may force
#: (``_levels``); 0 takes the kernel's own (2)
WATER_FILL_LEVELS = (0, 1, 2, 3, 4, 5)


def water_fill(beta, lo, hi, target, iters: int = 100, *, _levels: int = 0,
               _build_name: str = "seeding"):
    """clip(beta - c, lo, hi) with scalar c s.t. the sum == clip(target,
    sum(lo), sum(hi)), c by at most ``iters`` bisection steps, then the
    residue put on the freest coordinate. ``target`` is a number (passed
    to the kernel by value) or a 0-d tensor (kept on the device). On the
    card: one block, one launch, that
    evaluates several levels of the bisection tree between two barriers;
    every step's sum runs in the one-level loop's order (the witness build
    ``water_fill_seq``, bit for bit), the block's order, so within ``1e-12
    * max(C, 1)`` of the plain version elementwise. ``_levels`` forces the
    levels a round and ``_build_name`` the library (checks and timing)."""
    if not _device("water_fill", beta):
        return water_fill_ref(beta, lo, hi, target, iters)
    dev = beta.device
    _need("water_fill", dev, beta=(beta, torch.float64),
          lo=(lo, torch.float64), hi=(hi, torch.float64))
    n = beta.shape[0]
    if lo.shape != beta.shape or hi.shape != beta.shape or beta.dim() != 1:
        raise ValueError("water_fill: beta, lo and hi must be (n,) alike")
    if _levels not in WATER_FILL_LEVELS:
        raise ValueError(f"water_fill: _levels {_levels} not in "
                         f"{WATER_FILL_LEVELS}")
    tgt = _scalar(target, beta) if isinstance(target, torch.Tensor) else None
    out = torch.empty_like(beta)
    fn = _build.entry(_build_name, "water_fill_f64", _P, _P, _P, _P, _D, _P,
                      _I, _I, _I, _P)
    _build.check(fn(beta.data_ptr(), lo.data_ptr(), hi.data_ptr(), _ptr(tgt),
                    0.0 if tgt is not None else float(target),
                    out.data_ptr(), n, int(iters), int(_levels),
                    _build.stream_ptr(beta)), "water_fill")
    water_fill.launches += 1
    return out


#: SIR's candidate list lengths the kernel is built for, and the one it
#: takes (``chip_smoke.py``'s sweep on the H100: the fastest at 3,256 and
#: 6,512 rows)
SIR_LISTS = (8, 16, 32, 64)
SIR_LIST = 64


def sir_segment(m: int) -> int:
    """The removed rows a segment of SIR's walk takes on fresh lists: 1,024
    up to 4,096 removed rows, else 2,048. Shorter segments go stale less
    (the rescans fall) but give each list pass fewer rows to spread over
    the card, which costs more as the rows grow (``chip_sir_split.py`` on
    the H100: the fastest of 1,024, 2,048 and a quarter of the rows at
    3,256, 6,512 and 10,853 rows)."""
    return 1024 if m <= 4096 else 2048


#: card -> its (rescanned rows, fallback rows) since the last reset, an
#: int64 pair on the card that the kernel adds to (no host read)
_SIR_EVENTS: dict = {}


def sir_greedy_events() -> dict[str, int]:
    """SIR's greedy passes since the last reset, summed over the cards:
    the rows whose list ran out and were rescanned, and the rows that
    found no same-label t and took the fallback (reads the card)."""
    tot = [0, 0]
    for ev in _SIR_EVENTS.values():
        a, b = ev.tolist()
        tot[0] += a
        tot[1] += b
    return {"rescans": tot[0], "fallbacks": tot[1]}


def reset_sir_greedy_events() -> None:
    for ev in _SIR_EVENTS.values():
        ev.zero_()


def sir_greedy(K, y_R, y_T, alpha_R, priority, fallback: str = "random",
               R_idx=None, T_idx=None, *, _list: int | None = None,
               _segment: int | None = None):
    """SIR's greedy pass (``ref.sir_greedy_ref``): beta_T (|T|,) from the
    kernel entries K[R_idx[r], T_idx[t]], the labels, alpha_R and the
    fallback priorities. With no indices K is the (|R|, |T|) block itself.
    On the CPU the block is gathered (one advanced index) for the plain
    version; on the card the kernel reads K through the indices, so
    neither the rows nor the block is gathered: in segments of
    ``sir_segment(|R|)`` removed rows, a parallel pass builds each row's
    top ``SIR_LIST`` candidates among the T still unused, then one block
    walks the segment's rows in order (``_list`` and ``_segment`` force
    others; ``_segment=0``: one segment).
    It only compares and copies, so the card's result is the plain
    version's bit for bit, at any |T|."""
    if fallback not in ("random", "skip"):
        raise ValueError("fallback must be 'random' or 'skip', "
                         f"got {fallback!r}")
    if (R_idx is None) != (T_idx is None):
        raise ValueError("sir_greedy: give both R_idx and T_idx, or neither")
    if not _device("sir_greedy", K):
        K_RT = K if R_idx is None else K[R_idx[:, None], T_idx]
        return sir_greedy_ref(K_RT, y_R, y_T, alpha_R, priority, fallback)
    dev = K.device
    f64, i64 = torch.float64, torch.int64
    _need("sir_greedy", dev, K=(K, f64), y_R=(y_R, f64), y_T=(y_T, f64),
          alpha_R=(alpha_R, f64), priority=(priority, f64))
    if R_idx is None:
        m, t = K.shape
    else:
        _need("sir_greedy", dev, R_idx=(R_idx, i64), T_idx=(T_idx, i64))
        m, t = R_idx.shape[0], T_idx.shape[0]
    if K.dim() != 2 or y_R.shape != (m,) or alpha_R.shape != (m,) \
            or y_T.shape != (t,) or priority.shape != (t,) \
            or (R_idx is not None and (R_idx.dim() != 1 or T_idx.dim() != 1)):
        raise ValueError("sir_greedy: shapes must be K (m, t) or (n, n') "
                         "with R_idx (m,) and T_idx (t,), y_R and alpha_R "
                         "(m,), y_T and priority (t,)")
    L = SIR_LIST if _list is None else int(_list)
    seg = sir_segment(m) if _segment is None else int(_segment)
    if L not in SIR_LISTS or seg < 0:
        raise ValueError(f"sir_greedy: list length {L} not in {SIR_LISTS} "
                         f"or segment {seg} < 0")
    i32 = torch.int32
    lists = torch.empty(m * L, dtype=i32, device=dev)
    head = torch.empty(2 * m, dtype=i32, device=dev)
    picks = torch.empty(m, dtype=i32, device=dev)
    order = torch.empty(t, dtype=i32, device=dev)
    used = torch.empty((t + 31) // 32, dtype=i32, device=dev)
    state = torch.empty(3, dtype=i32, device=dev)
    beta_T = torch.empty(t, dtype=f64, device=dev)
    ev = _SIR_EVENTS.get(dev)
    if ev is None:
        ev = _SIR_EVENTS[dev] = torch.zeros(2, dtype=i64, device=dev)
    fn = _build.entry("seeding", "sir_greedy_f64", _P, _L, _P, _P, _P, _P,
                      _P, _P, _P, _I, _I, _I, _I, _I, *([_P] * 8))
    _build.check(fn(K.data_ptr(), K.stride(0), _ptr(R_idx), _ptr(T_idx),
                    y_R.data_ptr(), y_T.data_ptr(), alpha_R.data_ptr(),
                    priority.data_ptr(), beta_T.data_ptr(), m, t,
                    int(fallback == "skip"), L, seg, lists.data_ptr(),
                    head.data_ptr(), picks.data_ptr(), order.data_ptr(),
                    used.data_ptr(), state.data_ptr(), ev.data_ptr(),
                    _build.stream_ptr(K)), "sir_greedy")
    sir_greedy.launches += 1
    return beta_T


def sir_candidate_lists(K, y_R, y_T, L: int = SIR_LIST, R_idx=None,
                        T_idx=None):
    """The card pass's first phase alone: each removed row's top-L
    same-label candidates, (m, L) int32 padded with ``ref.SIR_NONE``, and
    its head (m, 2) int32. On CPU tensors the plain version,
    ``ref.sir_lists_ref`` over the (R, T) block."""
    if L not in SIR_LISTS:
        raise ValueError(f"sir_candidate_lists: L {L} not in {SIR_LISTS}")
    if not _device("sir_candidate_lists", K):
        K_RT = K if R_idx is None else K[R_idx][:, T_idx]
        return sir_lists_ref(K_RT, y_R, y_T, L)
    dev = K.device
    m, t = K.shape if R_idx is None else (R_idx.shape[0], T_idx.shape[0])
    lists = torch.empty((m, L), dtype=torch.int32, device=dev)
    head = torch.empty((m, 2), dtype=torch.int32, device=dev)
    fn = _build.entry("seeding", "sir_lists_f64", _P, _L, _P, _P, _P, _P,
                      _I, _I, _I, _P, _P, _P)
    _build.check(fn(K.data_ptr(), K.stride(0), _ptr(R_idx), _ptr(T_idx),
                    y_R.data_ptr(), y_T.data_ptr(), m, t, L,
                    lists.data_ptr(), head.data_ptr(),
                    _build.stream_ptr(K)), "sir_candidate_lists")
    return lists, head


def ato_system_buffers(lanes: int, n: int, m_cap: int,
                       device) -> AtoSystem:
    """Empty outputs of ``ato_system_lanes`` for ``lanes`` lanes of n rows
    and working sets of ``m_cap`` rows (``out=``; a ramp allocates them
    once)."""
    f64, b8 = torch.float64, torch.bool
    e = lambda *s, dt=f64: torch.empty((lanes,) + s, dtype=dt,  # noqa: E731
                                       device=device)
    return AtoSystem(train_now=e(n, dt=b8), free=e(n, dt=b8),
                     nf=e(dt=torch.int64), b=e(), v=e(n), w=e(n),
                     idx=e(m_cap, dt=torch.int64), lane=e(m_cap, dt=b8),
                     yM=e(m_cap), lam=e(), B=e(m_cap + 1, m_cap + 1),
                     rhs=e(m_cap + 1))


def _need_system(name: str, s: AtoSystem, lanes: int, n: int,
                 m_cap: int, dev) -> None:
    """``s`` shaped and typed as ``ato_system_buffers`` makes it, each
    field contiguous on ``dev``."""
    want = ato_system_buffers(lanes, n, m_cap, "meta")
    for key, t, w in zip(AtoSystem._fields, s, want):
        if t.device != dev or t.dtype != w.dtype or t.shape != w.shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous {w.dtype} "
                             f"tensor of shape {tuple(w.shape)} on {dev}")


#: ato_system_lanes' routes: ``compact`` (every output, from the state)
#: and ``carried`` (B alone, from the working set in ``out``)
ATO_SYSTEM_ROUTES = ("compact", "carried")


def ato_system_lanes(K, y, Cs, alpha, f, b_fallback, in_S, in_T, T_act,
                     R_act, m_cap: int, *, out: AtoSystem | None = None,
                     _route: str = "compact") -> AtoSystem:
    """The first half of an ATO ramp step over a row of lanes sharing K, y
    and the transition (in_S, in_T), in one launch
    (``ref.ato_system_lanes_ref``): alpha, f, T_act, R_act (lanes, n), Cs
    and b_fallback (lanes,) tensors. Each lane's masks, b, v, w, its free
    set compacted into ``idx`` (ascending, padded with row 0, as
    ``torch.nonzero`` gives with no sync), lanes, yM, lam, the bordered KKT
    matrix B and rhs[0] (rhs[1:] is left to the caller), every field with
    a leading lane axis, written into ``out`` where given
    (``ato_system_buffers``).

    Routes on the card: ``compact`` computes every field from the state;
    ``carried`` (a ramp's steps after its first) writes B alone, from the
    working set that the fused ``ato_apply_lanes`` left in ``out`` on the
    step before (idx, yM, nf, lam), which is what ``compact`` gives on
    this state, so B is too. Every output but b and rhs[0] (sums in the
    block's order) is the plain version's bit for bit, and a lane's
    outputs do not depend on the other lanes. On the CPU both routes run
    the plain version."""
    if _route not in ATO_SYSTEM_ROUTES:
        raise ValueError(f"ato_system_lanes: unknown route {_route!r}")
    if _route == "carried" and out is None:
        raise ValueError("ato_system_lanes: the carried route reads and "
                         "writes out=")
    if not _device("ato_system_lanes", K):
        s = ato_system_lanes_ref(K, y, Cs, alpha, f, b_fallback, in_S,
                                 in_T, T_act, R_act, m_cap)
        if out is None:
            return s
        for key in ATO_CARRIED + ("B",):
            getattr(out, key).copy_(getattr(s, key))
        out.rhs[:, 0] = s.rhs[:, 0]
        return out
    dev, f64, b8 = K.device, torch.float64, torch.bool
    _need("ato_system_lanes", dev, K=(K, f64), y=(y, f64),
          Cs=(Cs, f64), alpha=(alpha, f64), f=(f, f64),
          b_fallback=(b_fallback, f64), in_S=(in_S, b8), in_T=(in_T, b8),
          T_act=(T_act, b8), R_act=(R_act, b8))
    lanes, n = alpha.shape
    if K.shape != (n, n) or y.shape != (n,) or f.shape != alpha.shape \
            or T_act.shape != alpha.shape or R_act.shape != alpha.shape \
            or Cs.shape != (lanes,) or b_fallback.shape != (lanes,):
        raise ValueError("ato_system_lanes: shapes must be K (n, n), y, in_S "
                         "and in_T (n,), alpha, f, T_act and R_act (lanes, "
                         "n), Cs and b_fallback (lanes,)")
    cap = _build.entry("seeding", "ato_system_max_m_cap")()
    if not 0 < m_cap <= min(n, cap):
        raise ValueError(f"ato_system_lanes: m_cap {m_cap} outside [1, "
                         f"{min(n, cap)}]")
    if out is None:
        out = ato_system_buffers(lanes, n, m_cap, dev)
    else:
        _need_system("ato_system_lanes", out, lanes, n, m_cap, dev)
    if _route == "carried":
        fn = _build.entry("seeding", "ato_system_carried_f64", _P, _I, _I,
                          _I, _P, _P, _P, _P, _P, _P)
        _build.check(fn(K.data_ptr(), n, lanes, int(m_cap),
                        out.idx.data_ptr(), out.yM.data_ptr(),
                        out.nf.data_ptr(), out.lam.data_ptr(),
                        out.B.data_ptr(), _build.stream_ptr(K)),
                     "ato_system_lanes")
    else:
        fn = _build.entry("seeding", "ato_system_lanes_f64", _P, _I, _P, _P,
                          _P, _P, _P, _P, _P, _P, _P, _I, _I, *([_P] * 12),
                          _P)
        _build.check(fn(K.data_ptr(), n, y.data_ptr(), alpha.data_ptr(),
                        f.data_ptr(), b_fallback.data_ptr(), in_S.data_ptr(),
                        in_T.data_ptr(), T_act.data_ptr(), R_act.data_ptr(),
                        Cs.data_ptr(), lanes, int(m_cap),
                        *(t.data_ptr() for t in out), _build.stream_ptr(K)),
                     "ato_system_lanes")
    ato_system_lanes.launches += 1
    ato_system_lanes.route_launches[_route] += 1
    return out


#: ato_apply_lanes' tensors, in the split kernel's order
_APPLY_NEEDS = ("g", "f", "alpha", "v", "Phi_full", "y", "b", "train_now",
                "free", "T_act", "R_act", "done", "step")


def ato_apply_lanes(g, f, alpha, v, Phi_full, y, b, Cs, tol: float,
                    train_now, free, T_act, R_act, done, step,
                    max_steps: int, *, carry: AtoCarry | None = None):
    """The second half of an ATO ramp step over a row of lanes, one
    launch, a block a lane (``ref.ato_apply_lanes_ref``): every tensor but
    y (shared) has a leading lane axis, Cs (lanes,) is each lane's C; in
    place on each lane's row of f, T_act, R_act and its entry of done and
    step; returns eta (lanes,). A lane that starts done changes nothing
    and takes eta 0.

    Routes: without ``carry``, ``split`` (alpha is the caller's, as
    ``smo_f_update`` and a clamp took it); with ``carry``, ``fused``: alpha
    takes clip(alpha + eta (v - Phi), 0, C) in place (one fma), and the
    step's system ``carry.s`` (whose v, b, train_now and free these must
    be) takes the next step's working set (``ref.ato_carry_ref``) for the
    carried ``ato_system_lanes``. On the card every output is the plain
    version's bit for bit but the fused route's b and rhs[0] (sums in the
    block's order, the compact route's)."""
    if not _device("ato_apply_lanes", f):
        return ato_apply_lanes_ref(g, f, alpha, v, Phi_full, y, b, Cs, tol,
                                   train_now, free, T_act, R_act, done, step,
                                   max_steps, carry)
    args, b8 = locals(), torch.bool
    dt = {"train_now": b8, "free": b8, "T_act": b8, "R_act": b8, "done": b8,
          "step": torch.int64}
    _need("ato_apply_lanes", f.device, Cs=(Cs, torch.float64),
          **{k: (args[k], dt.get(k, torch.float64)) for k in _APPLY_NEEDS})
    lanes, n = f.shape
    if y.shape != (n,) or Cs.shape != (lanes,) or b.shape != (lanes,) \
            or done.shape != (lanes,) or step.shape != (lanes,) \
            or any(t.shape != f.shape for t in (g, alpha, v, Phi_full,
                                               train_now, free, T_act,
                                               R_act)):
        raise ValueError("ato_apply_lanes: shapes must be y (n,), Cs, b, "
                         "done and step (lanes,), the rest (lanes, n)")
    eta = torch.empty(lanes, dtype=torch.float64, device=f.device)
    if carry is None:
        fn = _build.entry("seeding", "ato_apply_lanes_f64", *([_P] * 14), _I,
                          _P, _I, _D, _L, _P)
        _build.check(fn(*(args[k].data_ptr() for k in _APPLY_NEEDS),
                        eta.data_ptr(), n, Cs.data_ptr(), lanes, float(tol),
                        int(max_steps), _build.stream_ptr(f)),
                     "ato_apply_lanes")
        route = "split"
    else:
        s, dev = carry.s, f.device
        m_cap = s.idx.shape[1]
        _need_system("ato_apply_lanes", s, lanes, n, m_cap, dev)
        _need("ato_apply_lanes", dev, K=(carry.K, torch.float64),
              in_S=(carry.in_S, b8), in_T=(carry.in_T, b8),
              b_fallback=(carry.b_fallback, torch.float64))
        if carry.K.shape != (n, n) or carry.in_S.shape != (n,) \
                or carry.in_T.shape != (n,) \
                or carry.b_fallback.shape != (lanes,):
            raise ValueError("ato_apply_lanes: carry needs K (n, n), in_S "
                             "and in_T (n,), b_fallback (lanes,)")
        if any(t.data_ptr() != u.data_ptr() for t, u in (
                (v, s.v), (b, s.b), (train_now, s.train_now),
                (free, s.free))):
            raise ValueError("ato_apply_lanes: v, b, train_now and free must "
                             "be carry.s's (rewritten in place)")
        fn = _build.entry("seeding", "ato_apply_fused_f64", _P, _I,
                          *([_P] * 14), _I, _D, _L, _I, *([_P] * 11), _P)
        _build.check(fn(carry.K.data_ptr(), n, g.data_ptr(), f.data_ptr(),
                        alpha.data_ptr(), Phi_full.data_ptr(), y.data_ptr(),
                        carry.in_S.data_ptr(), carry.in_T.data_ptr(),
                        T_act.data_ptr(), R_act.data_ptr(), done.data_ptr(),
                        step.data_ptr(), eta.data_ptr(), Cs.data_ptr(),
                        carry.b_fallback.data_ptr(), lanes, float(tol),
                        int(max_steps), int(m_cap),
                        *(getattr(s, k).data_ptr() for k in (
                            "train_now", "free", "nf", "b", "v", "w", "idx",
                            "lane", "yM", "lam", "rhs")),
                        _build.stream_ptr(f)), "ato_apply_lanes")
        route = "fused"
    ato_apply_lanes.launches += 1
    ato_apply_lanes.route_launches[route] += 1
    return eta


def avg_spill(beta, lo, hi, free0, resid, rounds: int = 8):
    """avg_seed_loo's spill (``ref.avg_spill_ref``), route ``split``:
    ``rounds`` rounds of spreading ``resid`` (0-d) over the free rows with
    room, in one block, one launch, from a prologue the caller formed (the
    witness of ``avg_spill_loo``). The count of rows is exact; the sum of
    the adds runs in the block's order, so within 1e-12 max(C, 1) of the
    plain version."""
    if not _device("avg_spill", beta):
        return avg_spill_ref(beta, lo, hi, free0, resid, rounds)
    dev, f64 = beta.device, torch.float64
    _need("avg_spill", dev, beta=(beta, f64), lo=(lo, f64), hi=(hi, f64),
          free0=(free0, torch.bool))
    n = beta.shape[0]
    if beta.dim() != 1 or any(t.shape != beta.shape
                              for t in (lo, hi, free0)):
        raise ValueError("avg_spill: beta, lo, hi and free0 must be (n,) "
                         "alike")
    res = _scalar(resid, beta)
    out = torch.empty_like(beta)
    fn = _build.entry("seeding", "avg_spill_f64", _P, _P, _P, _P, _P, _P,
                      _I, _I, _P)
    _build.check(fn(beta.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                    free0.data_ptr(), res.data_ptr(), out.data_ptr(), n,
                    int(rounds), _build.stream_ptr(beta)), "avg_spill")
    avg_spill.launches += 1
    avg_spill.route_launches["split"] += 1
    return out


def _loo_args(name: str, y, alpha, t: int) -> int:
    """n, after checking y and alpha ((n,) float64 on one card) and t."""
    _need(name, y.device, y=(y, torch.float64), alpha=(alpha, torch.float64))
    n = y.shape[0]
    if y.dim() != 1 or alpha.shape != y.shape or not 0 <= t < n:
        raise ValueError(f"{name}: y and alpha must be (n,) alike and t in "
                         f"[0, n), got {tuple(y.shape)}, "
                         f"{tuple(alpha.shape)}, t = {t}")
    return n


def avg_spill_loo(y, alpha, C: float, t: int):
    """avg_seed_loo from alpha to water_fill's input
    (``ref.avg_spill_loo_ref``): the prologue (beta = y * alpha with row t
    taken out as the residual, the box [lo, hi] with row t closed, the free
    rows), then the spill's 8 rounds. Returns (beta, lo, hi).

    On the card, route ``fused``: one launch, one block, the rows in
    registers (in shared memory and then L2 past 4,096), one reduction a
    round; beta is ``avg_spill``'s (the split route's, on the prologue
    that the plain ops form) bit for bit, and lo and hi the plain
    version's."""
    t = int(t)
    if not _device("avg_spill", y):
        return avg_spill_loo_ref(y, alpha, C, t)
    n = _loo_args("avg_spill_loo", y, alpha, t)
    beta, lo, hi = (torch.empty_like(y) for _ in range(3))
    fn = _build.entry("seeding", "avg_spill_fused_f64", _P, _P, _D, _I, _P,
                      _P, _P, _I, _P)
    _build.check(fn(y.data_ptr(), alpha.data_ptr(), float(C), t,
                    beta.data_ptr(), lo.data_ptr(), hi.data_ptr(), n,
                    _build.stream_ptr(y)), "avg_spill")
    avg_spill.launches += 1
    avg_spill.route_launches["fused"] += 1
    return beta, lo, hi


def top_spill(order, beta, lo, hi, resid):
    """top_seed_loo's spill (``ref.top_spill_ref``), route ``split``: the
    rows in ``order`` (int64, all but its last) take the residual
    ``resid`` (0-d) in turn, one thread walking them in one launch, from an
    order and a prologue the caller formed (``top_spill_loo`` past its
    fused route's size, and the witness). It stops where the residual is 0
    (every later take is a zero), so its beta equals the plain version's
    value for value (``torch.equal``)."""
    if not _device("top_spill", beta):
        return top_spill_ref(order, beta, lo, hi, resid)
    dev, f64 = beta.device, torch.float64
    _need("top_spill", dev, order=(order, torch.int64), beta=(beta, f64),
          lo=(lo, f64), hi=(hi, f64))
    n = beta.shape[0]
    if beta.dim() != 1 or any(t.shape != beta.shape
                              for t in (order, lo, hi)):
        raise ValueError("top_spill: order, beta, lo and hi must be (n,) "
                         "alike")
    res = _scalar(resid, beta)
    out = torch.empty_like(beta)
    fn = _build.entry("seeding", "top_spill_f64", _P, _P, _P, _P, _P, _P,
                      _I, _I, _P)
    _build.check(fn(order.data_ptr(), beta.data_ptr(), lo.data_ptr(),
                    hi.data_ptr(), res.data_ptr(), out.data_ptr(), n,
                    max(n - 1, 0), _build.stream_ptr(beta)), "top_spill")
    top_spill.launches += 1
    top_spill.route_launches["split"] += 1
    return out


#: the most rows ``top_spill_loo``'s fused route takes: each warp's sorted
#: list in shared memory, 16 rows a thread at 1,024 threads (192 KB);
#: ``kTopMaxRows`` in ``csrc/seeding.cu``
TOP_FUSED_MAX_ROWS = 16384
#: the walk-length bins of ``top_spill_walks``: 0, 1, 2-3, ..., 64 and more
TOP_WALK_BINS = ("0", "1", "2-3", "4-7", "8-15", "16-31", "32-63", "64+")

#: card -> its fused TOP walks since the last reset: an int64 (10,) on the
#: card that the kernel adds to (TOP_WALK_BINS, rows visited, the longest)
_TOP_WALKS: dict = {}


def top_spill_walks() -> dict:
    """The fused TOP spills' walks since the last reset, summed over the
    cards: the seeds, their walk lengths binned (``TOP_WALK_BINS``), the
    rows visited and the longest walk (reads the card)."""
    tot = [0] * (len(TOP_WALK_BINS) + 2)
    for ev in _TOP_WALKS.values():
        for i, v in enumerate(ev.tolist()):
            tot[i] = max(tot[i], v) if i == len(tot) - 1 else tot[i] + v
    bins = dict(zip(TOP_WALK_BINS, tot))
    return {"seeds": sum(bins.values()), "lengths": bins,
            "rows": tot[-2], "longest": tot[-1]}


def reset_top_spill_walks() -> None:
    for ev in _TOP_WALKS.values():
        ev.zero_()


def top_spill_loo(K, y, alpha, C: float, t: int):
    """top_seed_loo from alpha to water_fill's input
    (``ref.top_spill_loo_ref``): the prologue (as ``avg_spill_loo``'s),
    the rows ordered by descending K[:, t] (ties by the lower index, row t
    last: ``torch.argsort(-sim, stable=True)``), and the walk. Returns
    (beta, lo, hi).

    On the card, by size: up to ``TOP_FUSED_MAX_ROWS`` rows route
    ``fused``, one launch: column t read in place, the order found on chip
    only as far as the walk goes (each warp sorts its rows, one warp merges
    32 rows of the order at a time and walks them); past that the plain
    prologue and ``argsort``, then ``top_spill`` (route ``split``). Both
    equal the plain version value for value (``torch.equal``)."""
    t = int(t)
    if not _device("top_spill", K):
        return top_spill_loo_ref(K, y, alpha, C, t)
    n = _loo_args("top_spill_loo", y, alpha, t)
    _need("top_spill_loo", y.device, K=(K, torch.float64))
    if K.dim() != 2 or K.shape[0] != n or K.shape[1] <= t \
            or K.stride(1) != 1:
        raise ValueError("top_spill_loo: K must be (n, >t) with unit column "
                         "stride")
    if n > TOP_FUSED_MAX_ROWS:
        beta, resid, lo, hi, _ = loo_start_ref(y, alpha, C, t)
        return top_spill(loo_order_ref(K[:, t], t), beta, lo, hi, resid), \
            lo, hi
    beta, lo, hi = (torch.empty_like(y) for _ in range(3))
    walks = _TOP_WALKS.get(y.device)
    if walks is None:
        walks = _TOP_WALKS[y.device] = torch.zeros(
            len(TOP_WALK_BINS) + 2, dtype=torch.int64, device=y.device)
    fn = _build.entry("seeding", "top_spill_fused_f64", _P, _L, _P, _P, _D,
                      _I, _P, _P, _P, _I, _P, _P)
    _build.check(fn(K.data_ptr(), K.stride(0), y.data_ptr(),
                    alpha.data_ptr(), float(C), t, beta.data_ptr(),
                    lo.data_ptr(), hi.data_ptr(), n, walks.data_ptr(),
                    _build.stream_ptr(y)), "top_spill")
    top_spill.launches += 1
    top_spill.route_launches["fused"] += 1
    return beta, lo, hi


for _w in (water_fill, sir_greedy, ato_system_lanes, ato_apply_lanes,
           avg_spill, top_spill):
    _w.launches = 0
ato_system_lanes.route_launches = dict.fromkeys(ATO_SYSTEM_ROUTES, 0)
ato_apply_lanes.route_launches = {"split": 0, "fused": 0}
avg_spill.route_launches = {"fused": 0, "split": 0}
top_spill.route_launches = {"fused": 0, "split": 0}
