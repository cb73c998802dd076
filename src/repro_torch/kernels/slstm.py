"""The sLSTM recurrence on the card, built from ``csrc/slstm.cu``: the
counterpart of the reference's ``lax.scan`` over ``_slstm_step``
(``src/repro/models/xlstm.py:138``, the step at ``:116-130``), which XLA
runs as a while loop, not Pallas.

The caller hands over the four input projections gz, gi, gf, go of every
step (none depends on h: one GEMM computes them) and the recurrent weight
rz; one launch runs the whole time loop. Two routes (``route``):
``cluster`` (bf16 at D = 768, xlstm-125m's: a cluster of 16 blocks a
batch row, rz in their registers, h handed between them by ``st.async``
onto an ``mbarrier``; a card that cannot place such a cluster refuses
the launch, and the wrapper raises) and ``block`` (any other: one block
a batch row, rz read from L2 each step; ``_route="block"`` forces it,
the witness the cluster route equals bit for bit). On CUDA tensors the
wrapper launches the kernel (float32 or bfloat16, D 64 or 768, the gates
views with one set of strides and a unit last stride) or raises; on
CPU tensors it runs the plain version, ``ref.slstm_scan_ref``. Prefill
passes no carry (zeros, the reference's m = 0 start); decode passes the
cache's (c, n, h, m) as both ``carry`` and ``carry_out``, so one launch a
layer reads and rewrites it in place. ``slstm_scan.launches`` counts the
launches, ``slstm_scan.route_launches`` by route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import slstm_scan_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: (route, input dtype) -> the C entry that launches its kernel
_SYMBOLS = {("block", torch.float32): "slstm_scan_f32",
            ("block", torch.bfloat16): "slstm_scan_bf16",
            ("cluster", torch.bfloat16): "slstm_scan_bf16_cluster"}
#: the widths the kernel is run at: SMOKE's 64 and xlstm-125m's 768
WIDTHS = (64, 768)
#: the width the cluster route is built for
CLUSTER_WIDTH = 768


def route(dtype, D: int) -> str:
    """The route a launch at (dtype, D) takes."""
    return "cluster" if dtype == torch.bfloat16 and D == CLUSTER_WIDTH \
        else "block"


def _check_carry(name: str, carry, B: int, D: int, dtype) -> None:
    """Raise unless ``carry`` is (c, n, h, m), each contiguous (B, D), h in
    ``dtype`` and the others float32."""
    dtypes = (torch.float32, torch.float32, dtype, torch.float32)
    if len(carry) != 4 or not all(
            tuple(t.shape) == (B, D) and t.dtype == dt and t.is_contiguous()
            for t, dt in zip(carry, dtypes)):
        raise ValueError(f"slstm_scan: {name} must be (c, n, h, m), each "
                         f"contiguous ({B}, {D}), h in {dtype}, the others "
                         "float32")


def slstm_scan(gz, gi, gf, go, rz, bf, carry=None, carry_out=None, *,
               _route=None, _build_name="slstm"):
    """hs (B, S, D) in the gates' dtype: the sLSTM recurrence
    (``ref.slstm_step_ref``) over S steps of the input projections gz, gi,
    gf, go (B, S, D) with the recurrent weight rz (D, D) and forget bias
    bf (D,) in that dtype, from ``carry`` (c, n, h, m) (B, D): c, n, m
    float32, h in the gates' dtype; zeros when None. The final carry is
    written into ``carry_out`` when given (it may be ``carry``: decode
    updates its cache in place). ``_route`` forces a route on the card
    (checks and timing); ``_build_name`` names the build launched
    (``"slstm_chain"``: the cluster route's serial chain alone, timed as
    its floor; its output is not the recurrence; ``"slstm_cluster32"``: a
    cluster no card places, whose launch raises)."""
    states = [t for c in (carry, carry_out) if c is not None for t in c]
    tensors = (gz, gi, gf, go, rz, bf, *states)
    if all(t.device.type == "cpu" for t in tensors):
        hs, last = slstm_scan_ref(gz, gi, gf, go, rz, bf, carry)
        if carry_out is not None:
            for dst, src in zip(carry_out, last, strict=True):
                dst.copy_(src)
        return hs
    if gz.device.type != "cuda" or any(t.device != gz.device
                                       for t in tensors):
        raise ValueError("slstm_scan: every tensor must be on one CUDA "
                         "device (or all on the CPU)")
    if gz.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != gz.dtype for t in (gi, gf, go, rz, bf)):
        raise TypeError(f"slstm_scan takes gz, gi, gf, go, rz and bf in one "
                        f"of float32 or bfloat16, got {gz.dtype}, "
                        f"{gi.dtype}, {gf.dtype}, {go.dtype}, {rz.dtype}, "
                        f"{bf.dtype}")
    if gz.dim() != 3:
        raise ValueError(f"slstm_scan: gz {tuple(gz.shape)} is not (B, S, D)")
    B, S, D = gz.shape
    if D not in WIDTHS:
        raise ValueError(f"slstm_scan: D = {D}; the kernel runs at "
                         f"{WIDTHS}")
    gates = (gz, gi, gf, go)
    if any(tuple(g.shape) != (B, S, D) or g.stride() != gz.stride()
           for g in gates) or gz.stride(2) != 1:
        raise ValueError("slstm_scan: gz, gi, gf and go must be (B, S, D) "
                         "with one set of strides and a unit last stride")
    if tuple(rz.shape) != (D, D) or tuple(bf.shape) != (D,) \
            or not (rz.is_contiguous() and bf.is_contiguous()):
        raise ValueError(f"slstm_scan: rz {tuple(rz.shape)} and bf "
                         f"{tuple(bf.shape)} must be contiguous ({D}, {D}) "
                         f"and ({D},)")
    for name, c in (("carry", carry), ("carry_out", carry_out)):
        if c is not None:
            _check_carry(name, c, B, D, gz.dtype)
    took = route(gz.dtype, D) if _route is None else _route
    if (took, gz.dtype) not in _SYMBOLS or (took == "cluster"
                                            and D != CLUSTER_WIDTH):
        raise ValueError(f"slstm_scan: no {took!r} route for {gz.dtype} at "
                         f"D = {D}")
    hs = torch.empty((B, S, D), dtype=gz.dtype, device=gz.device)
    fn = _build.entry(_build_name, _SYMBOLS[took, gz.dtype], _P, _P, _P, _P, _L,
                      _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                      _I, _P)
    cin = [None] * 4 if carry is None else [t.data_ptr() for t in carry]
    cout = [None] * 4 if carry_out is None \
        else [t.data_ptr() for t in carry_out]
    err = fn(gz.data_ptr(), gi.data_ptr(), gf.data_ptr(), go.data_ptr(),
             gz.stride(1), gz.stride(0), rz.data_ptr(), bf.data_ptr(), *cin,
             *cout, hs.data_ptr(), B, S, D, _build.stream_ptr(gz))
    _build.check(err, "slstm_scan")
    slstm_scan.launches += 1
    slstm_scan.route_launches[took] += 1
    return hs


slstm_scan.launches = 0
slstm_scan.route_launches = {"block": 0, "cluster": 0}
