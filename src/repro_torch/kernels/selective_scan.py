"""Mamba's selective scan on the card, built from
``csrc/selective_scan.cu``: the counterpart of the reference's chunked scan
(``src/repro/models/ssm.py:103``, a ``lax.scan`` over ``_ssm_chunk`` with
the in-chunk ``associative_scan`` at ``:51``) and its C contraction
(``:107``), which XLA runs as loops and einsums, not Pallas.

On CUDA tensors the wrapper launches the kernel (float32 or bfloat16
inputs, St = 16, Din a multiple of 4 or 8, every tensor 16-byte aligned)
or raises; on CPU tensors it runs the plain version,
``ref.selective_scan_ref`` (a float32 loop over t). Prefill passes no
state; decode passes the cache's float32 ``ssm`` as both ``h0`` and
``h_out``, so one launch a layer reads and rewrites it in place.
``selective_scan.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import selective_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
#: input dtype -> the C entry that launches the kernel for it
_SYMBOLS = {torch.float32: "selective_scan_f32",
            torch.bfloat16: "selective_scan_bf16"}
#: the state width the kernel is built for (a channel's 16 lanes)
STATE = 16


def selective_scan(u, dt, A, Bp, Cp, h0=None, h_out=None):
    """y (B, S, Din) in u's dtype: ``h_t = exp(dt_t A) h_{t-1} +
    x(dt_t u_t) B_t`` from ``h0`` (zeros when None), ``y_t = x(sum_n
    h_t[n] C_t[n])``, x() rounding to u's dtype. u and dt (B, S, Din), Bp
    and Cp (B, S, St) in one dtype; A (Din, St), h0 and h_out (B, Din, St)
    float32. The final state is written into ``h_out`` when given (it may
    be ``h0``: decode updates its cache in place)."""
    states = [t for t in (h0, h_out) if t is not None]
    if all(t.device.type == "cpu" for t in (u, dt, A, Bp, Cp, *states)):
        y, h = selective_scan_ref(u, dt, A, Bp, Cp, h0)
        if h_out is not None:
            h_out.copy_(h)
        return y
    if u.device.type != "cuda" or any(
            t.device != u.device for t in (dt, A, Bp, Cp, *states)):
        raise ValueError("selective_scan: every tensor must be on one CUDA "
                         "device (or all on the CPU)")
    if u.dtype not in _SYMBOLS or any(t.dtype != u.dtype
                                      for t in (dt, Bp, Cp)):
        raise TypeError(f"selective_scan takes u, dt, Bp and Cp in one of "
                        f"float32 or bfloat16, got {u.dtype}, {dt.dtype}, "
                        f"{Bp.dtype}, {Cp.dtype}")
    if A.dtype != torch.float32 or any(t.dtype != torch.float32
                                       for t in states):
        raise TypeError("selective_scan: A, h0 and h_out must be float32")
    if u.dim() != 3:
        raise ValueError(f"selective_scan: u {tuple(u.shape)} is not "
                         "(B, S, Din)")
    B, S, Din = u.shape
    want = {"dt": (dt, (B, S, Din)), "A": (A, (Din, STATE)),
            "Bp": (Bp, (B, S, STATE)), "Cp": (Cp, (B, S, STATE)),
            "h0": (h0, (B, Din, STATE)), "h_out": (h_out, (B, Din, STATE))}
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} {tuple(t.shape)}, want "
                             f"{shape} (the kernel is built for St = "
                             f"{STATE})")
    if not all(t.is_contiguous() for t in (u, dt, A, Bp, Cp, *states)):
        raise ValueError("selective_scan: every tensor must be contiguous")
    # the kernel copies rows of channels and states 16 bytes at a time and
    # reads A and the state 4 floats at a time
    if Din % (16 // u.element_size()) or any(
            t.data_ptr() % 16 for t in (u, dt, A, Bp, Cp, *states)):
        raise ValueError(f"selective_scan: Din ({Din}) must be a multiple "
                         f"of {16 // u.element_size()} and every tensor "
                         "16-byte aligned")
    y = torch.empty_like(u)
    fn = _build.entry("selective_scan", _SYMBOLS[u.dtype], _P, _P, _P, _P,
                      _P, _P, _P, _P, _I, _I, _I, _P)
    err = fn(u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bp.data_ptr(),
             Cp.data_ptr(), None if h0 is None else h0.data_ptr(),
             None if h_out is None else h_out.data_ptr(), y.data_ptr(), B, S,
             Din, _build.stream_ptr(u))
    _build.check(err, "selective_scan")
    selective_scan.launches += 1
    return y


selective_scan.launches = 0
