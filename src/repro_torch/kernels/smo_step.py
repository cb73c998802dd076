"""Fused SMO step on the card: the counterpart of
``src/repro/kernels/smo_step.py`` (Pallas ``fused_smo_step``), built from
``csrc/smo_step.cu``. One pass over X computes the WSS pair's two RBF
kernel rows and applies ``f + delta * (K_i - K_j)`` without writing the rows.

The wrapper takes one lane (the reference's signature) or b lanes over one
X, each with its own pair rows, delta and done flag. On a CUDA tensor it
launches the kernel (float64 or float32) or raises; on a CPU tensor it runs
the plain version, ``ref.fused_smo_step_ref``. Either way ``f`` is left
untouched and the result comes back as a new tensor.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_smo_step_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {torch.float64: "fused_smo_step_f64",
            torch.float32: "fused_smo_step_f32"}


def fused_smo_step(f, X, xij, sq_norms, delta, gamma: float, *, done=None):
    """``f + delta * (K2[:, 0] - K2[:, 1])`` over the pair rows ``xij``.

    One lane: f (n,), xij (2, d), delta a scalar. Lanes: f (b, n), xij
    (b, 2, d), delta (b,), and an optional ``done`` (b,) bool that leaves a
    lane's f as it is. X (n, d) and sq_norms (n,) are shared; float64 or
    float32 throughout (f32 accumulates in f32, as the TPU kernel does).
    """
    if f.device.type == "cpu":
        return fused_smo_step_ref(f, X, xij, sq_norms, delta, gamma, done)
    if f.device.type != "cuda":
        raise ValueError(f"fused_smo_step: unsupported device {f.device}")
    lanes = f.dim() == 2
    F = f if lanes else f[None]
    P = xij if lanes else xij[None]
    b, n = F.shape
    d = X.shape[-1]
    dtype = f.dtype
    if dtype not in _SYMBOLS:
        raise TypeError(f"fused_smo_step takes float64 or float32, got "
                        f"{dtype}")
    for name, t, shape in (("X", X, (n, d)), ("xij", P, (b, 2, d)),
                           ("sq_norms", sq_norms, (n,))):
        if t.device != f.device or t.dtype != dtype \
                or tuple(t.shape) != shape:
            raise ValueError(f"fused_smo_step: {name} must be {dtype} "
                             f"{shape} on {f.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if max(n, d) >= 2 ** 31 or b * n >= 2 ** 62:
        raise ValueError("fused_smo_step: n and d must be below 2**31")
    dl = torch.as_tensor(delta, dtype=dtype, device=f.device).reshape(-1)
    if dl.numel() != b:
        raise ValueError(f"fused_smo_step: delta must have {b} values, got "
                         f"{dl.numel()}")
    dl = dl.contiguous()
    dn = None
    if done is not None:
        dn = torch.as_tensor(done, device=f.device).reshape(-1)
        if dn.dtype != torch.bool or dn.numel() != b:
            raise ValueError(f"fused_smo_step: done must be {b} bools")
        dn = dn.contiguous()
    out = F.clone(memory_format=torch.contiguous_format)
    X, P, sq_norms = X.contiguous(), P.contiguous(), sq_norms.contiguous()
    fn = _build.entry("smo_step", _SYMBOLS[dtype], _P, _P, _P, _P, _P, _P, _I,
                      _I, _I, ctypes.c_double, _P)
    err = fn(out.data_ptr(), X.data_ptr(), sq_norms.data_ptr(), P.data_ptr(),
             dl.data_ptr(), None if dn is None else dn.data_ptr(), n, d, b,
             float(gamma), _build.stream_ptr(f))
    _build.check(err, "fused_smo_step")
    fused_smo_step.launches += 1
    return out if lanes else out[0]


fused_smo_step.launches = 0
