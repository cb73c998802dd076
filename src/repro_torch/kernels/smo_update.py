"""SMO rank-2 f-update on the card: the counterpart of
``src/repro/kernels/smo_update.py`` (Pallas ``smo_f_update``), built from
``csrc/smo_update.cu``; its per-element FMA (``csrc/smo_common.cuh``) is
also the tail of the chunk kernel.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version, ``ref.smo_f_update_ref`` (``torch.addcmul``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import smo_f_update_ref

_P = ctypes.c_void_p


def smo_f_update(f, K_i, K_j, delta):
    """f, K_i, K_j: (n,) float64; delta a scalar (a 0-d tensor stays on the
    device, so no sync) -> ``f + delta * (K_i - K_j)``, a new tensor."""
    if f.device.type == "cpu":
        return smo_f_update_ref(f, K_i, K_j, delta)
    if f.device.type != "cuda":
        raise ValueError(f"smo_f_update: unsupported device {f.device}")
    for name, t in (("f", f), ("K_i", K_i), ("K_j", K_j)):
        if t.device != f.device or t.dtype != torch.float64 \
                or t.shape != f.shape or t.dim() != 1:
            raise ValueError(f"smo_f_update: {name} must be a float64 (n,) "
                             f"tensor on {f.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    f, K_i, K_j = f.contiguous(), K_i.contiguous(), K_j.contiguous()
    d = delta
    if not (isinstance(d, torch.Tensor) and d.dim() == 0
            and d.dtype == torch.float64 and d.device == f.device):
        d = torch.as_tensor(delta, dtype=torch.float64, device=f.device)
        if d.numel() != 1:
            raise ValueError("smo_f_update: delta must be a scalar")
        d = d.reshape(()).contiguous()
    out = torch.empty_like(f)
    fn = _build.entry("smo_update", "smo_f_update_f64", _P, _P, _P, _P, _P,
                      ctypes.c_longlong, _P)
    err = fn(f.data_ptr(), K_i.data_ptr(), K_j.data_ptr(), d.data_ptr(),
             out.data_ptr(), f.shape[0], _build.stream_ptr(f))
    _build.check(err, "smo_f_update")
    smo_f_update.launches += 1
    return out


smo_f_update.launches = 0
