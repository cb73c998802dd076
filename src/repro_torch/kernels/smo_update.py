"""SMO rank-2 f-update on the card: the counterpart of
``src/repro/kernels/smo_update.py`` (Pallas ``smo_f_update``), built from
``csrc/smo_update.cu``; its per-element FMA (``csrc/smo_common.cuh``) is
also the tail of the chunk kernel. It also takes rows of n with a delta
each (ATO's alpha update over a row of lanes), each row what the one-row
launch gives it.

On a CUDA tensor a wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version, ``ref.smo_f_update_ref`` (``torch.addcmul``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import smo_f_update_ref

_P = ctypes.c_void_p


def smo_f_update(f, K_i, K_j, delta):
    """``f + delta * (K_i - K_j)``, a new tensor, one launch: f, K_i, K_j
    (n,) float64 with delta a scalar (a 0-d tensor stays on the device, so
    no sync), or (rows, n) with delta a (rows,) float64 tensor on the
    device, one delta a row (ATO's alpha update over a row of lanes). Each
    row is what the one-row launch gives it."""
    rows = f.dim() == 2
    if f.device.type == "cpu":
        return smo_f_update_ref(f, K_i, K_j, delta[:, None] if rows else delta)
    if f.device.type != "cuda":
        raise ValueError(f"smo_f_update: unsupported device {f.device}")
    for name, t in (("f", f), ("K_i", K_i), ("K_j", K_j)):
        if t.device != f.device or t.dtype != torch.float64 \
                or t.shape != f.shape or t.dim() not in (1, 2):
            raise ValueError(f"smo_f_update: {name} must be a float64 (n,) "
                             f"or (rows, n) tensor on {f.device} shaped as "
                             f"f, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    f, K_i, K_j = f.contiguous(), K_i.contiguous(), K_j.contiguous()
    d = delta
    if rows:
        if not isinstance(d, torch.Tensor) or d.device != f.device \
                or d.dtype != torch.float64 or d.shape != f.shape[:1]:
            raise ValueError("smo_f_update: delta must be a float64 (rows,) "
                             f"tensor on {f.device} for (rows, n) inputs")
    elif not (isinstance(d, torch.Tensor) and d.dim() == 0
              and d.dtype == torch.float64 and d.device == f.device):
        d = torch.as_tensor(delta, dtype=torch.float64, device=f.device)
        if d.numel() != 1:
            raise ValueError("smo_f_update: delta must be a scalar")
    d = d.reshape(-1).contiguous()
    out = torch.empty_like(f)
    fn = _build.entry("smo_update", "smo_f_update_f64", _P, _P, _P, _P, _P,
                      ctypes.c_longlong, ctypes.c_int, _P)
    err = fn(f.data_ptr(), K_i.data_ptr(), K_j.data_ptr(), d.data_ptr(),
             out.data_ptr(), f.shape[-1], d.shape[0], _build.stream_ptr(f))
    _build.check(err, "smo_f_update")
    smo_f_update.launches += 1
    return out


smo_f_update.launches = 0
