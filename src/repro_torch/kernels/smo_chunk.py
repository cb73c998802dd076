"""Device-resident SMO chunk on the card, built from ``csrc/smo_chunk.cu``:
the counterpart of the ``lax.while_loop`` over ``_step`` in
``src/repro/svm/engine.py::smo_chunk`` (whose f-update is the Pallas
``smo_f_update`` on a TPU).

On a CUDA tensor the wrapper runs up to ``n_iters`` SMO iterations in one
launch (or raises); on a CPU tensor it runs the plain per-step loop,
``ref.smo_chunk_ref``. Either way the inputs are left untouched and the new
state comes back as new tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import smo_chunk_ref

_P, _LL, _D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double


def _check(K, diag, y, mask, alpha, f, n_iter, done, wss):
    n = K.shape[0]
    if K.dim() != 2 or K.shape[1] != n or n >= 2 ** 31:
        raise ValueError(f"smo_chunk: K must be square, got {tuple(K.shape)}")
    for name, t, dtype, shape in (
            ("K", K, torch.float64, (n, n)),
            ("diag", diag, torch.float64, (n,)),
            ("y", y, torch.float64, (n,)),
            ("mask", mask, torch.bool, (n,)),
            ("alpha", alpha, torch.float64, (n,)),
            ("f", f, torch.float64, (n,)),
            ("n_iter", n_iter, torch.int64, ()),
            ("done", done, torch.bool, ())):
        if t.device != K.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"smo_chunk: {name} must be {dtype} {shape} on "
                             f"{K.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if wss not in ("1", "2"):
        raise ValueError(f"smo_chunk: wss must be '1' or '2', got {wss!r}")


def smo_chunk(K, diag, y, mask, C, tol, it_cap, n_iters, wss, alpha, f,
              n_iter, done):
    """Up to ``n_iters`` dense SMO iterations from ``(alpha, f, n_iter,
    done)`` over K (n, n) float64; returns the new ``(alpha, f, n_iter,
    done)``. ``C``, ``tol``, ``it_cap`` and ``n_iters`` are host scalars."""
    if K.device.type == "cpu":
        return smo_chunk_ref(K, diag, y, mask, C, tol, it_cap, n_iters, wss,
                             alpha, f, n_iter, done)
    if K.device.type != "cuda":
        raise ValueError(f"smo_chunk: unsupported device {K.device}")
    _check(K, diag, y, mask, alpha, f, n_iter, done, wss)
    K, diag, y, mask = (t.contiguous() for t in (K, diag, y, mask))
    alpha, f, n_iter, done = (t.clone(memory_format=torch.contiguous_format)
                              for t in (alpha, f, n_iter, done))
    fn = _build.entry("smo_chunk", "smo_chunk_f64", _P, _P, _P, _P, _D, _D,
                      _LL, _LL, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int,
                      _P)
    err = fn(K.data_ptr(), diag.data_ptr(), y.data_ptr(), mask.data_ptr(),
             float(C), float(tol), int(it_cap), int(n_iters),
             2 if wss == "2" else 1, alpha.data_ptr(), f.data_ptr(),
             n_iter.data_ptr(), done.data_ptr(), K.shape[0],
             _build.stream_ptr(K))
    _build.check(err, "smo_chunk")
    smo_chunk.launches += 1
    return alpha, f, n_iter, done


smo_chunk.launches = 0
