"""RBF kernel matrix on the card: the counterpart of
``src/repro/kernels/rbf.py`` (Pallas ``rbf_kernel_matrix``), built from
``csrc/rbf.cu``.

On a CUDA tensor the wrapper launches the hand-written kernel (float64 or
float32) or raises; on a CPU tensor it runs the plain PyTorch version,
``ref.rbf_kernel_matrix_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rbf_kernel_matrix_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {torch.float64: "rbf_kernel_matrix_f64",
            torch.float32: "rbf_kernel_matrix_f32"}
#: output tile edges the kernel is instantiated for (64 is the default)
_TILES = (64, 32)


def rbf_kernel_matrix(X, Z, gamma: float, *, _tile: int = 64):
    """K[i,j] = exp(-gamma * ||X_i - Z_j||^2); X (n,d), Z (m,d) -> (n,m).

    ``_tile`` (private: only the tile-invariance checks set it) picks the
    kernel's output tile, 64 or 32; every tile shape sums each dot product
    in the same order, so the results are identical.
    """
    if X.device.type == "cpu" and Z.device.type == "cpu":
        return rbf_kernel_matrix_ref(X, Z, gamma)
    if X.device != Z.device or X.device.type != "cuda":
        raise ValueError(f"X on {X.device} and Z on {Z.device}: both must "
                         "be on one CUDA device (or both on the CPU)")
    if X.dtype not in _SYMBOLS or Z.dtype != X.dtype:
        raise TypeError(f"rbf_kernel_matrix takes float64 or float32, got "
                        f"{X.dtype} and {Z.dtype}")
    if X.dim() != 2 or Z.dim() != 2 or X.shape[1] != Z.shape[1]:
        raise ValueError(f"shapes {tuple(X.shape)} and {tuple(Z.shape)}: "
                         "want (n, d) and (m, d)")
    if _tile not in _TILES:
        raise ValueError(f"_tile must be one of {_TILES}, got {_tile}")
    n, d = X.shape
    m = Z.shape[0]
    if max(n, m, d) >= 2 ** 31:
        raise ValueError("rbf_kernel_matrix takes n, m, d below 2**31")
    X, Z = X.contiguous(), Z.contiguous()
    xn = torch.sum(X * X, -1)
    zn = torch.sum(Z * Z, -1)
    out = torch.empty((n, m), dtype=X.dtype, device=X.device)
    fn = _build.entry("rbf", _SYMBOLS[X.dtype], _P, _P, _P, _P, _P, _I, _I,
                      _I, ctypes.c_double, _I, _P)
    err = fn(X.data_ptr(), Z.data_ptr(), xn.data_ptr(), zn.data_ptr(),
             out.data_ptr(), n, m, d, float(gamma), _tile,
             _build.stream_ptr(X))
    _build.check(err, "rbf_kernel_matrix")
    rbf_kernel_matrix.launches += 1
    return out


rbf_kernel_matrix.launches = 0
