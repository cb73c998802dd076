"""RBF kernel matrix on the card: the counterpart of
``src/repro/kernels/rbf.py`` (Pallas ``rbf_kernel_matrix``), built from
``csrc/rbf.cu``.

On a CUDA tensor the wrapper launches a hand-written kernel or raises; on a
CPU tensor it runs the plain PyTorch version, ``ref.rbf_kernel_matrix_ref``.
Two routes (``ROUTES``), counted in ``rbf_kernel_matrix.route_launches``:

* ``tensor``, every float64 build: the cross term on the FP64 tensor cores,
  a persistent grid of square output tiles (``tensor_tile`` picks the edge
  from the tiles each SM gets). Where Z is X (``same_operand``: the SVM
  paths pass X twice, or two equal slices of it) only the tiles on and
  above the diagonal are computed, each written twice.
* ``fma``, every float32 build: the cross term on the FMA pipes, in full
  float32 (the TPU kernel accumulates f32 in f32; nothing rounds to TF32).
  For float64 it is the tensor route's witness: forced with
  ``_route="fma"``, it gives the same bits.

A failed build or launch raises; no route stands in for another.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rbf_kernel_matrix_ref
from repro_torch.kernels.smo_chunk import pad_rows

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SYMBOLS = {torch.float64: "rbf_kernel_matrix_f64",
            torch.float32: "rbf_kernel_matrix_f32"}
ROUTES = ("tensor", "fma")
#: output tile edges of the FMA kernel (64 is its default)
FMA_TILES = (64, 32)
#: output tile edges of the tensor-core kernel, largest first
TENSOR_TILES = (128, 64, 32)
#: tiles an SM from which a larger tile pays: below it the last wave's
#: imbalance and each tile's fill and drain show (fitted to
#: ``chip_smoke.py``'s tile sweep on an H100 at even n, between K(X, X) at
#: 1,000 rows, fastest at tile 32 though tile 64 gives 1.03 tiles an SM,
#: and distinct operands at 1,000 and 2,000 rows, fastest at tiles 64 and
#: 128 with 1.94 an SM; an odd m, whose rows of K take 8-byte stores,
#: favours smaller tiles)
TILES_PER_SM = 1.5
#: outputs from which the tensor route pads rows of an odd d to 16-byte
#: boundaries (``smo_chunk.pad_rows``), so that the kernel copies 16 bytes
#: at a time, not 8: a 2,048^2 K, between Table 1's, where the copy's two
#: launches would outweigh the gain, and the paper's n = 32,560
PAD_MIN_OUTPUTS = 1 << 22


def same_operand(X, Z) -> bool:
    """Whether Z is X for the kernel: one dtype, device, shape, strides and
    data pointer (``X, X`` and two equal slices ``X[:n], X[:n]`` are; a
    copy is not)."""
    return (X.dtype == Z.dtype and X.device == Z.device
            and X.shape == Z.shape and X.stride() == Z.stride()
            and X.data_ptr() == Z.data_ptr())


def tensor_tiles(n: int, m: int, sym: bool, tile: int) -> int:
    """Output tiles of an (n, m) K at a tile edge: for K(X, X), those on
    and above the diagonal."""
    tn, tm = -(-n // tile), -(-m // tile)
    return tm * (tm + 1) // 2 if sym else tn * tm


def tensor_tile(n: int, m: int, sym: bool, sms: int) -> int:
    """The tensor route's tile edge for an (n, m) K: the largest of
    ``TENSOR_TILES`` that gives each of the card's ``sms`` SMs
    ``TILES_PER_SM`` tiles or more, else the smallest."""
    for tile in TENSOR_TILES:
        if tensor_tiles(n, m, sym, tile) >= TILES_PER_SM * sms:
            return tile
    return TENSOR_TILES[-1]


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def rbf_kernel_matrix(X, Z, gamma: float, *, _route: str | None = None,
                      _tile: int | None = None):
    """K[i,j] = exp(-gamma * ||X_i - Z_j||^2); X (n,d), Z (m,d) -> (n,m).

    ``_route`` and ``_tile`` (private: the checks and the card's sweeps set
    them) force a route (``tensor`` takes float64 only) and its output
    tile's edge (one of ``FMA_TILES`` or ``TENSOR_TILES``). Every route and
    tile sums each dot product in the same order, so the results are
    identical.
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
    route = _route or ("tensor" if X.dtype == torch.float64 else "fma")
    if route not in ROUTES or (route == "tensor"
                               and X.dtype != torch.float64):
        raise ValueError(f"route {route!r} for {X.dtype}: the tensor route "
                         "takes float64, the fma route either")
    tiles = TENSOR_TILES if route == "tensor" else FMA_TILES
    if _tile is not None and _tile not in tiles:
        raise ValueError(f"_tile must be one of {tiles}, got {_tile}")
    n, d = X.shape
    m = Z.shape[0]
    if max(n, m, d) >= 2 ** 31:
        raise ValueError("rbf_kernel_matrix takes n, m, d below 2**31")
    sym = same_operand(X, Z)
    X = X.contiguous()
    Z = X if sym else Z.contiguous()
    xn = torch.sum(X * X, -1)
    zn = xn if sym else torch.sum(Z * Z, -1)
    out = torch.empty((n, m), dtype=X.dtype, device=X.device)
    if route == "fma":
        fn = _build.entry("rbf", _SYMBOLS[X.dtype], _P, _P, _P, _P, _P, _I,
                          _I, _I, ctypes.c_double, _I, _P)
        err = fn(X.data_ptr(), Z.data_ptr(), xn.data_ptr(), zn.data_ptr(),
                 out.data_ptr(), n, m, d, float(gamma), _tile or FMA_TILES[0],
                 _build.stream_ptr(X))
    else:
        tile = _tile or tensor_tile(n, m, sym, _sms(X.device.index or 0))
        if d % 2 and n * m >= PAD_MIN_OUTPUTS:
            X = pad_rows(X)
            Z = X if sym else pad_rows(Z)
        fn = _build.entry("rbf", "rbf_kernel_matrix_tc_f64", _P, _P, _LL,
                          _LL, _P, _P, _P, _I, _I, _I, ctypes.c_double, _I,
                          _I, _P)
        err = fn(X.data_ptr(), Z.data_ptr(), X.stride(0), Z.stride(0),
                 xn.data_ptr(), zn.data_ptr(), out.data_ptr(), n, m, d,
                 float(gamma), tile, int(sym), _build.stream_ptr(X))
    _build.check(err, "rbf_kernel_matrix")
    rbf_kernel_matrix.launches += 1
    rbf_kernel_matrix.route_launches[route] += 1
    return out


rbf_kernel_matrix.launches = 0
rbf_kernel_matrix.route_launches = dict.fromkeys(ROUTES, 0)
