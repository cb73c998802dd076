"""mLSTM's parallel stabilized form on the card, built from
``csrc/mlstm.cu``: the counterpart of the reference's prefill branch
(``src/repro/models/xlstm.py:53-66``), which XLA runs as einsums over
(B, S, S, H) tensors, not Pallas. The kernel never holds (S, S): it is to
mLSTM what ``flash_attention`` is to softmax attention.

Three routes (``route``): ``wgmma`` (bfloat16 at dh = 384, xlstm-125m's:
warpgroup MMA fed by TMA rings, the score and the value products on
separate warpgroups, clusters of two blocks sharing each K and V tile),
``mma`` (bfloat16 at dh = 64, SMOKE's: ``mma.sync`` tiles of 64 query
rows and 64 keys; at dh = 64 a 64-column value tile split over two
warpgroups would give each half of a swizzled panel, and no served model
runs that width, so the wgmma route is built for 384 only) and ``fma``
(float32: the products on the CUDA cores, the checks' and tests' route).
``_route="mma"`` forces the ``mma.sync`` kernel at 384 too: the witness
and yardstick of the wgmma route. A route that cannot take the inputs
raises before any launch. On CUDA tensors the wrapper launches the kernel
(q, k, v contiguous (B, S, H, dh) in one of those dtypes, dh 64 or 384,
16-byte aligned; logi and logf (B, S, H) float32) or raises; on CPU
tensors it runs the plain version, ``ref.mlstm_parallel_ref``. F, the
cumsum of logf over S, comes from ``torch.cumsum`` here (its order of
sums is not XLA's; the tolerance covers it); the wgmma route takes F and
logi in rows padded to a multiple of 64 keys (a K tile's keys are one
bulk copy). ``mlstm_parallel.launches`` counts the launches,
``mlstm_parallel.route_launches`` by route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mlstm_parallel_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
#: (route, input dtype) -> the C entry that launches its kernel
_SYMBOLS = {("fma", torch.float32): "mlstm_parallel_f32",
            ("mma", torch.bfloat16): "mlstm_parallel_bf16",
            ("wgmma", torch.bfloat16): "mlstm_parallel_bf16_wgmma"}
#: the head dims the kernel is built for: SMOKE's 64 and xlstm-125m's 384
HEAD_DIMS = (64, 384)
#: the head dim the wgmma route is built for
WGMMA_HEAD_DIM = 384
#: the keys a wgmma K tile takes: F and logi rows are padded to it
WGMMA_KEYS = 64
#: route -> the argument types of its C entry: q, k, v, F, logi, (the
#: wgmma route: the rows' pitch,) h, B, S, H, dh, the stream
ARGTYPES = {"wgmma": (_P,) * 5 + (_I, _P) + (_I,) * 4 + (_P,),
            "mma": (_P,) * 6 + (_I,) * 4 + (_P,),
            "fma": (_P,) * 6 + (_I,) * 4 + (_P,)}


def route(dtype, dh: int) -> str:
    """The route a launch at (dtype, dh) takes."""
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if dh == WGMMA_HEAD_DIM else "mma"


def _gate_rows(logi, logf, pitch: int):
    """F (the cumsum of logf over S) and logi as (B, H, pitch) float32
    rows, each (b, h) read along S by the kernel; zeros past S."""
    S = logf.shape[1]
    rows = (torch.cumsum(logf, dim=1).transpose(1, 2), logi.transpose(1, 2))
    if pitch == S:
        return tuple(r.contiguous() for r in rows)
    return tuple(torch.nn.functional.pad(r, (0, pitch - S)) for r in rows)


def c_args(took: str, q, k, v, logi, logf, out, stream):
    """The arguments of route ``took``'s C entry (``ARGTYPES``) that
    writes h into ``out``, and the F and logi rows they point into (keep
    them alive until the launch). The wgmma route takes the rows padded to
    whole K tiles."""
    B, S, H, dh = q.shape
    pitch = -(-S // WGMMA_KEYS) * WGMMA_KEYS if took == "wgmma" else S
    F, L = _gate_rows(logi, logf, pitch)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), F.data_ptr(),
            L.data_ptr()) + ((pitch,) if took == "wgmma" else ())
    return ptrs + (out.data_ptr(), B, S, H, dh, stream), (F, L)


def mlstm_parallel(q, k, v, logi, logf, *, _route=None):
    """h (B, S, H, dh) in q's dtype: mLSTM's parallel form (see
    ``ref.mlstm_parallel_ref``) of q, k, v (B, S, H, dh) over their
    causal keys, with the input gate's logi and the forget gate's logf
    (B, S, H) float32. ``_route`` forces a route on the card (checks and
    timing)."""
    tensors = (q, k, v, logi, logf)
    if all(t.device.type == "cpu" for t in tensors):
        return mlstm_parallel_ref(q, k, v, logi, logf)
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in tensors):
        raise ValueError("mlstm_parallel: every tensor must be on one CUDA "
                         "device (or all on the CPU)")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"mlstm_parallel takes q, k and v in one of float32 "
                        f"or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if logi.dtype != torch.float32 or logf.dtype != torch.float32:
        raise TypeError("mlstm_parallel: logi and logf must be float32")
    if q.dim() != 4:
        raise ValueError(f"mlstm_parallel: q {tuple(q.shape)} is not (B, S, "
                         "H, dh)")
    B, S, H, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"mlstm_parallel: head dim {dh}; the kernel is "
                         f"built for {HEAD_DIMS}")
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape) \
            or tuple(logi.shape) != (B, S, H) \
            or tuple(logf.shape) != (B, S, H):
        raise ValueError(f"mlstm_parallel: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, logi {tuple(logi.shape)}, logf "
                         f"{tuple(logf.shape)} against q {tuple(q.shape)}")
    if not all(t.is_contiguous() for t in tensors) \
            or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("mlstm_parallel: every tensor must be contiguous, "
                         "q, k and v 16-byte aligned")
    took = route(q.dtype, dh) if _route is None else _route
    if (took, q.dtype) not in _SYMBOLS \
            or (took == "wgmma" and dh != WGMMA_HEAD_DIM):
        raise ValueError(f"mlstm_parallel: no {took!r} route for {q.dtype} "
                         f"at head dim {dh}")
    out = torch.empty_like(q)
    args, _rows = c_args(took, q, k, v, logi, logf, out,
                         _build.stream_ptr(q))
    fn = _build.entry("mlstm", _SYMBOLS[took, q.dtype], *ARGTYPES[took])
    _build.check(fn(*args), "mlstm_parallel")
    mlstm_parallel.launches += 1
    mlstm_parallel.route_launches[took] += 1
    return out


mlstm_parallel.launches = 0
mlstm_parallel.route_launches = {"wgmma": 0, "mma": 0, "fma": 0}
