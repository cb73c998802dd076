"""mLSTM's parallel stabilized form on the card, built from
``csrc/mlstm.cu``: the counterpart of the reference's prefill branch
(``src/repro/models/xlstm.py:53-66``), which XLA runs as einsums over
(B, S, S, H) tensors, not Pallas. The kernel never holds (S, S): it is to
mLSTM what ``flash_attention`` is to softmax attention.

Two routes: ``mma`` (bfloat16: ``mma.sync`` tiles of 64 query rows and 64
keys) and ``fma`` (float32: the products on the CUDA cores, the checks'
and tests' route). On CUDA tensors the wrapper launches the kernel
(q, k, v contiguous (B, S, H, dh) in one of those dtypes, dh 64 or 384,
16-byte aligned; logi and logf (B, S, H) float32) or raises; on CPU
tensors it runs the plain version, ``ref.mlstm_parallel_ref``. F, the
cumsum of logf over S, comes from ``torch.cumsum`` here (its order of
sums is not XLA's; the tolerance covers it). ``mlstm_parallel.launches``
counts the launches, ``mlstm_parallel.route_launches`` by route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mlstm_parallel_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
#: input dtype -> (the C entry that launches the kernel for it, its route)
_SYMBOLS = {torch.float32: ("mlstm_parallel_f32", "fma"),
            torch.bfloat16: ("mlstm_parallel_bf16", "mma")}
#: the head dims the kernel is built for: SMOKE's 64 and xlstm-125m's 384
HEAD_DIMS = (64, 384)


def mlstm_parallel(q, k, v, logi, logf):
    """h (B, S, H, dh) in q's dtype: mLSTM's parallel form (see
    ``ref.mlstm_parallel_ref``) of q, k, v (B, S, H, dh) over their
    causal keys, with the input gate's logi and the forget gate's logf
    (B, S, H) float32."""
    tensors = (q, k, v, logi, logf)
    if all(t.device.type == "cpu" for t in tensors):
        return mlstm_parallel_ref(q, k, v, logi, logf)
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in tensors):
        raise ValueError("mlstm_parallel: every tensor must be on one CUDA "
                         "device (or all on the CPU)")
    if q.dtype not in _SYMBOLS or k.dtype != q.dtype or v.dtype != q.dtype:
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
    # (B, H, S) rows of F and logi, each (b, h) read along S
    F = torch.cumsum(logf, dim=1).transpose(1, 2).contiguous()
    L = logi.transpose(1, 2).contiguous()
    out = torch.empty_like(q)
    symbol, route = _SYMBOLS[q.dtype]
    fn = _build.entry("mlstm", symbol, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _I, _P)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), F.data_ptr(),
             L.data_ptr(), out.data_ptr(), B, S, H, dh, _build.stream_ptr(q))
    _build.check(err, "mlstm_parallel")
    mlstm_parallel.launches += 1
    mlstm_parallel.route_launches[route] += 1
    return out


mlstm_parallel.launches = 0
mlstm_parallel.route_launches = {"mma": 0, "fma": 0}
