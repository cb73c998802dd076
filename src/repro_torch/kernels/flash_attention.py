"""Flash attention on the card: the counterpart of
``src/repro/kernels/flash_attention.py`` (Pallas ``flash_attention``),
built from ``csrc/flash_attention.cu``.

On CUDA tensors the wrapper launches the hand-written kernel (float32 or
bfloat16) or raises; on CPU tensors it runs the plain version,
``ref.flash_attention_ref``. The kernel reads q, k and v through their
(b, h, s) strides, so a (B, S, H, D) activation passed as its
``transpose(1, 2)`` view is read in place, and the output keeps q's layout.
kv heads may be grouped: k and v carry KV heads with KV dividing H, and q
head h reads kv head ``h // (H // KV)``, so no broadcast copy is made.

Three routes (``route``): bfloat16 at head dims 64, 128 and 256 runs on
wgmma with TMA-fed tiles; bfloat16 at 16 and 32 on ``mma.sync``; float32
on FMA. ``flash_attention.launches`` counts every launch,
``flash_attention.route_launches`` each route's and
``flash_attention.window_launches`` the windowed and the global ones.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
#: route -> the C entry that launches it
_SYMBOLS = {"fma": "flash_attention_f32", "mma": "flash_attention_bf16",
            "wgmma": "flash_attention_bf16_wgmma"}
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: bf16 head dims of the wgmma route: a 128-byte swizzled panel is 64
#: columns, so narrower heads stay on mma.sync
WGMMA_HEAD_DIMS = (64, 128, 256)


def route(dtype, D: int) -> str:
    """The kernel a (dtype, head dim) launches: "wgmma", "mma" or "fma"."""
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if D in WGMMA_HEAD_DIMS else "mma"


def _rows_aligned(t) -> bool:
    """Every (b, h, s) row of ``t`` starts on 16 bytes, d contiguous, and
    every stride is positive (what a TMA tensor map takes)."""
    step = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and s % step == 0 for s in t.stride()[:3]))


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    _route=None):
    """q (B, H, S, D), k and v (B, KV, T, D), KV dividing H ->
    (B, H, S, D). ``causal`` masks keys after the query's position,
    ``window`` (a positive int) keys at or before ``s - window``.
    ``_route`` overrides ``route`` for bf16 ("wgmma" or "mma"), to check
    and time the routes against each other."""
    if window is not None and (int(window) != window or window < 1):
        raise ValueError(f"flash_attention: window must be a positive int, "
                         f"got {window}")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v on {q.device}, "
                         f"{k.device}, {v.device}: all must be on one CUDA "
                         "device (or all on the CPU)")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}: want "
                         "(B, H, S, D) and (B, KV, T, D) twice")
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (KV must divide H)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if window is not None and T < S:
        # a row past T could then see no key at all
        raise ValueError("flash_attention: a window needs T >= S")
    if B * H >= 2 ** 16 or max(S, T) >= 2 ** 31:
        raise ValueError("flash_attention: B*H must be below 2**16 and S, "
                         "T below 2**31")
    path = route(q.dtype, D)
    if _route is not None:
        if q.dtype != torch.bfloat16 or _route not in ("wgmma", "mma") \
                or (_route == "wgmma" and D not in WGMMA_HEAD_DIMS):
            raise ValueError(f"flash_attention: no route {_route!r} for "
                             f"{q.dtype} at head dim {D}")
        path = _route
    q, k, v = (t if _rows_aligned(t) else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _build.entry("flash_attention", _SYMBOLS[path], _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _P, _I, _I, _P)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
             KV, S, T, D, ctypes.addressof(strides), int(bool(causal)),
             0 if window is None else int(window), _build.stream_ptr(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.route_launches[path] += 1
    flash_attention.window_launches[
        "global" if window is None else "windowed"] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(_SYMBOLS, 0)
flash_attention.window_launches = {"windowed": 0, "global": 0}
