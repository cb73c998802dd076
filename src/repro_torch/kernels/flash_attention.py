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
v's head dim may be narrower than q's and k's: each route is built for
the (q/k head dim, v head dim) pairs in ``PAIRS``, the equal pairs and
DeepSeek MLA's (192, 128); the scale is 1/sqrt(q's head dim).

Three routes (``route``): bfloat16 at (64, 64), (128, 128), (256, 256) and
(192, 128) runs on wgmma with TMA-fed tiles; bfloat16 at (16, 16) and
(32, 32) on ``mma.sync``; float32 on FMA. ``flash_attention.launches``
counts every launch, ``flash_attention.route_launches`` each route's and
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
_EQUAL = tuple((d, d) for d in (16, 32, 64, 128, 256))
#: route -> the (q/k head dim, v head dim) pairs its kernel is built for.
#: A bf16 tile's 128-byte swizzled panel is 64 columns, so heads narrower
#: than a panel stay on mma.sync; (192, 128) is DeepSeek's MLA prefill
PAIRS = {"fma": _EQUAL + ((192, 128),),
         "mma": _EQUAL,
         "wgmma": ((64, 64), (128, 128), (256, 256), (192, 128))}


def route(dtype, D: int, Dv: int | None = None) -> str | None:
    """The kernel that (dtype, q/k head dim ``D``, v head dim ``Dv``,
    default ``D``) launches: "wgmma", "mma" or "fma"; None where no route
    is built for the pair."""
    pair = (D, D if Dv is None else Dv)
    if dtype == torch.float32:
        return "fma" if pair in PAIRS["fma"] else None
    if dtype == torch.bfloat16:
        for path in ("wgmma", "mma"):
            if pair in PAIRS[path]:
                return path
    return None


def _rows_aligned(t) -> bool:
    """Every (b, h, s) row of ``t`` starts on 16 bytes, d contiguous, and
    every stride is positive (what a TMA tensor map takes)."""
    step = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and s % step == 0 for s in t.stride()[:3]))


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    _route=None):
    """q (B, H, S, DQK), k (B, KV, T, DQK) and v (B, KV, T, DV), KV
    dividing H -> (B, H, S, DV). ``causal`` masks keys after the query's
    position, ``window`` (a positive int) keys at or before
    ``s - window``. ``_route`` overrides ``route`` for bf16 ("wgmma" or
    "mma", where that route is built for the pair), to check and time the
    routes against each other."""
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
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}: want "
                         "(B, H, S, DQK), (B, KV, T, DQK) and (B, KV, T, DV)")
    B, H, S, D = q.shape
    KV, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (KV must divide H)")
    path = route(q.dtype, D, Dv)
    if path is None:
        built = PAIRS["fma"] if q.dtype == torch.float32 \
            else sorted(set(PAIRS["mma"] + PAIRS["wgmma"]))
        raise ValueError(f"flash_attention: no {q.dtype} kernel for head "
                         f"dims ({D}, {Dv}); built for {built}")
    if window is not None and T < S:
        # a row past T could then see no key at all
        raise ValueError("flash_attention: a window needs T >= S")
    if B * H >= 2 ** 16 or max(S, T) >= 2 ** 31:
        raise ValueError("flash_attention: B*H must be below 2**16 and S, "
                         "T below 2**31")
    if _route is not None:
        if q.dtype != torch.bfloat16 or _route not in ("wgmma", "mma") \
                or (D, Dv) not in PAIRS[_route]:
            raise ValueError(f"flash_attention: no route {_route!r} for "
                             f"{q.dtype} at head dims ({D}, {Dv})")
        path = _route
    q, k, v = (t if _rows_aligned(t) else t.contiguous() for t in (q, k, v))
    # the output in q's order of (b, h, s) strides, v's head dim
    order = sorted(range(3), key=q.stride, reverse=True)
    out = q.new_empty([(B, H, S)[i] for i in order] + [Dv]).permute(
        *(order.index(i) for i in range(3)), 3)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _build.entry("flash_attention", _SYMBOLS[path], _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
             KV, S, T, D, Dv, ctypes.addressof(strides), int(bool(causal)),
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
