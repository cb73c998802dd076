"""Attention: grouped-query attention (GQA / MHA), its sliding-window and
q-chunked forms, DeepSeek's multi-head latent attention (MLA) with its
absorbed decode, and single-token decode against a preallocated KV cache.
Mirrors ``src/repro/models/attention.py`` for the ported configs
(granite-8b, gemma-7b, yi-34b, gemma3-4b, deepseek-v2-236b,
deepseek-v3-671b).

``sdpa``'s prefill case (no cache: ``q_offset == 0``, ``kv_len`` None, no
softcap, causal or not, with or without a window, ``T >= S``) goes through
the hand-written flash-attention kernel when the tensors are on CUDA and
the kernel is built for their dtype and (q head dim, v head dim) pair
(``repro_torch.kernels.ops.flash_attention``, the counterpart the reference
names for this path; MLA's prefill is (192, 128) at full width); it
computes the same function as the einsum form, kv head groups included. A
pair with no kernel (MLA at SMOKE width, (24, 16)) takes the einsum form.
So do the chunked forms without a softcap:
``sdpa_local_chunked`` (gemma3's local layers) is the kernel's causal
window, ``sdpa_q_chunked`` (``attn_q_chunk``) its plain causal or windowed
mask; each is one launch. Every other case (decode against the cache, a
softcap, CPU tensors) runs the reference's einsum forms, the plain versions
(``sdpa_local_chunked_plain``, ``sdpa_q_chunked_plain``). No ported config
sets a softcap.

MLA's decode is the reference's absorbed form in torch einsums (as the
reference's is XLA einsums outside any Pallas kernel): only the latent
``c`` and the rope key ``kr`` are cached, and ``w_uk`` / ``w_uv`` are
folded into the score and value products.

Not ported yet (ROADMAP.md, Queue 1 item 12): cross-attention. The
reference's sharding constraints are dropped: the port runs on one card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import route as flash_route
from repro_torch.models.layers import apply_rope, rmsnorm, rmsnorm_def
from repro_torch.models.params import ParamDef

_NEG = -1e30


def _softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap else x


# =========================================================== core maths ====

def _has_kernel(q, v) -> bool:
    """q and v on CUDA at a dtype and (q, v) head-dim pair the flash
    kernel is built for."""
    return q.is_cuda and flash_route(q.dtype, q.shape[-1],
                                     v.shape[-1]) is not None


def sdpa(q, k, v, *, causal=True, q_offset=0, window=None, softcap=None,
         kv_len=None):
    """Grouped-query attention. q: (B,S,H,D); k: (B,T,KV,D); v: (B,T,KV,Dv)
    (MLA's v is narrower than q and k) -> (B,S,H,Dv).

    ``q_offset``: absolute position of q[0] (decode: the current step).
    ``kv_len``: number of valid cache rows (decode masking).
    """
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if (q_offset == 0 and kv_len is None and not softcap and T >= S
            and _has_kernel(q, v)):
        return _flash(q, k, v, causal=causal, window=window)
    G = H // KV
    qg = q.reshape(B, S, KV, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores / math.sqrt(D)
    scores = _softcap(scores, softcap)
    qpos = torch.arange(S, device=q.device)[:, None] + q_offset
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask &= kpos < kv_len
    scores = torch.where(mask, scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, v.shape[-1])


def sdpa_q_chunked_plain(q, k, v, *, causal=True, window=None,
                         softcap=None, q_chunk=2048):
    """The reference's q-chunked form: queries in chunks of ``q_chunk``,
    each against every key (``q_offset`` its start, ``kv_len=S``), so one
    chunk's score block is live at a time. Same shapes as ``sdpa``."""
    S = q.shape[1]
    outs = [sdpa(q[:, c:c + q_chunk], k, v, causal=causal, q_offset=c,
                 window=window, softcap=softcap, kv_len=S)
            for c in range(0, S, q_chunk)]
    return torch.cat(outs, 1)


def sdpa_q_chunked(q, k, v, *, causal=True, window=None, softcap=None,
                   q_chunk=2048):
    """``sdpa_q_chunked_plain``'s function. On CUDA without a softcap it is
    one ``flash_attention`` launch with the caller's ``causal`` and
    ``window`` (the kernel keeps one tile's scores live, as the chunks do);
    with a softcap, which the kernel lacks, or on the CPU, the plain
    form (and for a head-dim pair the kernel is not built for)."""
    if not softcap and _has_kernel(q, v):
        return _flash(q, k, v, causal=causal, window=window)
    return sdpa_q_chunked_plain(q, k, v, causal=causal, window=window,
                                softcap=softcap, q_chunk=q_chunk)


def sdpa_local_chunked_plain(q, k, v, *, window, softcap=None):
    """The reference's sliding-window form, block-band-wise: each width-W
    chunk of queries attends to its own and the previous chunk only (2W
    keys), O(S*W) work; S is padded up to a multiple of W, and chunk 0 has
    no predecessor. Causal whatever the layer, as the reference's."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    W = int(window)
    if S % W:
        pad = (0, 0, 0, 0, 0, W - S % W)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    Sp = q.shape[1]
    nc = Sp // W
    G = H // KV
    qc = q.reshape(B, nc, W, KV, G, D)
    kc = k.reshape(B, nc, W, KV, D)
    vc = v.reshape(B, nc, W, KV, D)
    k2 = torch.cat([torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], 1),
                    kc], 2)
    v2 = torch.cat([torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], 1),
                    vc], 2)
    scores = torch.einsum("bcskgd,bctkd->bckgst", qc, k2).float()
    scores = _softcap(scores / math.sqrt(D), softcap)
    qpos = torch.arange(W, device=q.device)[:, None] + W
    kpos = torch.arange(2 * W, device=q.device)[None, :]
    first = torch.arange(nc, device=q.device) == 0
    mask = (kpos <= qpos) & (kpos > qpos - W)       # causal, width-W band
    mask = torch.where(first[:, None, None], mask & (kpos >= W), mask)
    scores = torch.where(mask[None, :, None, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bckgst,bctkd->bcskgd", probs, v2)
    return out.reshape(B, Sp, H, D)[:, :S]


def sdpa_local_chunked(q, k, v, *, window, softcap=None):
    """``sdpa_local_chunked_plain``'s function. On CUDA without a softcap it
    is one ``flash_attention`` launch, ``causal=True, window=W``: the
    band's mask ``kpos <= qpos, kpos > qpos - W`` is the kernel's, and the
    kernel skips the kv tiles before the band. With a softcap, or on the
    CPU, the plain form."""
    if q.is_cuda and not softcap:
        return _flash(q, k, v, causal=True, window=window)
    return sdpa_local_chunked_plain(q, k, v, window=window, softcap=softcap)


def _flash(q, k, v, *, causal, window):
    """(B,S,H,D) q, (B,T,KV,D) k and (B,T,KV,Dv) v through the kernel,
    read in place through their (b, h, s) strides; the output keeps q's
    layout."""
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window)
    return out.transpose(1, 2)


# ======================================================== GQA attention ====

def gqa_def(cfg):
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return {
        "wq": ParamDef((D, H, Dh), ("embed", "heads", None)),
        "wk": ParamDef((D, KV, Dh), ("embed", "kv_heads", None)),
        "wv": ParamDef((D, KV, Dh), ("embed", "kv_heads", None)),
        "wo": ParamDef((H, Dh, D), ("heads", None, "embed_tp")),
    }


def _proj(x, w):
    """``einsum("bsd,dhk->bshk")`` as one matmul over the flattened heads
    (the weight keeps the reference's (D, H, Dh) layout)."""
    D, H, Dh = w.shape
    return (x @ w.reshape(D, H * Dh)).unflatten(-1, (H, Dh))


def gqa_apply(params, x, positions, cfg, *, window=None, cache=None,
              step=None, causal=True):
    """Returns (out, cache). Modes:

    * train/prefill: ``cache`` None — full attention;
    * decode: ``cache`` {'k', 'v'} (B, Smax, KV, Dh) and ``step`` (an int,
      the current length): this call's k and v are written into the cache
      in place at ``step`` (the reference's ``dynamic_update_slice``) and
      the same cache is returned.
    """
    B, S, _ = x.shape
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    if cache is None:
        if window is not None and S > 2 * window:
            out = sdpa_local_chunked(q, k, v, window=window,
                                     softcap=cfg.attn_logit_softcap)
        elif cfg.attn_q_chunk and S > 2 * cfg.attn_q_chunk:
            out = sdpa_q_chunked(q, k, v, causal=causal, window=window,
                                 softcap=cfg.attn_logit_softcap,
                                 q_chunk=cfg.attn_q_chunk)
        else:
            out = sdpa(q, k, v, causal=causal, window=window,
                       softcap=cfg.attn_logit_softcap)
    else:
        step = int(step)
        if step < 0 or step + S > cache["k"].shape[1]:
            raise ValueError(f"decode step {step} + {S} token(s) outside "
                             f"the cache's {cache['k'].shape[1]} rows")
        cache["k"][:, step:step + S] = k
        cache["v"][:, step:step + S] = v
        out = sdpa(q, cache["k"], cache["v"], causal=True, q_offset=step,
                   window=window, softcap=cfg.attn_logit_softcap,
                   kv_len=step + S)
    wo = params["wo"]
    y = out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    return y, cache


def gqa_cache_def(cfg, batch, max_len):
    KV, Dh = cfg.n_kv_heads, cfg.head_dim_
    kv_axes = ("batch", "seq", "kv_heads", None)
    return {"k": ParamDef((batch, max_len, KV, Dh), kv_axes, init="zeros"),
            "v": ParamDef((batch, max_len, KV, Dh), kv_axes, init="zeros")}


# ======================================================== MLA attention ====

def mla_def(cfg):
    D, H = cfg.d_model, cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    p = {
        "w_dkv": ParamDef((D, cfg.kv_lora_rank), ("embed", "kv_lora")),
        "kv_norm": rmsnorm_def(cfg.kv_lora_rank),
        "w_kr": ParamDef((D, rope_d), ("embed", None)),
        "w_uk": ParamDef((cfg.kv_lora_rank, H, nope),
                         ("kv_lora", "heads", None)),
        "w_uv": ParamDef((cfg.kv_lora_rank, H, vd),
                         ("kv_lora", "heads", None)),
        "w_o": ParamDef((H, vd, D), ("heads", None, "embed_tp")),
    }
    if cfg.q_lora_rank:
        p["w_dq"] = ParamDef((D, cfg.q_lora_rank), ("embed", "q_lora"))
        p["q_norm"] = rmsnorm_def(cfg.q_lora_rank)
        p["w_uq"] = ParamDef((cfg.q_lora_rank, H, nope + rope_d),
                             ("q_lora", "heads", None))
    else:
        p["w_q"] = ParamDef((D, H, nope + rope_d), ("embed", "heads", None))
    return p


def _mla_q(params, x, positions, cfg):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope)), q_rope rotated."""
    nope = cfg.qk_nope_dim
    if cfg.q_lora_rank:
        qa = rmsnorm(params["q_norm"], x @ params["w_dq"], cfg.norm_eps)
        q = _proj(qa, params["w_uq"])
    else:
        q = _proj(x, params["w_q"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, apply_rope(q_rope, positions, cfg)


def mla_apply(params, x, positions, cfg, *, cache=None, step=None,
              window=None, causal=True):
    """MLA. Returns (out, cache). Modes:

    * prefill: ``cache`` None. The per-head k_nope and v are materialised
      from the latent, q and k are their nope and rope parts joined (the
      rope key broadcast across heads), and ``sdpa`` takes them: one
      flash_attention launch on the card at (192, 128).
    * decode (the reference's absorbed path): ``cache`` {'c' (B, Smax,
      kv_lora_rank), 'kr' (B, Smax, qk_rope_dim)} and ``step`` (an int):
      this call's latent and rope key are written into the cache in place
      at ``step``; the scores are ``q_nope w_uk . c + q_rope . kr`` over
      sqrt(nope + rope), the context ``probs . c`` goes through ``w_uv``
      and ``w_o``.
    """
    B, S, _ = x.shape
    q_nope, q_rope = _mla_q(params, x, positions, cfg)
    c = rmsnorm(params["kv_norm"], x @ params["w_dkv"], cfg.norm_eps)
    kr = apply_rope((x @ params["w_kr"])[:, :, None, :], positions,
                    cfg)[:, :, 0, :]
    wo = params["w_o"]
    if cache is None:
        k_nope = _proj(c, params["w_uk"])
        v = _proj(c, params["w_uv"])
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([k_nope, kr[:, :, None, :].expand(
            *k_nope.shape[:3], kr.shape[-1])], -1)
        if cfg.attn_q_chunk and S > 2 * cfg.attn_q_chunk:
            out = sdpa_q_chunked(q, k, v, causal=causal, window=window,
                                 q_chunk=cfg.attn_q_chunk)
        else:
            out = sdpa(q, k, v, causal=causal, window=window)
        return out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1]), None
    # ---------------- absorbed decode ----------------
    step = int(step)
    if step < 0 or step + S > cache["c"].shape[1]:
        raise ValueError(f"decode step {step} + {S} token(s) outside "
                         f"the cache's {cache['c'].shape[1]} rows")
    cache["c"][:, step:step + S] = c
    cache["kr"][:, step:step + S] = kr
    cc, krc = cache["c"], cache["kr"]
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"])
    scores = (torch.einsum("bshr,btr->bhst", q_abs, cc)
              + torch.einsum("bshk,btk->bhst", q_rope, krc)).float()
    scores = scores / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    T = cc.shape[1]
    kpos = torch.arange(T, device=x.device)[None, :]
    qpos = torch.arange(S, device=x.device)[:, None] + step
    mask = (kpos <= qpos) & (kpos < step + S)
    scores = torch.where(mask, scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhst,btr->bshr", probs, cc)
    out = torch.einsum("bshr,rhv->bshv", ctx, params["w_uv"])
    return out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1]), cache


def mla_cache_def(cfg, batch, max_len):
    """The absorbed decode's cache: the latent and the rope key a token."""
    return {"c": ParamDef((batch, max_len, cfg.kv_lora_rank),
                          ("batch", "seq", "kv_lora"), init="zeros"),
            "kr": ParamDef((batch, max_len, cfg.qk_rope_dim),
                           ("batch", "seq", None), init="zeros")}
