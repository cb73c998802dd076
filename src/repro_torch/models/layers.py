"""Core layers: RMS norm, embeddings, the gated MLP and rotary embeddings.
Mirrors ``src/repro/models/layers.py`` (standard RoPE, and none for
``rope_kind="none"``, Jamba's NoPE attention; M-RoPE waits with qwen2-vl,
ROADMAP Queue 1 item 12), in the reference's rounding order:

* ``rmsnorm`` in float32, then cast back to x's dtype;
* RoPE's cos and sin computed in float32 and cast to x's dtype before the
  rotation;
* ``gelu`` is the tanh approximation (``jax.nn.gelu``'s default);
* no embedding scale (the reference's ``embed`` has none).

Each function takes its parameters as a mapping (``params["scale"]``), as
the reference takes its dicts; the modules of ``transformer.py`` are such
mappings. The reference's sharding constraints are no-ops without a mesh
and are dropped: the port runs on one card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef


# ---------------------------------------------------------------- norms ----

def rmsnorm_def(dim):
    return {"scale": ParamDef((dim,), ("embed_act",), init="ones")}


def rmsnorm(params, x, eps=1e-6):
    xf = x.float()
    var = torch.mean(torch.square(xf), -1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ----------------------------------------------------------- embeddings ----

def embedding_def(vocab, dim):
    return {"table": ParamDef((vocab, dim), ("vocab", "embed"), scale=1.0)}


def embed(params, tokens):
    return params["table"][tokens]


def unembed(params, x):
    """Logits ``einsum("bsd,vd->bsv")`` in x's dtype."""
    return x @ params["table"].T


# ------------------------------------------------------------------ MLP ----

def mlp_def(dim, hidden):
    return {
        "wi_gate": ParamDef((dim, hidden), ("embed", "mlp")),
        "wi_up": ParamDef((dim, hidden), ("embed", "mlp")),
        "wo": ParamDef((hidden, dim), ("mlp", "embed_tp")),
    }


def mlp(params, x, act="silu"):
    a = x @ params["wi_gate"]
    b = x @ params["wi_up"]
    h = (F.silu(a) if act == "silu" else F.gelu(a, approximate="tanh")) * b
    return h @ params["wo"]


# ----------------------------------------------------------------- RoPE ----

def _rot(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def rope(x, positions, theta=10_000.0):
    """x: (B, S, H, D); positions: (B, S) int."""
    half = x.shape[-1] // 2
    # a Python-float base: no host-to-device copy (which would sync)
    inv = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=x.device) / half)
    freqs = positions.float()[..., None] * inv                  # (B,S,half)
    cos = torch.cos(freqs)[:, :, None, :].to(x.dtype)
    sin = torch.sin(freqs)[:, :, None, :].to(x.dtype)
    return _rot(x, cos, sin)


def apply_rope(x, positions, cfg):
    if cfg.rope_kind == "none" or positions is None:  # Jamba: NoPE attention
        return x
    if cfg.rope_kind == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP.md, "
                                  "Queue 1 item 12: it waits with qwen2-vl)")
    return rope(x, positions, cfg.rope_theta)
