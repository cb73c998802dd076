"""Mamba-1 selective SSM block (Jamba's mixer). Mirrors
``src/repro/models/ssm.py``, in the reference's rounding order: every
projection, the causal depthwise convolution, ``silu``, ``softplus``, the
skip ``xc * D`` and the gate in x's dtype, A and the state in float32.

The reference runs the selective scan as a chunked linear recurrence (a
``lax.scan`` over chunks of 256 steps, each composed by an associative
scan) and materialises four (B, S, Din, St) float32 tensors on the way. The
port hands u, dt, A, B and C to ``ops.selective_scan``: one launch of the
hand-written kernel a layer on the card (the state in registers, nothing
of those tensors in memory), its plain version (a float32 loop over t) on
the CPU.

Prefill (``cache`` None) returns no state, as the reference's does. Decode
reads the cache's ``conv`` window (the last Cv - 1 inputs, in the cache's
dtype) and ``ssm`` state (float32 in any cache) and writes both back in
place, the contract of GQA's and MLA's caches; its scan is one launch with
the state as both ``h0`` and ``h_out``. The convolution is the reference's
Cv shifted products summed in order i = 0..Cv-1, not ``F.conv1d`` (which
on the card runs float32 through cuDNN in TF32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.params import ParamDef


def mamba_def(cfg):
    D = cfg.d_model
    Din = cfg.mamba_expand * D
    St, Cv = cfg.mamba_d_state, cfg.mamba_d_conv
    dt_rank = max(D // 16, 1)
    return {
        "in_proj": ParamDef((D, 2 * Din), ("embed", "mlp")),
        "conv_w": ParamDef((Cv, Din), ("conv", "heads_act"), scale=0.5),
        "conv_b": ParamDef((Din,), ("heads_act",), init="zeros"),
        "x_db": ParamDef((Din, dt_rank + 2 * St), ("mlp", None)),
        "dt_proj_w": ParamDef((dt_rank, Din), (None, "mlp"), scale=0.1),
        "dt_proj_b": ParamDef((Din,), ("heads_act",), init="ones"),
        "A_log": ParamDef((Din, St), ("heads_act", "state"), init="ones"),
        "D": ParamDef((Din,), ("heads_act",), init="ones"),
        "out_proj": ParamDef((Din, D), ("mlp", "embed_tp")),
    }


def mamba_cache_def(cfg, batch):
    """{'conv' (batch, Cv - 1, Din) in the cache's dtype, 'ssm' (batch,
    Din, St) float32}."""
    Din = cfg.mamba_expand * cfg.d_model
    return {"conv": ParamDef((batch, cfg.mamba_d_conv - 1, Din),
                             ("batch", None, "heads_act"), init="zeros"),
            "ssm": ParamDef((batch, Din, cfg.mamba_d_state),
                            ("batch", "heads_act", "state"), init="zeros",
                            dtype="float32")}


def mamba_apply(params, x, cfg, cache=None):
    """x: (B, S, D) -> (out (B, S, D), cache). Prefill: ``cache`` None, and
    None is returned. Decode: ``cache`` {'conv', 'ssm'}; this call's S
    tokens (one, as the reference serves) advance both in place, and the
    same cache is returned."""
    B, S, D = x.shape
    Din = cfg.mamba_expand * D
    St, Cv = cfg.mamba_d_state, cfg.mamba_d_conv
    dt_rank = max(D // 16, 1)

    xz = x @ params["in_proj"]
    xin, z = xz[..., :Din], xz[..., Din:]

    # -- causal depthwise conv (width Cv) --
    if cache is None:
        xpad = F.pad(xin, (0, 0, Cv - 1, 0))
    else:
        xpad = torch.cat([cache["conv"], xin], 1)
    w = params["conv_w"]
    xc = xpad[:, 0:S] * w[0]
    for i in range(1, Cv):
        xc = xc + xpad[:, i:i + S] * w[i]
    xc = F.silu(xc + params["conv_b"])

    # -- selective parameters --
    dbc = xc @ params["x_db"]
    # fresh buffers: a contiguous view of dbc (B = S = 1) would start
    # dt_rank elements in, off the kernel's 16-byte alignment
    Bp, Cp = (t.clone(memory_format=torch.contiguous_format)
              for t in dbc[..., dt_rank:].split(St, -1))
    dt = F.softplus(dbc[..., :dt_rank] @ params["dt_proj_w"]
                    + params["dt_proj_b"])
    A = -torch.exp(params["A_log"].float())

    if cache is None:
        y = ops.selective_scan(xc, dt, A, Bp, Cp)
    else:
        y = ops.selective_scan(xc, dt, A, Bp, Cp, h0=cache["ssm"],
                               h_out=cache["ssm"])
        cache["conv"].copy_(xpad[:, -(Cv - 1):])
    y = y + xc * params["D"]
    y = y * F.silu(z)
    return y @ params["out_proj"], cache
