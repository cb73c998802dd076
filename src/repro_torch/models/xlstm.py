"""xLSTM blocks: mLSTM (matrix memory, exp gating) and sLSTM (scalar
memory). Mirrors ``src/repro/models/xlstm.py``, in the reference's
rounding order: every projection in x's dtype, the gates' exponents and
the recurrent states float32.

mLSTM's prefill is the reference's parallel stabilized form: its
projections and gates are plain matmuls, and the (S, S) part goes to
``ops.mlstm_parallel`` (one launch of the hand-written kernel a layer on
the card, which never materialises the reference's (B, S, S, H) tensors;
its plain version on the CPU). Its decode is the reference's recurrent
(C, n, m) update in torch ops. sLSTM's input projections do not depend
on h, so one GEMM computes all four for every step (its weight built once
a module), and the recurrence
runs in ``ops.slstm_scan``: one launch a layer in prefill (from the zero
carry) and in decode (S = 1, the cache as both carry in and carry out).

Prefill (``cache`` None) returns no state, as the reference's does.
Decode writes every leaf of its cache in place (mLSTM's C, n, m; sLSTM's
c, n, h, m), the contract of the other caches; the states are float32 in
any cache, sLSTM's h in the cache's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import log_sigmoid_ref, mlstm_scale
from repro_torch.models.params import ParamDef

# ------------------------------------------------------------- mLSTM -------


def mlstm_def(cfg):
    D, H = cfg.d_model, cfg.n_heads
    Din = 2 * D
    dh = Din // H
    return {
        "up": ParamDef((D, 2 * Din), ("embed", "mlp")),
        "wq": ParamDef((Din, H, dh), ("mlp", "heads", None)),
        "wk": ParamDef((Din, H, dh), ("mlp", "heads", None)),
        "wv": ParamDef((Din, H, dh), ("mlp", "heads", None)),
        "wi": ParamDef((Din, H), ("mlp", "heads"), scale=0.02),
        "wf": ParamDef((Din, H), ("mlp", "heads"), scale=0.02),
        "bf": ParamDef((H,), ("heads",), init="ones"),
        "bi": ParamDef((H,), ("heads",), init="zeros"),
        "down": ParamDef((Din, D), ("mlp", "embed_tp")),
    }


def mlstm_cache_def(cfg, batch):
    """{'C' (batch, H, dh, dh), 'n' (batch, H, dh), 'm' (batch, H)}, all
    float32 whatever the cache's dtype."""
    H = cfg.n_heads
    dh = 2 * cfg.d_model // H
    return {"C": ParamDef((batch, H, dh, dh), ("batch", "heads", None, None),
                          init="zeros", dtype="float32"),
            "n": ParamDef((batch, H, dh), ("batch", "heads", None),
                          init="zeros", dtype="float32"),
            "m": ParamDef((batch, H), ("batch", "heads"), init="zeros",
                          dtype="float32")}


def mlstm_apply(params, x, cfg, cache=None):
    """x: (B, S, D) -> (out (B, S, D), cache). Prefill: ``cache`` None (one
    ``mlstm_parallel`` launch), and None is returned. Decode: ``cache``
    {'C', 'n', 'm'}; this call's one token advances it in place, and the
    same cache is returned."""
    B, S, D = x.shape
    H = cfg.n_heads
    Din = 2 * D
    dh = Din // H
    up = x @ params["up"]
    xin, z = up[..., :Din], up[..., Din:]
    q, k, v = ((xin @ params[w].reshape(Din, H * dh)).view(B, S, H, dh)
               for w in ("wq", "wk", "wv"))
    logi = (xin @ params["wi"] + params["bi"]).float()
    logf = log_sigmoid_ref((xin @ params["wf"] + params["bf"]).float())

    if cache is None:
        h = ops.mlstm_parallel(q, k, v, logi, logf)
    else:
        # the recurrent update (S == 1), scaled in float32
        C, n, m0 = cache["C"], cache["n"], cache["m"]
        li, lf = logi[:, 0], logf[:, 0]
        m1 = torch.maximum(lf + m0, li)
        a = torch.exp(lf + m0 - m1)[..., None, None]
        b = torch.exp(li - m1)[..., None, None]
        k0, v0 = k[:, 0].float(), v[:, 0].float()
        kv = k0[..., :, None] * v0[..., None, :]
        C.mul_(a).add_(b * kv)
        n.mul_(a[..., 0]).add_(b[..., 0] * k0)
        m0.copy_(m1)
        qs = q[:, 0].float() * mlstm_scale(dh, torch.float32)
        num = torch.einsum("bhkv,bhk->bhv", C, qs)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qs).abs(),
                            torch.exp(-m1))
        h = (num / den[..., None]).to(x.dtype)[:, None]
    h = h.reshape(B, S, Din) * F.silu(z)
    return h @ params["down"], cache


# ------------------------------------------------------------- sLSTM -------

def slstm_def(cfg):
    D = cfg.d_model
    return {
        "wz": ParamDef((D, D), ("embed", "mlp")),
        "wi": ParamDef((D, D), ("embed", "mlp"), scale=0.02),
        "wf": ParamDef((D, D), ("embed", "mlp"), scale=0.02),
        "wo": ParamDef((D, D), ("embed", "mlp")),
        "rz": ParamDef((D, D), ("mlp", "mlp"), scale=0.02),
        "bf": ParamDef((D,), ("heads_act",), init="ones"),
        "out": ParamDef((D, D), ("mlp", "embed_tp")),
    }


def slstm_cache_def(cfg, batch):
    """{'c', 'n', 'h', 'm'} (batch, D): h in the cache's dtype, the others
    float32."""
    D = cfg.d_model
    return {"c": ParamDef((batch, D), ("batch", "mlp"), init="zeros",
                          dtype="float32"),
            "n": ParamDef((batch, D), ("batch", "mlp"), init="zeros",
                          dtype="float32"),
            "h": ParamDef((batch, D), ("batch", "mlp"), init="zeros"),
            "m": ParamDef((batch, D), ("batch", "mlp"), init="zeros",
                          dtype="float32")}


#: sLSTM's input projections, in the order of their one GEMM's columns
SLSTM_GATES = ("wz", "wi", "wf", "wo")


def slstm_gate_weight(params):
    """[wz | wi | wf | wo] (D, 4 D): the weight of the four input
    projections' one GEMM."""
    return torch.cat([params[k] for k in SLSTM_GATES], dim=1)


def slstm_apply(params, x, cfg, cache=None, w4=None):
    """x: (B, S, D) -> (out (B, S, D), cache). The four input projections
    in one GEMM by ``w4``, ``slstm_gate_weight(params)`` (built here when
    not given; the ``SLSTM`` module builds it once), then one
    ``slstm_scan`` launch: from the zero carry in prefill (``cache`` None;
    None is returned), from the cache's {'c', 'n', 'h', 'm'} in decode,
    which it advances in place and returns."""
    D = x.shape[-1]
    if w4 is None:
        w4 = slstm_gate_weight(params)
    gz, gi, gf, go = (x @ w4).split(D, dim=-1)
    if cache is None:
        h = ops.slstm_scan(gz, gi, gf, go, params["rz"], params["bf"])
    else:
        carry = (cache["c"], cache["n"], cache["h"], cache["m"])
        h = ops.slstm_scan(gz, gi, gf, go, params["rz"], params["bf"],
                           carry=carry, carry_out=carry)
    return h @ params["out"], cache
