"""Mixture-of-Experts, sort-based. Mirrors ``src/repro/models/moe.py``'s
scatter form (``_moe_scatter``): token->expert assignments are sorted
(stable, as ``jnp.argsort``), each slot's position within its expert comes
from ``searchsorted`` over the sorted stream, slots past the capacity go to
a dump row with weight 0, and the kept tokens are scattered into a dense
(experts, capacity + 1, d) buffer that feeds one batched GEMM per expert
weight (``torch.bmm``). So the port drops exactly the slots the reference
drops. The capacity is ``int(capacity_factor * N * k / E + 1)`` for the
call's N tokens, a host number from shapes: dispatch and combine make no
host sync.

The combine sums each token's k weighted expert outputs in one fixed
order, the reference's: its slots in sorted order (ascending expert), left
to right from zero, which is what the reference's ``.at[tok].add`` gives
on the CPU (``tests/test_torch_deepseek.py``). No atomic ``index_add_``: its
order, and so its rounding, would change from run to run on the card.

``cfg.moe_impl="shard_map"`` is the reference's expert-parallel form over a
mesh; without one it falls back to this scatter form. The port runs on one
card, with no mesh, so it always runs scatter; the shard_map form waits
for the distribution entry of ROADMAP.md, Queue 1 item 12.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import mlp
from repro_torch.models.params import ParamDef


def router_def(cfg):
    return {"w": ParamDef((cfg.d_model, cfg.n_experts), ("embed", "experts"),
                          scale=0.02)}


def experts_def(cfg):
    D, F_, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {
        "router": router_def(cfg),
        "wi_gate": ParamDef((E, D, F_), ("experts", "embed", "exp_mlp")),
        "wi_up": ParamDef((E, D, F_), ("experts", "embed", "exp_mlp")),
        "wo": ParamDef((E, F_, D), ("experts", "exp_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        Fs = F_ * cfg.n_shared_experts
        p["shared"] = {
            "wi_gate": ParamDef((D, Fs), ("embed", "mlp")),
            "wi_up": ParamDef((D, Fs), ("embed", "mlp")),
            "wo": ParamDef((Fs, D), ("mlp", "embed_tp")),
        }
    return p


def _route(params, x2, cfg):
    """x2: (N, D) -> (weights (N, k) float32, experts (N, k), logits
    (N, E) float32). softmax (v2 / jamba) or sigmoid (v3) scores in
    float32, their top k renormalised to sum to 1 (+1e-9)."""
    logits = (x2 @ params["router"]["w"]).float()
    if cfg.router_kind == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, -1)
    w, e = torch.topk(scores, cfg.top_k, dim=-1)
    w = w / (torch.sum(w, -1, keepdim=True) + 1e-9)
    return w, e, logits


def _aux_loss(logits, experts, cfg):
    """Switch-style load-balancing loss (fraction-dispatched x mean-prob)."""
    probs = torch.softmax(logits, -1)
    me = torch.mean(probs, 0)
    ce = torch.mean(F.one_hot(experts[:, 0], cfg.n_experts).float(), 0)
    return cfg.n_experts * torch.sum(me * ce)


def capacity(cfg, n_tokens: int) -> int:
    """Slots an expert keeps for a call of ``n_tokens`` tokens."""
    return int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts
               + 1)


def _dispatch(e, n_experts: int, cap: int):
    """The slots of the (N, k) assignments ``e`` in sorted order: (order
    (the flat slot of each sorted one), its expert, its token, its row in
    the buffer (``cap``, the dump row, past the capacity), whether it is
    kept)."""
    N, k = e.shape
    e_flat = e.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    tok = order // k
    start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=e.device))
    pos = torch.arange(N * k, device=e.device) - start[sorted_e]
    keep = pos < cap
    return order, sorted_e, tok, torch.where(keep, pos, cap), keep


def _combine(out, w, order, sorted_e, pos_c, keep):
    """(N, D): each token's kept expert outputs ``out[e, row]`` times their
    weights, summed in the slots' sorted order from zero."""
    N, k = w.shape
    gathered = out[sorted_e, pos_c]                       # (N*k, D)
    w_flat = w.reshape(-1)[order].to(out.dtype)
    contrib = gathered * torch.where(keep, w_flat, 0.0)[:, None]
    # each token's slots by sorted position: its k sorted indices, ascending
    rank = torch.empty_like(order)
    rank[order] = torch.arange(N * k, device=order.device)
    slots = torch.sort(rank.reshape(N, k), dim=1).values
    y = torch.zeros((N, out.shape[-1]), dtype=out.dtype, device=out.device)
    for j in range(k):
        y = y + contrib[slots[:, j]]
    return y


def moe_apply(params, x, cfg, act="silu"):
    """x: (B, S, D) -> (y, aux_loss). Always the scatter form (see the
    module docstring)."""
    return _moe_scatter(params, x, cfg, act)


def _moe_scatter(params, x, cfg, act="silu"):
    """Sort-based capacity packing into an (E, cap + 1, D) buffer, the
    expert GEMMs as batched products over it, the weighted combine, and
    the shared experts' MLP added."""
    B, S, D = x.shape
    N = B * S
    cap = capacity(cfg, N)
    x2 = x.reshape(N, D)
    w, e, logits = _route(params, x2, cfg)
    aux = _aux_loss(logits, e, cfg)
    order, sorted_e, tok, pos_c, keep = _dispatch(e, cfg.n_experts, cap)
    buf = x.new_zeros((cfg.n_experts, cap + 1, D))
    buf[sorted_e, pos_c] = x2[tok]
    h_g = torch.bmm(buf, params["wi_gate"])
    h_u = torch.bmm(buf, params["wi_up"])
    h = (F.silu(h_g) if act == "silu"
         else F.gelu(h_g, approximate="tanh")) * h_u
    out = torch.bmm(h, params["wo"])
    y = _combine(out, w, order, sorted_e, pos_c, keep).reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], x, act=act)
    return y, aux
