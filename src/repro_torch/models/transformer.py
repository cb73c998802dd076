"""Model assembly for the decoder LMs: a ``Transformer`` module over an
``nn.ModuleList`` of blocks (RMS norm, attention, RMS norm, gated MLP or
MoE), the full forward, the KV cache and one-token decode. Mirrors
``src/repro/models/transformer.py`` for the llama-family plan
``[GQA + dense] * L`` and DeepSeek's ``[MLA + dense] * k + [MLA + MoE] *
(L - k)``; the reference's ``lax.scan`` over stacked layers is a Python
loop over the list.

``layer_plan`` is kept as the reference computes it, so that
``repro_torch.convert`` can unstack the reference's scanned stages. The
mixers ``attn`` (GQA) and ``mla`` and the MLPs ``dense`` and ``moe`` are
ported: any other layer spec (mamba, xLSTM, cross-attention) raises and
names ROADMAP, as do enc-dec and modality frontends.

The port's parameter tree is the reference's with the stages unstacked:
``{"embed": {"table"}, "final_norm": {"scale"}, "layers": [{"ln1",
"mixer", "ln2", "mlp" or "moe"}, ...], "lm_head": {"table"}, "mtp":
{...}}`` (no ``lm_head`` with tied embeddings; ``mtp``, DeepSeek-V3's
multi-token-prediction head, where ``mtp_depth`` is set), every weight in
the reference's layout. The module's parameter names are the same paths
(``layers.0.mixer.wq``, ``layers.3.moe.router.w``). The MTP head's weights
are held and counted; its forward, which only training reads, waits for
training (ROADMAP.md, Queue 1 item 12).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (embed, embedding_def, mlp, mlp_def,
                                       rmsnorm, rmsnorm_def, unembed)
from repro_torch.models.params import ParamDef, count_from_defs, init_params


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str                # attn | mla | mamba | mlstm | slstm
    mlp: str                  # dense | moe | none
    window: int | None = None
    cross: bool = False       # enc-dec decoder layers


# ------------------------------------------------------------- planning ----

def _layer_specs(cfg) -> list[LayerSpec]:
    specs = []
    for i in range(cfg.n_layers):
        if cfg.block_kinds is not None:
            mixer = cfg.block_kinds[i % len(cfg.block_kinds)]
        elif cfg.attn_every > 1:
            mixer = ("mla" if cfg.attn_kind == "mla" else "attn") \
                if i % cfg.attn_every == cfg.attn_offset else "mamba"
        else:
            mixer = "mla" if cfg.attn_kind == "mla" else "attn"
        if cfg.d_ff == 0 and cfg.n_experts == 0:
            m = "none"
        elif cfg.n_experts and i >= cfg.first_dense_layers \
                and i % cfg.moe_every == cfg.moe_offset:
            m = "moe"
        else:
            m = "dense"
        w = None
        if cfg.window_pattern is not None:
            w = cfg.window_pattern[i % len(cfg.window_pattern)]
        specs.append(LayerSpec(mixer=mixer, mlp=m, window=w,
                               cross=cfg.is_encoder_decoder))
    return specs


def layer_plan(cfg) -> list[tuple[tuple[LayerSpec, ...], int]]:
    """The reference's stages: (pattern, repeat) pairs covering the layers,
    a repeated pattern stacked along a leading axis of its parameters."""
    specs = _layer_specs(cfg)
    L = len(specs)
    stages, i = [], 0
    while i < L:
        best = (1, 1)
        for p in (1, 2, 3, 4, 6, 8):
            if i + p > L:
                break
            pat = specs[i:i + p]
            r = 1
            while i + (r + 1) * p <= L and specs[i + r * p: i + (r + 1) * p] == pat:
                r += 1
            if (p == 1 or r >= 2) and p * r > best[0] * best[1]:
                best = (p, r)
        p, r = best
        stages.append((tuple(specs[i:i + p]), r))
        i += p * r
    return stages


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer not in ("attn", "mla") or spec.mlp not in ("dense", "moe") \
            or spec.cross:
        raise NotImplementedError(
            f"layer {spec}: only GQA or MLA attention with a dense or MoE "
            "MLP is ported (ROADMAP.md, Queue 1 item 12 lists mamba, xLSTM "
            "and enc-dec)")


# ---------------------------------------------------------- param trees ----

def _layer_def(spec: LayerSpec, cfg):
    _check_spec(spec)
    d = {"ln1": rmsnorm_def(cfg.d_model),
         "mixer": attn_mod.mla_def(cfg) if spec.mixer == "mla"
         else attn_mod.gqa_def(cfg),
         "ln2": rmsnorm_def(cfg.d_model)}
    if spec.mlp == "moe":
        d["moe"] = moe_mod.experts_def(cfg)
    else:
        d["mlp"] = mlp_def(cfg.d_model, cfg.d_ff)
    return d


def model_params_def(cfg):
    """The port's ``ParamDef`` tree (layers unstacked)."""
    if cfg.is_encoder_decoder or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: enc-dec and modality frontends are not ported yet "
            "(ROADMAP.md, Queue 1 item 12)")
    defs = {
        "embed": embedding_def(cfg.vocab_size, cfg.d_model),
        "final_norm": rmsnorm_def(cfg.d_model),
        "layers": [_layer_def(s, cfg) for s in _layer_specs(cfg)],
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = {"table": ParamDef(
            (cfg.vocab_size, cfg.d_model), ("vocab", "embed"), scale=0.02)}
    if cfg.mtp_depth:
        defs["mtp"] = {
            "proj": ParamDef((2 * cfg.d_model, cfg.d_model),
                             ("embed", "embed_tp")),
            "block": _layer_def(LayerSpec(
                "mla" if cfg.attn_kind == "mla" else "attn", "dense"),
                cfg.replace(n_experts=0)),
            "norm": rmsnorm_def(cfg.d_model),
        }
    return defs


def _layer_cache_def(spec: LayerSpec, cfg, batch, max_len):
    _check_spec(spec)
    if spec.mixer == "mla":
        return attn_mod.mla_cache_def(cfg, batch, max_len)
    return attn_mod.gqa_cache_def(cfg, batch, max_len)


def cache_def(cfg, batch, max_len):
    """Per layer: {'k', 'v'} (batch, max_len, KV, Dh) for GQA, {'c'
    (batch, max_len, kv_lora_rank), 'kr' (batch, max_len, qk_rope_dim)}
    for MLA."""
    return {"layers": [_layer_cache_def(s, cfg, batch, max_len)
                       for s in _layer_specs(cfg)]}


def init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device=None):
    """A zeroed KV cache, preallocated at ``max_len`` rows; decode writes
    into it in place."""
    dev = resolve_device(device)
    return init_params(cache_def(cfg, batch, max_len),
                       torch.Generator(device=dev), dtype, dev)


# -------------------------------------------------------------- modules ----

class ParamModule(nn.Module):
    """A module whose parameters are the given tensors (no copy, no
    gradient), a nested dict a submodule of its own, readable as
    ``module["name"]`` like the reference's dicts."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            if isinstance(t, dict):
                self.add_module(name, ParamModule(t))
            else:
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name):
        return getattr(self, name)


class RMSNorm(ParamModule):
    def __init__(self, tensors, eps):
        super().__init__(tensors)
        self.eps = eps

    def forward(self, x):
        return rmsnorm(self, x, self.eps)


class MLP(ParamModule):
    def __init__(self, tensors, act):
        super().__init__(tensors)
        self.act = act

    def forward(self, x):
        return mlp(self, x, act=self.act)


class MoE(ParamModule):
    """The routed experts (``moe.py``) and the shared ones; returns
    (y, aux_loss)."""

    def __init__(self, tensors, cfg):
        super().__init__(tensors)
        self.cfg = cfg

    def forward(self, x):
        return moe_mod.moe_apply(self, x, self.cfg, act=self.cfg.act)


class Attention(ParamModule):
    def __init__(self, tensors, cfg, window):
        super().__init__(tensors)
        self.cfg, self.window = cfg, window

    def forward(self, x, positions, cache=None, step=None):
        return attn_mod.gqa_apply(self, x, positions, self.cfg,
                                  window=self.window, cache=cache, step=step)


class MLA(Attention):
    def forward(self, x, positions, cache=None, step=None):
        return attn_mod.mla_apply(self, x, positions, self.cfg,
                                  window=self.window, cache=cache, step=step)


class Block(nn.Module):
    """``x + attn(norm(x))``, then ``x + mlp(norm(x))`` (or the MoE's);
    returns (x, cache, the MoE's aux loss or None)."""

    def __init__(self, p, spec: LayerSpec, cfg):
        super().__init__()
        _check_spec(spec)
        self.ln1 = RMSNorm(p["ln1"], cfg.norm_eps)
        self.mixer = (MLA if spec.mixer == "mla" else Attention)(
            p["mixer"], cfg, spec.window)
        self.ln2 = RMSNorm(p["ln2"], cfg.norm_eps)
        if spec.mlp == "moe":
            self.moe = MoE(p["moe"], cfg)
        else:
            self.mlp = MLP(p["mlp"], cfg.act)

    def forward(self, x, positions, cache=None, step=None):
        mix, cache = self.mixer(self.ln1(x), positions, cache, step)
        x = x + mix
        if hasattr(self, "moe"):
            y, aux = self.moe(self.ln2(x))
            return x + y, cache, aux
        return x + self.mlp(self.ln2(x)), cache, None


class Transformer(nn.Module):
    """A dense decoder LM over the port's parameter tree (see the module
    docstring); its device and dtype are those of the tensors given."""

    def __init__(self, cfg, params):
        super().__init__()
        self.cfg = cfg
        self.embed = ParamModule(params["embed"])
        self.layers = nn.ModuleList(
            Block(p, s, cfg) for p, s in zip(params["layers"],
                                             _layer_specs(cfg), strict=True))
        self.final_norm = RMSNorm(params["final_norm"], cfg.norm_eps)
        self.lm_head = None if cfg.tie_embeddings \
            else ParamModule(params["lm_head"])
        # held and counted; only training reads it (``forward``)
        self.mtp = ParamModule(params["mtp"]) if cfg.mtp_depth else None

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def logits(self, x):
        h = self.final_norm(x)
        return unembed(self.embed if self.cfg.tie_embeddings
                       else self.lm_head, h)


def init_model(cfg, *, seed: int = 0, dtype=torch.bfloat16,
               device=None) -> Transformer:
    """A ``Transformer`` with parameters drawn by the reference's init
    rules from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Transformer(cfg, init_params(model_params_def(cfg), gen, dtype,
                                        dev))


# -------------------------------------------------------------- forward ----

@torch.inference_mode()
def forward(model: Transformer, batch, mode="train"):
    """batch: tokens (B,S). Returns (logits, {"aux_loss": the MoE layers'
    load-balancing losses summed, float32}). ``mode="prefill"`` keeps the
    last position's logits only. ``mode="train"`` on a model with an MTP
    head raises: the reference's train forward adds the MTP logits, which
    wait for training (ROADMAP.md, Queue 1 item 12)."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode must be 'train' or 'prefill', got {mode!r}")
    if mode == "train" and model.cfg.mtp_depth:
        raise NotImplementedError(
            f"{model.cfg.name}: the multi-token-prediction forward waits for "
            "training (ROADMAP.md, Queue 1 item 12); serve with "
            "mode='prefill'")
    dev = model.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    B, S = tokens.shape
    x = embed(model.embed, tokens)
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for block in model.layers:
        x, _, a = block(x, positions)
        if a is not None:
            aux = aux + a
    if mode == "prefill":      # serving prefill: last-position logits only
        x = x[:, -1:]
    return model.logits(x), {"aux_loss": aux}


@torch.inference_mode()
def decode_step(model: Transformer, cache, batch):
    """One-token decode. batch: tokens (B,1), step (an int: the cache rows
    already filled). Writes each layer's k and v (MLA: its latent and rope
    key) into ``cache`` in place at ``step``; returns (logits (B,1,V),
    cache). An MoE layer routes the call's B tokens, its capacity set by
    them."""
    dev = model.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    B, S = tokens.shape
    step = int(batch["step"])
    x = embed(model.embed, tokens)
    positions = torch.full((B, S), step, dtype=torch.int64, device=dev)
    for block, c in zip(model.layers, cache["layers"], strict=True):
        x, _, _ = block(x, positions, cache=c, step=step)
    return model.logits(x), cache


# ------------------------------------------------------------- counting ----

def count_params(cfg) -> int:
    return count_from_defs(model_params_def(cfg))


def active_params(cfg) -> int:
    """Active parameters per token (MoE: top_k + shared experts only), the
    reference's count."""
    total = count_params(cfg)
    if not cfg.n_experts:
        return total
    n_moe = sum(1 for s in _layer_specs(cfg) if s.mlp == "moe")
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    return total - n_moe * (cfg.n_experts - cfg.top_k) * per_expert
