"""Model assembly for the decoder LMs: a ``Transformer`` module over an
``nn.ModuleList`` of blocks (RMS norm, mixer, RMS norm, gated MLP or
MoE), the full forward, the cache and one-token decode. Mirrors
``src/repro/models/transformer.py`` for the llama-family plan
``[GQA + dense] * L``, DeepSeek's ``[MLA + dense] * k + [MLA + MoE] *
(L - k)``, Jamba's hybrid period-8 blocks (mamba everywhere but one
NoPE GQA layer at offset 4, MoE on every second layer) and xLSTM's
``[mlstm, slstm] * L/2`` mixer-only blocks (``mlp="none"``: ``x +
mixer(norm(x))``); the reference's ``lax.scan`` over stacked layers is a
Python loop over the list.

``layer_plan`` is kept as the reference computes it, so that
``repro_torch.convert`` can unstack the reference's scanned stages. The
mixers ``attn`` (GQA), ``mla``, ``mamba``, ``mlstm`` and ``slstm`` and the
MLPs ``dense``, ``moe`` and ``none`` are ported: any other layer spec
(cross-attention) raises and names ROADMAP, as do enc-dec and modality
frontends.

The port's parameter tree is the reference's with the stages unstacked:
``{"embed": {"table"}, "final_norm": {"scale"}, "layers": [{"ln1",
"mixer", "ln2", "mlp" or "moe"} (no "ln2" and no MLP for "none"), ...],
"lm_head": {"table"}, "mtp":
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
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
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


#: the ported mixers' parameter definitions
_MIXER_DEFS = {"attn": attn_mod.gqa_def, "mla": attn_mod.mla_def,
               "mamba": ssm_mod.mamba_def, "mlstm": xlstm_mod.mlstm_def,
               "slstm": xlstm_mod.slstm_def}


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer not in _MIXER_DEFS \
            or spec.mlp not in ("dense", "moe", "none") or spec.cross:
        raise NotImplementedError(
            f"layer {spec}: only GQA, MLA, mamba, mLSTM or sLSTM mixers with "
            "a dense, MoE or no MLP are ported (ROADMAP.md, Queue 1 item 12 "
            "lists enc-dec)")


# ---------------------------------------------------------- param trees ----

def _layer_def(spec: LayerSpec, cfg):
    _check_spec(spec)
    d = {"ln1": rmsnorm_def(cfg.d_model),
         "mixer": _MIXER_DEFS[spec.mixer](cfg)}
    if spec.mlp == "moe":
        d["ln2"] = rmsnorm_def(cfg.d_model)
        d["moe"] = moe_mod.experts_def(cfg)
    elif spec.mlp == "dense":
        d["ln2"] = rmsnorm_def(cfg.d_model)
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
    if spec.mixer == "mamba":
        return ssm_mod.mamba_cache_def(cfg, batch)
    if spec.mixer == "mlstm":
        return xlstm_mod.mlstm_cache_def(cfg, batch)
    if spec.mixer == "slstm":
        return xlstm_mod.slstm_cache_def(cfg, batch)
    if spec.mixer == "mla":
        return attn_mod.mla_cache_def(cfg, batch, max_len)
    return attn_mod.gqa_cache_def(cfg, batch, max_len)


def cache_def(cfg, batch, max_len):
    """Per layer: {'k', 'v'} (batch, max_len, KV, Dh) for GQA, {'c'
    (batch, max_len, kv_lora_rank), 'kr' (batch, max_len, qk_rope_dim)}
    for MLA, {'conv' (batch, Cv - 1, Din), 'ssm' (batch, Din, St),
    float32 whatever the cache's dtype} for mamba, {'C' (batch, H, dh, dh),
    'n' (batch, H, dh), 'm' (batch, H), all float32} for mLSTM, {'c', 'n',
    'h', 'm'} (batch, d), h in the cache's dtype and the others float32,
    for sLSTM."""
    return {"layers": [_layer_cache_def(s, cfg, batch, max_len)
                       for s in _layer_specs(cfg)]}


def init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device=None):
    """A zeroed cache, preallocated at ``max_len`` rows (attention) and in
    ``dtype`` but for the leaves that name their own (mamba's and xLSTM's
    float32 states); decode writes into it in place."""
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


class Mamba(ParamModule):
    """The selective SSM mixer (``ssm.py``); positions and the decode step
    do not enter it: its cache is its state."""

    def __init__(self, tensors, cfg, window=None):
        super().__init__(tensors)
        self.cfg = cfg

    def forward(self, x, positions=None, cache=None, step=None):
        return ssm_mod.mamba_apply(self, x, self.cfg, cache=cache)


class MLSTM(Mamba):
    """The mLSTM mixer (``xlstm.py``); its cache is its (C, n, m) state."""

    def forward(self, x, positions=None, cache=None, step=None):
        return xlstm_mod.mlstm_apply(self, x, self.cfg, cache=cache)


class SLSTM(Mamba):
    """The sLSTM mixer (``xlstm.py``); its cache is its (c, n, h, m)
    carry. Its four gate weights wz, wi, wf, wo are its parameters, the
    one state; their GEMM reads them as one (D, 4 D) tensor ``w4``, built
    from them (at construction they are its column blocks) and built anew
    the first time it is read after a gate is replaced (``.to()``,
    ``.float()``) or written in place through its parameter
    (``load_state_dict``), so a decode step reads one prebuilt weight."""

    def __init__(self, tensors, cfg, window=None):
        w4 = xlstm_mod.slstm_gate_weight(tensors)
        D = cfg.d_model
        views = {k: w4[:, i * D:(i + 1) * D]
                 for i, k in enumerate(xlstm_mod.SLSTM_GATES)}
        super().__init__({**tensors, **views}, cfg)
        self._w4 = (*self._gate_key(), w4)

    def _gate_key(self) -> tuple:
        """Each gate parameter's address, version, dtype and device (a
        replaced or rewritten gate changes them), and the gates' tensors,
        held so that no other tensor can take a held address."""
        gates = tuple(self[k].detach() for k in xlstm_mod.SLSTM_GATES)
        return tuple((t.data_ptr(), 0 if t.is_inference() else t._version,
                      t.dtype, t.device) for t in gates), gates

    @property
    def w4(self):
        """[wz | wi | wf | wo] as the parameters hold them now."""
        key, gates = self._gate_key()
        if self._w4[0] != key:
            self._w4 = (key, gates, xlstm_mod.slstm_gate_weight(self))
        return self._w4[2]

    def forward(self, x, positions=None, cache=None, step=None):
        return xlstm_mod.slstm_apply(self, x, self.cfg, cache=cache,
                                     w4=self.w4)


#: layer spec mixer -> its module
_MIXERS = {"attn": Attention, "mla": MLA, "mamba": Mamba, "mlstm": MLSTM,
           "slstm": SLSTM}


class Block(nn.Module):
    """``x + mixer(norm(x))``, then ``x + mlp(norm(x))`` (or the MoE's; an
    xLSTM block has neither); returns (x, cache, the MoE's aux loss or
    None)."""

    def __init__(self, p, spec: LayerSpec, cfg):
        super().__init__()
        _check_spec(spec)
        self.ln1 = RMSNorm(p["ln1"], cfg.norm_eps)
        self.mixer = _MIXERS[spec.mixer](p["mixer"], cfg, spec.window)
        if spec.mlp != "none":
            self.ln2 = RMSNorm(p["ln2"], cfg.norm_eps)
        if spec.mlp == "moe":
            self.moe = MoE(p["moe"], cfg)
        elif spec.mlp == "dense":
            self.mlp = MLP(p["mlp"], cfg.act)

    def forward(self, x, positions, cache=None, step=None):
        mix, cache = self.mixer(self.ln1(x), positions, cache, step)
        x = x + mix
        if hasattr(self, "moe"):
            y, aux = self.moe(self.ln2(x))
            return x + y, cache, aux
        if hasattr(self, "mlp"):
            return x + self.mlp(self.ln2(x)), cache, None
        return x, cache, None


class Transformer(nn.Module):
    """A decoder LM over the port's parameter tree (see the module
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
    already filled). Hands each layer its own cache, whatever its keys:
    attention writes its k and v (MLA: its latent and rope key) in place at
    ``step``, mamba advances its conv window and state in place; returns
    (logits (B,1,V), cache). An MoE layer routes the call's B tokens, its
    capacity set by them."""
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
