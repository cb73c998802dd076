"""Config system of the port: ``ModelConfig``, ``ShapeConfig`` and the
input-shape suite. Mirrors ``src/repro/configs/base.py`` field for field,
less the runtime options that nothing in the port reads (``remat_policy``,
``decode_kv_shard``, ``moe_impl``: rematerialisation, sharding and MoE
dispatch). The port keeps its own copy: it imports nothing of ``repro``.

``get_config`` serves the architectures whose layer kinds the port has:
the dense llama-family configs (GQA attention + dense MLP), today
``granite-8b``, ``gemma-7b``, ``yi-34b`` and ``gemma3-4b`` (whose 5:1
local:global layers take the sliding-window form), the DeepSeek configs
``deepseek-v2-236b`` and ``deepseek-v3-671b`` (MLA attention, the
sort-based MoE) and the hybrid ``jamba-v0.1-52b`` (mamba layers around a
NoPE GQA layer, the MoE on every second layer) and ``xlstm-125m``
(alternating mLSTM and sLSTM blocks, no MLP). Any other architecture
of the zoo raises and names ROADMAP, where its missing layer kinds are
queued.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None    # default d_model // n_heads
    act: str = "silu"              # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # attention
    attn_kind: str = "gqa"         # gqa | mla
    rope_theta: float = 10_000.0
    rope_kind: str = "standard"    # standard | mrope
    mrope_sections: tuple = (16, 24, 24)
    window_pattern: tuple | None = None  # e.g. gemma3: (1024,)*5 + (None,)
    attn_every: int = 1            # jamba: attention layer every Nth...
    attn_offset: int = 0           # ...at this offset (others are mamba)
    attn_logit_softcap: float | None = None
    attn_q_chunk: int | None = None  # flash-style q-chunked attention

    # MLA (deepseek)
    q_lora_rank: int | None = None
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 2
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0    # deepseek: first k layers use dense MLP
    moe_every: int = 1             # jamba: MoE replaces MLP every Nth layer
    moe_offset: int = 0
    router_kind: str = "softmax"   # softmax (v2/jamba) | sigmoid (v3)

    # SSM (mamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # xLSTM
    block_kinds: tuple | None = None   # explicit per-layer kinds override

    # enc-dec (seamless)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0

    # multi-token prediction (deepseek-v3)
    mtp_depth: int = 0

    # modality frontend stubs ([audio]/[vlm]): input_specs provides embeddings
    frontend: str | None = None    # None | "audio_frames" | "vision_patches"

    # numerics / runtime
    dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


# The input-shape suite (identical for all 10 LM archs).
SHAPES = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = (
    "deepseek-v2-236b", "deepseek-v3-671b", "yi-34b", "gemma3-4b",
    "granite-8b", "gemma-7b", "jamba-v0.1-52b", "seamless-m4t-large-v2",
    "xlstm-125m", "qwen2-vl-2b",
)
#: the architectures whose layer kinds the port has (GQA + dense MLP,
#: sliding-window layers included; MLA + MoE; mamba + GQA + MoE; mLSTM +
#: sLSTM without an MLP)
PORTED = ("granite-8b", "gemma-7b", "yi-34b", "gemma3-4b",
          "deepseek-v2-236b", "deepseek-v3-671b", "jamba-v0.1-52b",
          "xlstm-125m")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; one of {ARCH_IDS}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch}: its layer kinds are not ported yet (ROADMAP.md, Queue 1 "
            f"item 12); the port serves {PORTED}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod.SMOKE if smoke else mod.CONFIG


def list_configs():
    return PORTED
