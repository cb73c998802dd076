"""Jamba-v0.1 52B [arXiv:2403.19887; hf]. 32L hybrid: attention every 8th
layer (offset 4, 1:7 attn:mamba), MoE (16 experts top-2) every 2nd layer
(offset 1), d=4096, 32H, kv=8, ffn 14336, vocab 65536. NoPE attention.
Mirrors ``src/repro/configs/jamba_v0_1_52b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=65_536, head_dim=128,
    rope_kind="none", attn_every=8, attn_offset=4,
    n_experts=16, top_k=2, moe_d_ff=14336, moe_every=2, moe_offset=1,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
)

SMOKE = CONFIG.replace(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab_size=512, head_dim=16, n_experts=4,
                       top_k=2, moe_d_ff=64)
