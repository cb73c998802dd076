"""Granite-8B-code [arXiv:2405.04324; hf]. Llama-arch: 36L, d=4096, 32H,
kv=8, ffn 14336, vocab 49152. Mirrors ``src/repro/configs/granite_8b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense", n_layers=36, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab_size=49_152, head_dim=128,
    rope_theta=10_000_000.0,
)

SMOKE = CONFIG.replace(n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
                       d_ff=128, vocab_size=512, head_dim=16)
