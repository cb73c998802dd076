"""Gemma-7B [arXiv:2403.08295; hf]. 28L, d=3072, 16H MHA (kv=16),
head_dim=256, GeGLU ffn 24576, vocab 256000, tied embeddings. Mirrors
``src/repro/configs/gemma_7b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense", n_layers=28, d_model=3072, n_heads=16,
    n_kv_heads=16, d_ff=24576, vocab_size=256_000, head_dim=256, act="gelu",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                       d_ff=128, vocab_size=512, head_dim=16)
