"""Gemma3-4B [hf:google/gemma-3-4b-pt; unverified]. 34L, d=2560, 8H, kv=4,
head_dim=256, GeGLU ffn 10240, vocab 262144, 5:1 local(window 1024):global.
Mirrors ``src/repro/configs/gemma3_4b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense", n_layers=34, d_model=2560, n_heads=8,
    n_kv_heads=4, d_ff=10240, vocab_size=262_144, head_dim=256, act="gelu",
    tie_embeddings=True, rope_theta=1_000_000.0,
    window_pattern=(1024, 1024, 1024, 1024, 1024, None),
)

SMOKE = CONFIG.replace(n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab_size=512, head_dim=16,
                       window_pattern=(16, 16, 16, 16, 16, None))
