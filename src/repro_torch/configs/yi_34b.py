"""Yi-34B [arXiv:2403.04652; hf]. Llama-arch GQA: 60L, d=7168, 56H, kv=8,
ffn 20480, vocab 64000. Mirrors ``src/repro/configs/yi_34b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense", n_layers=60, d_model=7168, n_heads=56,
    n_kv_heads=8, d_ff=20480, vocab_size=64_000, head_dim=128,
    rope_theta=5_000_000.0,
)

SMOKE = CONFIG.replace(n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
                       d_ff=128, vocab_size=512, head_dim=16)
