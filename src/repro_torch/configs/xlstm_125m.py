"""xLSTM-125M [arXiv:2405.04517; unverified]. 12 blocks alternating
mLSTM/sLSTM, d=768, 4H, no separate FFN (d_ff=0), vocab 50304. Mirrors
``src/repro/configs/xlstm_125m.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab_size=50_304,
    block_kinds=("mlstm", "slstm"), tie_embeddings=True,
)

SMOKE = CONFIG.replace(n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
                       vocab_size=512)
