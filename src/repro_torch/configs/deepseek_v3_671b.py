"""DeepSeek-V3 671B [arXiv:2412.19437; hf]. MLA, 61L, 128H, 1 shared + 256
routed top-8 (sigmoid router), first 3 layers dense (ffn 18432), MTP depth 1,
vocab 129280. Mirrors ``src/repro/configs/deepseek_v3_671b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv_heads=128, d_ff=18432, vocab_size=129_280,
    attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
    qk_rope_dim=64, v_head_dim=128, head_dim=192,
    n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_dense_layers=3, router_kind="sigmoid", mtp_depth=1,
)

SMOKE = CONFIG.replace(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16,
    qk_rope_dim=8, v_head_dim=16, head_dim=24, n_experts=8,
    n_shared_experts=1, top_k=2, moe_d_ff=32, first_dense_layers=2,
)
