"""DeepSeek-V2 236B [arXiv:2405.04434; hf]. MLA (kv_lora=512, q_lora=1536),
60L, 128H, MoE: 2 shared + 160 routed top-6 (moe_ffn=1536), first layer dense
(ffn 12288), vocab 102400. Mirrors
``src/repro/configs/deepseek_v2_236b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_ff=12288, vocab_size=102_400,
    attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
    qk_rope_dim=64, v_head_dim=128, head_dim=192,
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
    first_dense_layers=1, router_kind="softmax",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16,
    qk_rope_dim=8, v_head_dim=16, head_dim=24, n_experts=8,
    n_shared_experts=1, top_k=2, moe_d_ff=32, first_dense_layers=1,
)
