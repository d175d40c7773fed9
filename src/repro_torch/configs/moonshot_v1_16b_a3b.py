"""moonshot-v1-16b-a3b [moe] — Kimi/Moonlight 16B-A3B
(hf:moonshotai/Moonlight-16B-A3B, DeepSeek-V3-style MoE). 48L d_model=2048
16H (GQA kv=16) per-expert d_ff=1408 vocab=163840, 64 routed experts top-6
+ 2 shared experts, first layer dense (per the HF config)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=163_840, head_dim=128,
    n_experts=64, n_experts_per_tok=6, n_shared_experts=2,
    first_dense_layers=1, moe_d_ff=1408, expert_partition="expert",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="moonshot-reduced", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab_size=257, head_dim=16,
        n_experts=8, n_experts_per_tok=2, n_shared_experts=1,
        first_dense_layers=1, moe_d_ff=96, expert_partition="expert",
    )
