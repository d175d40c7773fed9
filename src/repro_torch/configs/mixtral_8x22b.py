"""mixtral-8x22b [moe] (arXiv:2401.04088). 56L d_model=6144 48H (GQA kv=8)
per-expert d_ff=16384 vocab=32768, 8 experts top-2, sliding-window
attention (window 4096 as in the Mistral lineage). Experts are
TP-partitioned on the hidden dim (8 experts don't divide a 16-way model
axis)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32_768, head_dim=128,
    sliding_window=4096,
    n_experts=8, n_experts_per_tok=2, moe_d_ff=16384,
    expert_partition="hidden",
    max_seq_len=524_288,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=257, head_dim=16, sliding_window=32,
        n_experts=4, n_experts_per_tok=2, moe_d_ff=128,
        expert_partition="hidden",
    )
