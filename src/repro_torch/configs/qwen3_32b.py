"""qwen3-32b [dense] (hf:Qwen/Qwen3-32B). 64L d_model=5120 64H (GQA kv=8)
d_ff=25600 vocab=151936, qk-norm, head_dim=128 (q-dim 8192 != d_model)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
    vocab_size=151_936, head_dim=128,
    qk_norm=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=192,
        vocab_size=257, head_dim=16,
        qk_norm=True,
    )
