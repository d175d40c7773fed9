"""minitron-4b [dense] — pruned Nemotron (arXiv:2407.14679). 32L
d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=9216,
    vocab_size=256_000, head_dim=128,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minitron-reduced", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=288,
        vocab_size=257, head_dim=16,
    )
