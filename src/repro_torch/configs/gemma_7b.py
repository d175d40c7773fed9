"""gemma-7b [dense] (arXiv:2403.08295). 28L d_model=3072 16H (kv=16, i.e.
MHA at 7B; the 2B sibling uses MQA) d_ff=24576 GeGLU, head_dim=256,
vocab=256000, tied embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, d_ff=24576,
    vocab_size=256_000, head_dim=256,
    mlp_type="geglu", tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=257, head_dim=32,
        mlp_type="geglu", tie_embeddings=True,
    )
