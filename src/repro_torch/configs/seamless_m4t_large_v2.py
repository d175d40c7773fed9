"""seamless-m4t-large-v2 [audio, enc-dec] (arXiv:2308.11596). 24L encoder +
24L decoder, d_model=1024 16H (kv=16) d_ff=8192 vocab=256206. The speech
frontend (w2v-BERT conformer stack) is a STUB per the brief: input_specs()
delivers precomputed frame embeddings [B, frames, 1024]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab_size=256_206, head_dim=64,
    is_encoder_decoder=True, n_encoder_layers=24,
    frontend="audio", frontend_dim=1024,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-reduced", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=257, head_dim=16,
        is_encoder_decoder=True, n_encoder_layers=2,
        frontend="audio", frontend_dim=64,
    )
