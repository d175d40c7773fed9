"""llava-next-34b [vlm] — Nous-Hermes-2-Yi-34B backbone
(hf:llava-hf/llava-v1.6-34b-hf). 60L d_model=7168 56H (GQA kv=8)
d_ff=20480 vocab=64000. The vision tower (anyres tiling) is a STUB:
input_specs() delivers precomputed patch embeddings [B, 576, 1024]
projected by the standard 2-layer MLP connector."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab_size=64_000, head_dim=128,
    frontend="vision", frontend_dim=1024, frontend_tokens=576,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llava-reduced", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=257, head_dim=16,
        frontend="vision", frontend_dim=32, frontend_tokens=8,
    )
