"""rwkv6-7b "Finch" [ssm, attention-free] (arXiv:2404.05892). 32L
d_model=4096 d_ff=14336 vocab=65536, data-dependent per-channel decay,
head size 64 (64 heads). Constant-memory decode state -> runs the
long_500k shape natively."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=14336,
    vocab_size=65_536, attn_type="none",
    rwkv_head_dim=64, rwkv_decay_lora=64,
    max_seq_len=524_288,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-reduced", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=192,
        vocab_size=257, attn_type="none",
        rwkv_head_dim=16, rwkv_decay_lora=8,
    )
