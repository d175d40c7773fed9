"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer
(arXiv:2411.13676). 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16. Most Hymba layers use sliding-window attention (global attn on
a few layers in the paper); we model the SWA regime (window 1024), which is
what makes the arch sub-quadratic for long_500k."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32001, head_dim=64,
    sliding_window=1024, ssm_state=16, ssm_heads=25, ssm_conv=4,
    max_seq_len=524_288,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hymba-reduced", family="hybrid",
        n_layers=2, d_model=80, n_heads=5, n_kv_heads=1, d_ff=160,
        vocab_size=257, head_dim=16,
        sliding_window=32, ssm_state=8, ssm_heads=5, ssm_conv=4,
    )
