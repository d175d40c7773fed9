"""minicpm3-4b [dense, MLA] (hf:openbmb/MiniCPM3-4B). 62L d_model=2560
40H (kv=40 in the assignment; MLA shares a latent KV) d_ff=6400
vocab=73448. MLA dims from the HF config: q_lora=768, kv_lora=256,
qk_nope=64, qk_rope=32, v_head=64. Decode uses the absorbed-latent path
(compressed cache)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab_size=73_448, head_dim=64,
    attn_type="mla", q_lora_rank=768, kv_lora_rank=256,
    qk_rope_head_dim=32, qk_nope_head_dim=64, v_head_dim=64,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=257, head_dim=16,
        attn_type="mla", q_lora_rank=32, kv_lora_rank=16,
        qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
        tie_embeddings=True,
    )
