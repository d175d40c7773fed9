"""Architecture config schema + registry (the port's copy of
`repro/configs/base.py`).

The dataclass is field-for-field the JAX package's, so a config means
the same model in both. The registry serves every preset the JAX
package has: the dense GQA decoders (`qwen3_32b`, `minitron_4b`,
`gemma_7b`), MLA (`minicpm3_4b`), MoE (`mixtral_8x22b`,
`moonshot_v1_16b_a3b`), the SSM (`rwkv6_7b`), the hybrid
(`hymba_1p5b`), the vision frontend (`llava_next_34b`) and the
encoder-decoder (`seamless_m4t_large_v2`).
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // n_heads

    # ---- attention variants ----
    attn_type: str = "gqa"        # gqa | mla | none
    qk_norm: bool = False         # qwen3
    sliding_window: int = 0       # 0 = full attention
    rope_theta: float = 10_000.0
    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- MLP ----
    mlp_type: str = "swiglu"      # swiglu | geglu

    # ---- MoE ----
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    moe_d_ff: int = 0             # per-expert hidden (defaults to d_ff)
    capacity_factor: float = 1.25
    expert_partition: str = "expert"   # expert | hidden (TP axis placement)

    # ---- SSM / hybrid ----
    ssm_state: int = 0            # mamba N (hymba) / rwkv head size
    ssm_heads: int = 0            # 0 => derived
    ssm_conv: int = 4             # conv window (mamba)
    # rwkv6
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32

    # ---- encoder-decoder (seamless) ----
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # ---- modality frontend stubs ----
    frontend: str = "none"        # none | vision | audio
    frontend_dim: int = 0         # embedding dim delivered by the stub
    frontend_tokens: int = 0      # #frontend positions in train seq

    # ---- misc ----
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 32_768
    orig_heads: int = 0     # >0 => q heads beyond this are TP padding
                            # (their wo rows are zero-init: exact math)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.attn_type == "none"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long-context (500k) decode? True for
        attention-free, hybrid-with-SWA and SWA archs."""
        return self.attention_free or self.family in ("ssm", "hybrid") or \
            self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count, from the port's own model API."""
        from repro_torch.models import api
        return api.count_params(self)


def pad_heads_for_tp(cfg: ModelConfig, tp: int) -> ModelConfig:
    """TP head alignment, exact math (the port's copy of the reference's,
    configs/base.py:102-128): kv heads are block-duplicated by the least
    factor making kv % tp == 0 (duplicated keys and values attend
    identically, so the GQA q -> kv map is kept); q heads are padded up
    to the next multiple of tp that the new kv count divides, and a
    padded head's wo rows are zero, so it adds exactly nothing. MLA and
    attention-free configs are returned as they are."""
    if tp <= 1 or cfg.attention_free or cfg.attn_type == "mla":
        return cfg
    h, kv = cfg.n_heads, cfg.n_kv_heads
    kv2 = kv * (tp // math.gcd(kv, tp))
    h2 = h
    while h2 % tp or h2 % kv2:
        h2 += 1
    if (h2, kv2) == (h, kv):
        return cfg
    return dataclasses.replace(cfg, n_heads=h2, n_kv_heads=kv2,
                               orig_heads=cfg.orig_heads or h)


ARCH_IDS: Tuple[str, ...] = (
    "hymba_1p5b", "moonshot_v1_16b_a3b", "mixtral_8x22b", "llava_next_34b",
    "gemma_7b", "minitron_4b", "minicpm3_4b", "qwen3_32b",
    "seamless_m4t_large_v2", "rwkv6_7b",
)

# canonical external ids (with dashes) -> module names
_ALIASES = {
    "hymba-1.5b": "hymba_1p5b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "llava-next-34b": "llava_next_34b",
    "gemma-7b": "gemma_7b",
    "minitron-4b": "minitron_4b",
    "minicpm3-4b": "minicpm3_4b",
    "qwen3-32b": "qwen3_32b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "rwkv6-7b": "rwkv6_7b",
}


def canonical(arch: str) -> str:
    return _ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))


def _module(arch: str):
    name = canonical(arch)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()

