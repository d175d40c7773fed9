"""Architecture configs: every preset of the JAX package (+ registry)."""
from .base import (ARCH_IDS, ModelConfig, canonical,
                   get_config, get_reduced, pad_heads_for_tp)
