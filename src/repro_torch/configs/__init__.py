"""Architecture configs: the dense presets slice 1 ports (+ registry)."""
from .base import (ARCH_IDS, PORTED_ARCH_IDS, ModelConfig, canonical,
                   get_config, get_reduced)
