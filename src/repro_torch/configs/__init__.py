"""Architecture configs: the presets the port carries (+ registry)."""
from .base import (ARCH_IDS, PORTED_ARCH_IDS, ModelConfig, canonical,
                   get_config, get_reduced)
