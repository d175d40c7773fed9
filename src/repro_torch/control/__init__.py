"""CombineStats -> per-step gradient-noise metrics (the port's subset of
`repro/control`: `noise.STAT_KEYS` and `summarize_stats`)."""
from .noise import STAT_KEYS, summarize_stats
