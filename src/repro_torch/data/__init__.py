"""Deterministic data sources (the port's copy of `repro/data`)."""
from .pipeline import DataConfig, MemmapTokens, SyntheticLM, make_source
