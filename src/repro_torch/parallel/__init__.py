"""Run policy (the port's copy of `repro/parallel/policy.py`)."""
from .policy import RunPolicy
