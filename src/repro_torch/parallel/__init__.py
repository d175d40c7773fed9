"""Run policy (the port's copy of `repro/parallel/policy.py`) and the
collectives of multi-rank training (`comm.Comm`)."""
from .policy import RunPolicy
