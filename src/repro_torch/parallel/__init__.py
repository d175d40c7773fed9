"""Run policy (the port's copy of `repro/parallel/policy.py`), the
collectives of multi-rank training (`comm.Comm`), the sharding rules (the
port's copy of `repro/parallel/sharding.py`) and the data axis sharded
across ranks (`zero`: ZeRO-1 state, ZeRO-2 gradients, FSDP params)."""
from .policy import RunPolicy
