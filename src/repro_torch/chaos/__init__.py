"""Chaos-injection subsystem (the port of `repro/chaos`): deterministic,
seeded fault schedules and the injectors that apply them to live
train/serve runs of the port."""
from .faults import (apply_ckpt_fault, bitflip_leaf, drop_leaf,
                     drop_manifest, tear_leaf)
from .inject import (CapacityReturnCallback, ChaosCallback,
                     make_chaos_on_restart, slow_prefill)
from .schedule import ChaosSchedule, FaultEvent

__all__ = [
    "CapacityReturnCallback", "ChaosCallback", "ChaosSchedule",
    "FaultEvent", "apply_ckpt_fault", "bitflip_leaf", "drop_leaf",
    "drop_manifest", "make_chaos_on_restart", "slow_prefill", "tear_leaf",
]
