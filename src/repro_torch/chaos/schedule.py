"""Deterministic chaos schedules (a copy of `repro/chaos/schedule.py`).

A `ChaosSchedule` is a seeded, pre-generated list of `FaultEvent`s — the
generalization of `runtime.monitor.FailureInjector`'s fixed step set to
every fault class the stack recovers from. Determinism is the whole
point: the same (seed, steps, kinds) always yields the same faults in
the same order, so a chaos run that trips an invariant is replayable
bit-for-bit, and CI can pin a seed known to exercise every class.

Fault classes (`ChaosSchedule.KINDS`):

    node_loss          participant gone mid-run  -> NodeLossError
    straggler          persistent slow node      -> monitor flag -> restart
    sigterm            preemption notice         -> SIGTERM to own pid
    comm_spike         interconnect latency      -> DelayedCombineStream.comm_delay
    ckpt_bitflip       silent corruption         -> crc32 mismatch on restore
    ckpt_torn          torn write                -> unreadable leaf .npy
    ckpt_drop_leaf     lost leaf file            -> missing leaf
    ckpt_drop_manifest lost manifest             -> step invisible to restore
    slow_prefill       serve-side slow prefill   -> deadline pressure
    page_exhaustion    KV pool pressure          -> pressure ladder / preempt
    reload_corrupt     corrupt newest ckpt       -> hot-reload last-good fallback

The schedule only *describes* faults; `repro_torch.chaos.inject`
applies the train-side ones through the Callback protocol and
`repro_torch.chaos.faults` mutates checkpoint bytes on disk.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fire at `step`, of class `kind`, with an
    optional magnitude `arg` (seconds for latency-type faults)."""
    step: int
    kind: str
    arg: float = 0.0


class ChaosSchedule:
    """An ordered, consumable fault schedule (events pop when applied)."""

    KINDS: Tuple[str, ...] = (
        "node_loss", "straggler", "sigterm", "comm_spike",
        "ckpt_bitflip", "ckpt_torn", "ckpt_drop_leaf",
        "ckpt_drop_manifest", "slow_prefill", "page_exhaustion",
        "reload_corrupt")

    def __init__(self, events: Sequence[FaultEvent] = ()):
        for e in events:
            if e.kind not in self.KINDS:
                raise ValueError(f"unknown fault kind {e.kind!r} "
                                 f"(known: {', '.join(self.KINDS)})")
        self._events: List[FaultEvent] = sorted(events,
                                                key=lambda e: e.step)
        self.applied: List[FaultEvent] = []

    # --------------------------------------------------------------- build
    @classmethod
    def generate(cls, seed: int, steps: int, *,
                 kinds: Optional[Sequence[str]] = None,
                 rate: float = 0.05, min_step: int = 1,
                 max_arg_s: float = 0.05) -> "ChaosSchedule":
        """Seeded random schedule: each step in [min_step, steps) draws a
        fault with probability `rate`, uniform over `kinds` (default: all
        classes), latency args uniform in (0, max_arg_s]. Pure function
        of its arguments — RandomState, not the global generator."""
        kinds = tuple(kinds) if kinds is not None else cls.KINDS
        for k in kinds:
            if k not in cls.KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        rng = np.random.RandomState(seed)
        events = []
        for step in range(min_step, steps):
            if rng.rand() < rate:
                kind = kinds[rng.randint(len(kinds))]
                arg = float(rng.uniform(0.0, max_arg_s))
                events.append(FaultEvent(step, kind, arg))
        return cls(events)

    # ------------------------------------------------------------- consume
    def at(self, step: int,
           kinds: Optional[Sequence[str]] = None) -> List[FaultEvent]:
        """Pop (and return) every event scheduled at exactly `step`,
        optionally restricted to `kinds`."""
        hit, rest = [], []
        for e in self._events:
            if e.step == step and (kinds is None or e.kind in kinds):
                hit.append(e)
            else:
                rest.append(e)
        self._events = rest
        self.applied += hit
        return hit

    def take(self, kinds: Sequence[str]) -> List[FaultEvent]:
        """Pop every event of the given kinds regardless of step — for
        consumers that fire at boundaries (restart hooks) rather than on
        a step counter."""
        hit, rest = [], []
        for e in self._events:
            (hit if e.kind in kinds else rest).append(e)
        self._events = rest
        self.applied += hit
        return hit

    def take_one(self, kinds: Sequence[str]) -> Optional[FaultEvent]:
        """Pop the earliest-scheduled event of the given kinds, if any."""
        for i, e in enumerate(self._events):
            if e.kind in kinds:
                del self._events[i]
                self.applied.append(e)
                return e
        return None

    def pending(self) -> List[FaultEvent]:
        """Events not yet consumed."""
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)
