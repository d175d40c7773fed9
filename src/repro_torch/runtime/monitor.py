"""Step-time / straggler monitoring + elastic-restart decisions (a copy
of `repro/runtime/monitor.py`; the elastic restart loop that consumes
the flag is `repro_torch.engine.pipeline.fit_elastic`).

At pod scale, synchronous SGD stalls on the slowest participant. The
mitigation ladder implemented here:
  1. gradient accumulation / local steps (paper §5.2) — fewer syncs,
     configured via RunPolicy.local_steps;
  2. detection: robust z-score of step wall-times; persistent outliers
     are flagged;
  3. elastic drop: on a flagged failure the runner checkpoints, halves
     the DP degree (power-of-two mesh), and restarts from the manifest —
     Adasum's no-hyperparameter property (paper §5.4) means the restart
     needs no LR retuning.

The FailureInjector simulates node loss for the recovery tests.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional


@dataclasses.dataclass
class StragglerConfig:
    window: int = 50
    z_threshold: float = 4.0
    min_steps: int = 10
    patience: int = 3            # consecutive outliers before flagging


class StepMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.times: Deque[float] = deque(maxlen=cfg.window)
        self._consecutive = 0
        self._last: Optional[float] = None
        self.flagged = False

    def start(self):
        self._last = time.perf_counter()

    def stop(self) -> float:
        assert self._last is not None
        dt = time.perf_counter() - self._last
        self.observe(dt)
        return dt

    def observe(self, dt: float):
        import numpy as np
        if len(self.times) >= self.cfg.min_steps:
            med = float(np.median(self.times))
            mad = float(np.median([abs(t - med) for t in self.times])) + 1e-9
            z = 0.6745 * (dt - med) / mad
            if z > self.cfg.z_threshold:
                self._consecutive += 1
                if self._consecutive >= self.cfg.patience:
                    self.flagged = True
            else:
                self._consecutive = 0
        self.times.append(dt)

    def summary(self):
        import numpy as np
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {"mean_s": float(a.mean()), "p50_s": float(np.median(a)),
                "max_s": float(a.max()), "flagged": self.flagged}


class NodeLossError(RuntimeError):
    """A participant is gone (real or injected). The elastic restart loop
    catches exactly this — a RuntimeError subclass so legacy callers
    expecting RuntimeError keep working."""


class FailureInjector:
    """Deterministic failure schedule for recovery tests: raises at the
    configured steps (simulating a lost node / preemption)."""

    def __init__(self, fail_at_steps: List[int]):
        self.fail_at = set(fail_at_steps)

    def check(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise NodeLossError(f"injected node failure at step {step}")


def next_power_of_two_below(n: int) -> int:
    p = 1
    while p * 2 < n:
        p *= 2
    return p
