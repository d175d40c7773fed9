"""Elastic restart decisions (paper §5.4) — a copy of
`repro/runtime/elastic.py`, the pure decision logic; the drivers that
rebuild sessions are `repro_torch.engine.pipeline.fit_elastic` and
`repro_torch.control.resize.fit_adaptive`.

Adasum's scale-invariance is what makes shrinking the job safe: when a
node is lost (or a persistent straggler is evicted) the run restarts at
a smaller power-of-two DP degree *with no hyperparameter change* — the
combined update stays well-conditioned at any span.

Signals:
  * `RestartSignal` — raised inside the step loop when the StepMonitor
    flags a persistent straggler and the run is elastic;
  * `NodeLossError` (monitor.py) — a participant is gone, real or
    injected by `FailureInjector`; treated identically by the driver.
"""
from __future__ import annotations

import dataclasses

from .monitor import next_power_of_two_below


class RestartSignal(Exception):
    """A flagged straggler requests an elastic restart at `step`."""

    def __init__(self, step: int, reason: str = "straggler"):
        super().__init__(f"elastic restart requested at step {step} "
                         f"({reason})")
        self.step = step
        self.reason = reason


class GrowBackSignal(Exception):
    """Capacity returned: a callback asks the elastic driver to re-expand
    the DP degree at `step` (caught by `fit_elastic`, which saves,
    rebuilds at the target DP, and resumes — LR rescaled by the AdaScale
    gain of the growth factor, per §5.4 no other hyperparameter moves)."""

    def __init__(self, step: int, target_dp: int = 0,
                 reason: str = "capacity returned"):
        super().__init__(f"elastic grow-back requested at step {step} "
                         f"({reason})")
        self.step = step
        self.target_dp = target_dp   # 0 => the run's original DP degree
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """One elastic decision: the DP degree to restart at (and, for a
    grow-back, the LR to restart with)."""
    old_dp: int
    new_dp: int
    old_lr: float = 0.0
    new_lr: float = 0.0

    @property
    def shrunk(self) -> bool:
        return self.new_dp < self.old_dp

    @property
    def grew(self) -> bool:
        return self.new_dp > self.old_dp


def plan_shrink(dp_total: int) -> ElasticPlan:
    """Halve the DP degree to the next power of two below (monitor.py's
    mitigation ladder step 3). At dp=1 there is nothing left to drop —
    the plan keeps dp=1 and the driver gives up restarting."""
    if dp_total <= 1:
        return ElasticPlan(dp_total, dp_total)
    return ElasticPlan(dp_total, next_power_of_two_below(dp_total))


def plan_grow_back(dp_total: int, target_dp: int, lr: float, *,
                   lr_scale: float = 1.0) -> ElasticPlan:
    """The reverse of `plan_shrink`, for when capacity returns: re-expand
    DP to the largest power of two <= `target_dp`. New LR = lr *
    lr_scale, where the caller computes lr_scale as the AdaScale gain of
    the growth factor from live CombineStats (1.0 with no stats — per
    §5.4 the run stays safe either way, the gain just recovers the
    larger batch's efficiency). A target at or below the current degree
    yields a no-op plan (`plan.grew` False)."""
    new_dp = 1
    while new_dp * 2 <= max(target_dp, 1):
        new_dp *= 2
    if new_dp <= dp_total:
        return ElasticPlan(dp_total, dp_total, lr, lr)
    return ElasticPlan(dp_total, new_dp, lr, float(lr * lr_scale))


# ------------------------------------------------------- planned resize
#
# The failure-shrink path above, generalized: the noise-adaptive batch
# controller (repro_torch.control) *plans* a growth — larger global batch
# and/or Adasum span, LR rescaled — and the driver executes it through
# the same save -> rebuild-from-config -> resume machinery a shrink
# uses. Adasum's scale invariance is again what makes the mid-run
# change safe: the combined update stays well-conditioned at any span.


class ResizeSignal(Exception):
    """The batch controller requests a planned resize at `step`."""

    def __init__(self, step: int, plan: "ResizePlan"):
        super().__init__(f"adaptive resize requested at step {step} "
                         f"({plan.describe()})")
        self.step = step
        self.plan = plan


@dataclasses.dataclass(frozen=True)
class ResizePlan:
    """One controller resize decision (growth or shrink), fully
    resolved: the batch/span/LR to rebuild the session with."""
    old_batch: int
    new_batch: int
    old_span: int
    new_span: int
    old_lr: float
    new_lr: float
    reason: str = "noise"

    @property
    def grew(self) -> bool:
        return (self.new_batch > self.old_batch
                or self.new_span > self.old_span)

    @property
    def shrank(self) -> bool:
        return self.new_batch < self.old_batch

    @property
    def changed(self) -> bool:
        return (self.new_batch != self.old_batch
                or self.new_span != self.old_span)

    def describe(self) -> str:
        return (f"batch {self.old_batch}->{self.new_batch}, "
                f"span {self.old_span}->{self.new_span}, "
                f"lr {self.old_lr:g}->{self.new_lr:g}, {self.reason}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def plan_grow(global_batch: int, span: int, dp_total: int, lr: float, *,
              factor: int = 2, grow_span: bool = True,
              max_global_batch: int = 0, lr_scale: float = 1.0,
              reason: str = "noise") -> ResizePlan:
    """Resolve an AdaBatch-style growth by `factor` into a concrete
    ResizePlan. Pure sizing logic:

      * new batch = factor x old, capped at `max_global_batch` (0 = no
        cap); if the cap already binds, the plan is a no-grow no-op
        (`plan.grew` False) and the driver stops resizing;
      * span grows with the batch when `grow_span`, but never past
        dp_total and always to a power-of-two divisor of it (the fused
        combine / RVH lane-count contract);
      * new lr = lr * lr_scale — the caller computes lr_scale (AdaScale
        gain for the factor, linear, or 1.0).
    """
    assert factor >= 2, factor
    new_batch = global_batch * factor
    if max_global_batch and new_batch > max_global_batch:
        new_batch = max(max_global_batch, global_batch)
    new_span = span
    if grow_span and new_batch > global_batch:
        cand = span * factor
        while cand > dp_total or (dp_total % cand) or (cand & (cand - 1)):
            cand //= 2
            if cand <= span:
                cand = span
                break
        # a lane must still hold at least one batch row
        if cand > span and new_batch % cand == 0:
            new_span = cand
    if new_batch == global_batch:
        return ResizePlan(global_batch, global_batch, span, span, lr, lr,
                          reason="capped")
    return ResizePlan(global_batch, new_batch, span, new_span, lr,
                      float(lr * lr_scale), reason=reason)


def plan_shrink_batch(global_batch: int, span: int, dp_total: int,
                      lr: float, *, factor: int = 2,
                      shrink_span: bool = True, min_global_batch: int = 0,
                      lr_scale: float = 1.0,
                      reason: str = "noise-low") -> ResizePlan:
    """`plan_grow` in reverse — the controller's shrink direction when
    the noise scale falls BELOW the hysteresis band (the batch is larger
    than the gradient noise justifies, so smaller batches buy the same
    progress per sample):

      * new batch = old // factor, floored at max(min_global_batch, 1);
      * span shrinks with it when `shrink_span` (floor 1), and the new
        batch must stay divisible by the new span (lane rows stay
        integral);
      * new lr = lr * lr_scale — the caller computes lr_scale (1/gain
        for adascale, 1/factor linear, 1.0 none).

    When the floor binds the plan is a no-change no-op (`plan.changed`
    False) and the controller stops planning shrinks.
    """
    assert factor >= 2, factor
    new_batch = global_batch // factor
    new_span = span
    if shrink_span and span > 1:
        new_span = max(1, span // factor)
    floor = max(min_global_batch, 1)
    if new_batch < floor or new_batch < new_span or new_batch % new_span:
        return ResizePlan(global_batch, global_batch, span, span, lr, lr,
                          reason="floored")
    return ResizePlan(global_batch, new_batch, span, new_span, lr,
                      float(lr * lr_scale), reason=reason)
