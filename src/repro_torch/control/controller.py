"""The gradient-noise-adaptive batch/span controller (AdaBatch x Adasum)
— a copy of `repro/control/controller.py`.

Host-side decision logic only — no torch, no engine imports. The
controller watches the per-step `noise_scale` metric (the critical-
batch estimate `repro_torch.control.noise` derives from Adasum's free dot
products), EMA-smooths it, and decides *when* to grow through a
hysteresis band:

    grow band   : ema_noise > grow_threshold * global_batch
    reset band  : ema_noise < grow_threshold * global_batch / 2

A resize fires only after `patience` consecutive in-band steps (noise
estimates are heavy-tailed; one spike must not double the batch), then
`cooldown` steps must pass before the next decision can even start
counting — the restarted run needs time to re-equilibrate its EMA at
the new batch. Growth itself is AdaBatch-style doubling
(`grow_factor`), span riding along when it keeps a power-of-two
divisor of dp, and the LR rescaled by the AdaScale gain of the factor
(`lr_rescale='adascale'`; 'linear' and 'none' are the ablations).

The controller only *plans* (`ResizePlan`); `repro_torch.control.resize`
executes plans through the elastic save -> rebuild -> resume machinery.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.runtime.elastic import (ResizePlan, plan_grow,
                                        plan_shrink_batch)

from .noise import NoiseEMA, gain_for_factor


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    grow_factor: int = 2         # batch multiplier per resize (AdaBatch)
    grow_threshold: float = 2.0  # grow while ema_noise > threshold * batch
    patience: int = 8            # consecutive in-band steps before a resize
    cooldown: int = 16           # steps after a resize before counting again
    warmup: int = 4              # steps before the EMA is trusted at all
    max_global_batch: int = 0    # hard cap (0 = uncapped)
    grow_span: bool = True       # grow Adasum span with the batch
    lr_rescale: str = "adascale" # 'adascale' | 'linear' | 'none'
    ema: float = 0.9             # noise-EMA decay
    shrink_threshold: float = 0.0  # shrink while ema_noise < this * batch
                                 # (0 = shrink direction off); LR divided
                                 # by the same gain the growth multiplied by
    min_global_batch: int = 0    # shrink floor (0 = span/1 floor only)

    @classmethod
    def from_engine(cls, cfg) -> "ControllerConfig":
        """Projection of the EngineConfig controller knobs."""
        return cls(grow_factor=cfg.grow_factor,
                   grow_threshold=cfg.grow_threshold,
                   patience=cfg.grow_patience, cooldown=cfg.grow_cooldown,
                   max_global_batch=cfg.max_global_batch,
                   grow_span=cfg.grow_span, lr_rescale=cfg.lr_rescale,
                   ema=cfg.noise_ema,
                   shrink_threshold=cfg.shrink_threshold,
                   min_global_batch=cfg.min_global_batch)


class BatchController:
    """Observes per-step metrics, emits ResizePlans (see module doc)."""

    def __init__(self, cfg: ControllerConfig, *, global_batch: int,
                 span: int, dp_total: int, lr: float):
        assert cfg.grow_factor >= 2
        assert cfg.lr_rescale in ("adascale", "linear", "none")
        assert cfg.shrink_threshold >= 0.0
        if cfg.shrink_threshold:
            # the bands must not overlap (2x reset margins either side)
            assert cfg.shrink_threshold < cfg.grow_threshold, cfg
        self.cfg = cfg
        self.global_batch = int(global_batch)
        self.span = int(span)
        self.dp_total = int(dp_total)
        self.lr = float(lr)
        self.noise = NoiseEMA(cfg.ema)
        self.var = NoiseEMA(cfg.ema)
        self.mu2 = NoiseEMA(cfg.ema)
        self._above = 0
        self._below = 0
        self._cool = 0
        self._exhausted = False         # growth capped
        self._shrink_stopped = False    # shrink floored
        self.decisions: List[ResizePlan] = []

    # ------------------------------------------------------------- observe
    def observe(self, step: int, metrics: Dict[str, float]
                ) -> Optional[ResizePlan]:
        """Feed one step's metrics; returns a ResizePlan when the
        hysteresis schedule decides to grow — or, with a shrink band
        configured (`shrink_threshold` > 0), to shrink when the noise
        scale falls below it. Metrics without a noise_scale key (stats
        off / span 1) are ignored."""
        ns = metrics.get("noise_scale")
        shrink_on = self.cfg.shrink_threshold > 0 and not self._shrink_stopped
        if ns is None or (self._exhausted and not shrink_on):
            return None
        ema = self.noise.update(ns)
        self.var.update(metrics.get("grad_var"))
        self.mu2.update(metrics.get("grad_mu2"))
        if self._cool > 0:
            self._cool -= 1
            return None
        if ema is None or self.noise.count < self.cfg.warmup:
            return None
        hi = self.cfg.grow_threshold * self.global_batch
        if ema > hi:
            self._above += 1
        elif ema < hi / 2.0:
            self._above = 0          # firmly out of band: reset patience
        lo = self.cfg.shrink_threshold * self.global_batch
        if shrink_on and ema < lo:
            self._below += 1
        elif ema > 2.0 * lo:
            self._below = 0          # firmly above the shrink band
        if self._above >= self.cfg.patience and not self._exhausted:
            plan = self._plan()
            self._above = 0
            if plan is None or not plan.grew:
                # cap reached: stop asking (the run continues at this batch)
                self._exhausted = True
                return None
            return plan
        if shrink_on and self._below >= self.cfg.patience:
            plan = self._plan_shrink()
            self._below = 0
            if plan is None or not plan.changed:
                # floor reached: stop planning shrinks
                self._shrink_stopped = True
                return None
            return plan
        return None

    # ---------------------------------------------------------------- plan
    def _lr_scale(self, factor: int) -> float:
        if self.cfg.lr_rescale == "linear":
            return float(factor)
        if self.cfg.lr_rescale == "none":
            return 1.0
        var = self.var.value or 0.0
        mu2 = self.mu2.value or 0.0
        if var <= 0.0 and mu2 <= 0.0:
            return 1.0
        return gain_for_factor(var, mu2, float(factor))

    def _plan(self) -> Optional[ResizePlan]:
        plan = plan_grow(self.global_batch, self.span, self.dp_total,
                         self.lr, factor=self.cfg.grow_factor,
                         grow_span=self.cfg.grow_span,
                         max_global_batch=self.cfg.max_global_batch,
                         lr_scale=self._lr_scale(self.cfg.grow_factor),
                         reason=f"ema_noise={self.noise.value:.1f}"
                                f">{self.cfg.grow_threshold:g}x"
                                f"{self.global_batch}")
        return plan

    def _plan_shrink(self) -> Optional[ResizePlan]:
        # the LR comes back down by the same gain the growth multiplied
        # by: 1/gain (adascale), 1/factor (linear), 1 (none)
        inv = 1.0 / max(self._lr_scale(self.cfg.grow_factor), 1e-12)
        plan = plan_shrink_batch(
            self.global_batch, self.span, self.dp_total, self.lr,
            factor=self.cfg.grow_factor, shrink_span=self.cfg.grow_span,
            min_global_batch=self.cfg.min_global_batch, lr_scale=inv,
            reason=f"ema_noise={self.noise.value:.1f}"
                   f"<{self.cfg.shrink_threshold:g}x{self.global_batch}")
        return plan

    # ------------------------------------------------------------- resized
    def notify_resized(self, plan: ResizePlan):
        """The driver executed `plan`: adopt the new operating point and
        start the cooldown. The noise EMA is kept (it re-equilibrates
        during cooldown — a fresh EMA would hit the warmup gate
        instead)."""
        self.decisions.append(plan)
        self.global_batch = plan.new_batch
        self.span = plan.new_span
        self.lr = plan.new_lr
        self._above = 0
        self._below = 0
        self._cool = self.cfg.cooldown
        if plan.shrank:
            self._exhausted = False   # headroom above the cap again
        if plan.grew:
            self._shrink_stopped = False
