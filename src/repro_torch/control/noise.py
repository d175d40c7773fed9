"""Gradient-noise-scale metrics from Adasum's free dot-product signal (the
port of `repro/control/noise.py`: torch in the step, host floats in the
controller).

Level 0 of `CombineStats` ({'levels': f32 [L, 3]}, rows [Σ dot, Σ ‖a‖²,
Σ ‖b‖²]) pairs lanes that computed gradients on independent batch
shards, so its triple is a two-sample gradient-noise estimate
(McCandlish et al.): mu2 = mean pair dot, var = mean lane sq - mu2,
noise_scale = b_lane · var / mu2, and AdaScale's gain
(var + mu2) / (var / S + mu2) in [1, S].
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

EPS = 1e-20

# the per-step metric keys summarize_stats emits
STAT_KEYS = ("grad_dot", "grad_sq", "lane_cos", "grad_var", "grad_mu2",
             "gain_ratio", "noise_scale")


def summarize_stats(stats: Dict[str, Any], span: int, lane_rows: int
                    ) -> Dict[str, torch.Tensor]:
    """Scalar per-step metrics (0-d fp32 tensors) from a CombineStats
    pytree. With no levels (span 1: nothing was paired) every metric is 0
    except gain_ratio = 1 — the single-lane limits."""
    levels = stats["levels"]
    if levels.shape[0] == 0 or span < 2:
        z = torch.zeros((), dtype=torch.float32)
        return {"grad_dot": z, "grad_sq": z, "lane_cos": z, "grad_var": z,
                "grad_mu2": z, "gain_ratio": torch.ones((),
                                                        dtype=torch.float32),
                "noise_scale": z}
    pairs = span // 2
    dot_s, na_s, nb_s = levels[0, 0], levels[0, 1], levels[0, 2]
    grad_dot = dot_s / pairs                       # mean pair dot
    grad_sq = (na_s + nb_s) / (2 * pairs)          # mean per-lane ‖g‖²
    lane_cos = dot_s / (torch.sqrt(na_s * nb_s) + EPS)
    mu2 = torch.clamp(grad_dot, min=0.0)
    var = torch.clamp(grad_sq - grad_dot, min=0.0)
    gain = torch.clamp((var + mu2) / (var / span + mu2 + EPS), 1.0, span)
    noise = lane_rows * var / (mu2 + EPS)
    f32 = lambda x: x.to(torch.float32)
    return {"grad_dot": f32(grad_dot), "grad_sq": f32(grad_sq),
            "lane_cos": f32(lane_cos), "grad_var": f32(var),
            "grad_mu2": f32(mu2), "gain_ratio": f32(gain),
            "noise_scale": f32(noise)}


def gain_for_factor(var: float, mu2: float, factor: float) -> float:
    """AdaScale gain of growing the lane count / batch by `factor`,
    given the current per-lane variance and squared-mean estimates —
    the LR rescale the controller applies at a resize (host floats)."""
    if factor <= 1.0:
        return 1.0
    g = (var + mu2) / (var / factor + mu2 + EPS)
    return float(min(max(g, 1.0), factor))


class NoiseEMA:
    """Debiased exponential moving average over a host-side scalar
    stream, NaN/inf-guarded (a divergent step must not poison the
    controller): `update(x)` returns the current debiased mean."""

    def __init__(self, decay: float = 0.9):
        assert 0.0 <= decay < 1.0, decay
        self.decay = decay
        self._acc = 0.0
        self._w = 0.0
        self.count = 0

    def update(self, x: Optional[float]) -> Optional[float]:
        if x is None or not math.isfinite(x):
            return self.value
        self._acc = self.decay * self._acc + (1.0 - self.decay) * float(x)
        self._w = self.decay * self._w + (1.0 - self.decay)
        self.count += 1
        return self.value

    @property
    def value(self) -> Optional[float]:
        if self._w <= 0.0:
            return None
        return self._acc / self._w
