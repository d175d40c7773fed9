"""Dynamic loss/gradient scaling (a torch copy of
`repro/optim/scaling.py`; paper §4.4.1, Micikevicius et al.).

The paper trains in fp16 on GPUs and dynamically rescales tensors it
introduces (e.g. the effective gradient) to stay inside fp16 range.
bf16's exponent range matches fp32, so the port's bf16 paths need no
scaling; the scaler is kept for fp16 paths and paper fidelity."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as T

PyTree = Any


class ScalerState(NamedTuple):
    scale: torch.Tensor       # current loss scale (fp32 scalar)
    good_steps: torch.Tensor  # consecutive finite steps (int32 scalar)


class DynamicLossScaler:
    """scale *= 2 after `growth_interval` finite steps; scale /= 2 on any
    non-finite gradient (and the step is skipped by the caller)."""

    def __init__(self, init_scale: float = 2.0 ** 15,
                 growth_interval: int = 2000, factor: float = 2.0,
                 min_scale: float = 1.0, max_scale: float = 2.0 ** 24):
        self.init_scale = init_scale
        self.growth_interval = growth_interval
        self.factor = factor
        self.min_scale = min_scale
        self.max_scale = max_scale

    def init(self) -> ScalerState:
        return ScalerState(torch.tensor(self.init_scale, dtype=torch.float32),
                           torch.zeros((), dtype=torch.int32))

    def scale_loss(self, loss: torch.Tensor,
                   state: ScalerState) -> torch.Tensor:
        return loss * state.scale.to(loss.dtype)

    def unscale(self, grads: PyTree, state: ScalerState) -> PyTree:
        inv = 1.0 / state.scale
        return T.map(lambda g: g.to(torch.float32) * inv, grads)

    def check_finite(self, grads: PyTree) -> torch.Tensor:
        finite = torch.tensor(True)
        for g in T.leaves(grads):
            finite = finite & torch.isfinite(g).all().cpu()
        return finite

    def update(self, state: ScalerState,
               finite: torch.Tensor) -> ScalerState:
        grew = state.good_steps + 1 >= self.growth_interval
        new_scale = torch.where(
            finite,
            torch.where(grew, torch.clamp(state.scale * self.factor,
                                          max=self.max_scale), state.scale),
            torch.clamp(state.scale / self.factor, min=self.min_scale))
        new_good = torch.where(finite & ~grew, state.good_steps + 1,
                               torch.zeros_like(state.good_steps))
        return ScalerState(new_scale, new_good)
