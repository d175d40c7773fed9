"""Learning-rate schedules (a torch copy of `repro/optim/schedules.py`).
The paper's LeNet-5 study (§5.4) uses linear warmup-then-decay "from
zero to zero"; ResNet/BERT use the benchmark defaults (step decay /
linear decay with warmup). Each schedule maps a step (int or tensor) to
an fp32 scalar tensor."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(base_lr: float):
    return lambda step: torch.tensor(base_lr, dtype=torch.float32)


def linear_warmup_decay(base_lr: float, warmup_steps: int, total_steps: int):
    """Linear 0 -> base_lr over warmup, then linear base_lr -> 0 (§5.4)."""
    def sched(step):
        step = _f32(step)
        warm = step / max(warmup_steps, 1)
        frac = (total_steps - step) / max(total_steps - warmup_steps, 1)
        return base_lr * torch.clamp(torch.minimum(warm, frac), 0.0, 1.0)
    return sched


def cosine_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                  min_frac: float = 0.0):
    def sched(step):
        step = _f32(step)
        warm = torch.clamp(step / max(warmup_steps, 1), 0.0, 1.0)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.minimum(warm, cos)
    return sched


def step_decay(base_lr: float, boundaries, factors):
    """MLPerf-ResNet-style piecewise schedule (the Fig. 1 orthogonality
    drops happen exactly at these boundaries)."""
    def sched(step):
        step = torch.as_tensor(step)
        lr = torch.tensor(base_lr, dtype=torch.float32)
        for b, f in zip(boundaries, factors):
            lr = torch.where(step >= b,
                             torch.tensor(base_lr * f, dtype=torch.float32),
                             lr)
        return lr
    return sched


_REGISTRY = {"constant": constant, "linear_warmup_decay": linear_warmup_decay,
             "cosine_warmup": cosine_warmup, "step_decay": step_decay}


def get_schedule(name: str, **kwargs):
    return _REGISTRY[name](**kwargs)
