"""Device resolution and the not-yet-ported guard shared by every entry
point of the port, and the training loop's runtime pieces (the port of
`repro/runtime/`):

  monitor   StepMonitor (straggler z-score), StragglerConfig,
            NodeLossError, FailureInjector, next_power_of_two_below
  prefetch  Prefetcher — step-addressed batch prefetch with the
            host-to-card copy on a side CUDA stream
  delayed   DelayedCombineStream — the delayed combine's correction on
            a thread and CUDA stream of its own, beside the local step
  elastic   RestartSignal / GrowBackSignal / ResizeSignal and the shrink,
            grow-back and resize planners
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .monitor import (FailureInjector, NodeLossError, StepMonitor,
                      StragglerConfig, next_power_of_two_below)
from .delayed import DelayedCombineStream
from .elastic import (ElasticPlan, GrowBackSignal, ResizePlan, ResizeSignal,
                      RestartSignal, plan_grow, plan_grow_back, plan_shrink,
                      plan_shrink_batch)
from .prefetch import Prefetcher

DeviceLike = Union[str, torch.device, None]

# ROADMAP.md queue 1 item that brings what the port still refuses
ITEM_SHARDING = "7"         # data/model meshes above one device


def resolve_device(device: DeviceLike = None,
                   local_rank: Optional[int] = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another one. Without a card, anything but an explicit CPU device
    raises — an entry point never quietly continues on the CPU.

    `cuda:N` names card N. With `local_rank` (one process per rank), a
    bare `cuda` means `cuda:<local_rank>`, one card per rank."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.index is None and local_rank is not None:
        dev = torch.device("cuda", local_rank)
    count = torch.cuda.device_count()
    if dev.index is not None and dev.index >= count:
        raise ValueError(
            f"{dev} does not exist: this host has {count} card(s); ranks "
            f"that share one card name it (device='cuda:0') and need the "
            f"gloo backend")
    return dev


def make_generator(device: torch.device,
                   seed: int = 0) -> torch.Generator:
    """A seeded generator on `device` (random init draws on the device
    itself, so full-width weights never pass through host memory)."""
    return torch.Generator(device=device).manual_seed(seed)


def not_ported(what: str, item: str,
               detail: Optional[str] = None) -> NotImplementedError:
    """The error for a feature a later slice brings: names the ROADMAP
    item so the caller knows where it stands."""
    msg = (f"{what} is not ported to repro_torch yet "
           f"(ROADMAP.md queue 1, item {item})")
    if detail:
        msg += f": {detail}"
    return NotImplementedError(msg)
