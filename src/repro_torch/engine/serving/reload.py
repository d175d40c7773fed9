"""Checkpoint hot-reload: swap serving weights mid-stream (a copy of
`repro/engine/serving/reload.py`).

A `HotReloader` watches a checkpoint directory (written by a concurrent
TrainSession) and hands new params to the ServeEngine as versioned
weights: requests admitted after the swap decode with the new params
while in-flight requests finish on the version they started with — no
drain, no drop.

Safety comes from two existing mechanisms, reused rather than
reinvented:

  * atomic checkpoints — `latest_step()` only ever lists fully-renamed
    step directories, so a reader on its own manager can never observe a
    partial write;
  * AsyncCheckpointManager barriers — when the reloader SHARES the
    training run's async manager (same process, e.g. tests or a sidecar
    deployment), `latest_step()`/`restore_params()` first drain the
    in-flight background write, so the reloader sees the checkpoint the
    trainer just scheduled instead of racing it.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.checkpoint import CheckpointIntegrityError

PyTree = Any


class HotReloader:
    """Polls a CheckpointManager; restores the params subtree on change.

    A corrupt latest step (torn write, bit-flip — anything integrity
    validation rejects) is quarantined by the manager and the reloader
    falls back to the next-newest valid step instead of raising into
    the serve tick: the engine keeps serving, on older weights, and
    `fallbacks` counts how often that happened."""

    def __init__(self, manager, template: PyTree, *,
                 loaded_step: Optional[int] = None):
        """manager: any CheckpointManager (an AsyncCheckpointManager's
        barriers make shared-manager polling race-free). template: a
        params tree (tensors; meta tensors do) to restore into.
        loaded_step: step already serving (skip re-loading it)."""
        self.manager = manager
        self.template = template
        self.loaded_step = loaded_step
        self.fallbacks = 0

    def poll(self) -> Optional[Tuple[int, PyTree]]:
        """Returns (step, params) when a newer checkpoint landed, else
        None. Never raises on an empty directory."""
        while True:
            latest = self.manager.latest_step()  # async manager: barrier
            if latest is None or latest == self.loaded_step:
                return None
            if self.loaded_step is not None and latest < self.loaded_step:
                return None                      # gc'd / rolled back dir
            try:
                params = self.manager.restore_params(self.template, latest)
            except CheckpointIntegrityError as e:
                # the manager quarantined the step (renamed *.bad), so
                # latest_step() moves past it next iteration — the loop
                # strictly descends and terminates
                self.fallbacks += 1
                print(f"[reload] skipping corrupt step {latest}: {e}")
                continue
            self.loaded_step = latest
            return latest, params
