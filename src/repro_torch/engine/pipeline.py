"""The step loop as overlapped stages (the port of
`repro/engine/pipeline.py`):

    prefetch thread :  batch(step+1) -> stage (host, or onto the card
                       on a side stream)                 (Prefetcher)
    card            :  train_step(state, batch(step))
    writer thread   :  serialize + write checkpoint(step-k)
                       (AsyncCheckpointManager)
    monitor         :  robust z-score on step times      (StragglerCallback)

Determinism: batches are addressed by step (pure (seed, step)
functions), so the prefetched stream is bitwise the synchronous one —
across save/restore/resume too. The elastic restart loop (`fit_elastic`,
the reference's restart on a flagged straggler or a lost node) is
ROADMAP.md queue 1 item 8.
"""
from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Optional

from repro_torch.control.noise import STAT_KEYS
from repro_torch.runtime import Prefetcher
from repro_torch.runtime.prefetch import DeviceStage


class StepPipeline:
    """Drives one `TrainSession`'s training loop.

    The session owns model, runtime and state; the pipeline owns the
    schedule: the resume decision, the prefetch lifecycle (depth and
    staging per EngineConfig.prefetch_depth / device_stage), step
    timing, callback dispatch and the end-of-run barriers (pending
    checkpoint writes, prefetch shutdown)."""

    def __init__(self, session):
        self.session = session
        self.prefetcher: Optional[Prefetcher] = None

    def _fetch(self, step: int) -> Dict[str, Any]:
        s = self.session
        if self.prefetcher is None:
            return s.batch(step)
        return {k: v.to(s.device)
                for k, v in self.prefetcher.get(step).items()}

    def _resolve_start(self) -> int:
        """Continue from the live state unless a checkpoint is AHEAD of it
        (the fresh-process resume case) — never roll back in-session
        work."""
        s = self.session
        start = s.state["step"]
        if s.checkpoint is not None:
            latest = s.latest_step()
            if latest is not None and latest > start:
                start = s.restore()
            s.checkpoint.install_preemption_handler(lambda: s.save_sync())
        return start

    def run(self) -> List[Dict[str, float]]:
        s = self.session
        steps = s.config.steps
        start = self._resolve_start()
        for cb in s.callbacks:
            cb.on_fit_start(s, start)
        if s.config.prefetch and start < steps:
            stage = DeviceStage(s.device) if s.config.device_stage else None
            self.prefetcher = Prefetcher(
                s.source, limit=steps, depth=s.config.prefetch_depth,
                stage=stage, claim=stage.claim if stage else None)
            self.prefetcher.schedule(start)
        history: List[Dict[str, float]] = []
        try:
            for step in range(start, steps):
                for cb in s.callbacks:
                    cb.on_step_start(s, step)
                t0 = time.perf_counter()
                metrics = s.step(self._fetch(step))
                # dt covers batch wait + the step (`step` reads the
                # metrics back, so the card has finished): the quantity
                # the overlap hides and the straggler monitor judges
                dt = time.perf_counter() - t0
                row = {"step": step, "loss": metrics["loss"], "s": dt}
                # the delayed combine's split accounting (steps through a
                # DelayedCombineStream): compute vs waiting on the
                # exchange, per step; and the CombineStats metrics
                row.update({k: metrics[k] for k in
                            ("compute_s", "combine_wait_s") + STAT_KEYS
                            if k in metrics})
                history.append(row)
                for cb in s.callbacks:
                    cb.on_step_end(s, step, metrics, dt)
            for cb in s.callbacks:
                cb.on_fit_end(s, history)
        finally:
            if self.prefetcher is not None:
                self.prefetcher.close()
                self.prefetcher = None
            wait = getattr(s.checkpoint, "wait", None)
            if wait is not None and sys.exc_info()[0] is None:
                wait()
            elif wait is not None:
                # already unwinding: a stale writer error must not
                # supersede the error in flight — drain and report it
                try:
                    wait()
                except Exception as we:
                    print(f"[pipeline] checkpoint writer error during "
                          f"unwind: {we!r}")
        return history
