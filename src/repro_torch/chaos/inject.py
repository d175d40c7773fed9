"""Apply a ChaosSchedule to live runs — train and serve side (the port of
`repro/chaos/inject.py`).

Train-side faults ride the existing Callback protocol (duck-typed so
this module never imports the engine at import time):

  * `node_loss`  -> raise NodeLossError at step start (what a real lost
    participant surfaces as); `fit_elastic` shrinks DP and resumes.
  * `sigterm`    -> SIGTERM to our own pid at step start; the checkpoint
    manager's preemption handler saves-and-exits(143).
  * `straggler`  -> force the StragglerCallback monitors' flag; the
    pipeline raises RestartSignal at the step boundary.
  * `comm_spike` -> one step of injected interconnect latency through
    `DelayedCombineStream.comm_delay` (restored the next step).
    Latency-only: the delayed engine's math is unchanged, so the run
    stays bitwise identical to an un-spiked one — the soak asserts it.

Checkpoint faults don't fire on a step counter; `make_chaos_on_restart`
adapts them to `fit_elastic(on_restart=...)`, damaging the just-written
boundary checkpoint so the subsequent restore must prove its fallback.

Across ranks every rank holds the same schedule and consumes it at the
same steps, so node loss, SIGTERM and straggler flags land on every rank
together; a checkpoint fault is applied once, by rank 0 (the only
writer), after every rank has popped it.

Serve-side, `slow_prefill` wraps an engine's admission prefill in a
sleep (deadline pressure); page exhaustion and reload corruption need no
injector — the soak provokes them with a tiny `kv_pages` pool and
`faults.bitflip_leaf` on the watched checkpoint dir.
"""
from __future__ import annotations

import os
import signal as _signal
import time
from typing import Callable

from repro_torch.runtime import GrowBackSignal, NodeLossError

from .faults import apply_ckpt_fault
from .schedule import ChaosSchedule

_CKPT_KINDS = ("ckpt_bitflip", "ckpt_torn", "ckpt_drop_leaf",
               "ckpt_drop_manifest")


class ChaosCallback:
    """Feeds a schedule's train-side faults into the step loop."""

    def __init__(self, schedule: ChaosSchedule):
        self.schedule = schedule
        self._spiked = None   # (stream, saved comm_delay) to restore

    def on_fit_start(self, session, start_step):
        pass

    def on_step_start(self, session, step):
        for e in self.schedule.at(step, kinds=("node_loss", "sigterm")):
            if e.kind == "node_loss":
                raise NodeLossError(
                    f"chaos: injected node loss at step {step}")
            print(f"[chaos] SIGTERM at step {step}")
            os.kill(os.getpid(), _signal.SIGTERM)

    def on_step_end(self, session, step, metrics, dt):
        if self._spiked is not None:
            stream, old = self._spiked
            stream.comm_delay = old
            self._spiked = None
        for e in self.schedule.at(step, kinds=("comm_spike", "straggler")):
            if e.kind == "comm_spike":
                stream = getattr(session, "_delayed_stream", None)
                if stream is not None:
                    self._spiked = (stream, stream.comm_delay)
                    stream.comm_delay = e.arg
                    if session.rank == 0:
                        print(f"[chaos] comm spike {e.arg * 1e3:.0f}ms "
                              f"after step {step}")
            else:
                from repro_torch.engine.session import StragglerCallback
                for cb in session.callbacks:
                    if isinstance(cb, StragglerCallback):
                        cb.monitor.flagged = True
                if session.rank == 0:
                    print(f"[chaos] straggler flagged after step {step}")

    def on_fit_end(self, session, history):
        pass


class CapacityReturnCallback:
    """Models lost capacity coming back: once the run is below its full
    DP degree (post-shrink) for `delay` steps, raise `GrowBackSignal` so
    `fit_elastic` re-expands through the same save -> rebuild -> resume
    machinery. Re-arms after each firing — capacity can return after
    every loss (fit_elastic's max_grow_backs bounds the total); `fired`
    counts the firings."""

    def __init__(self, delay: int = 2):
        self.delay = delay
        self.fired = 0
        self._full = 0
        self._count = 0

    def on_fit_start(self, session, start_step):
        self._full = max(self._full, session.runtime.dp_total)
        self._count = 0

    def on_step_start(self, session, step):
        pass

    def on_step_end(self, session, step, metrics, dt):
        if session.runtime.dp_total >= self._full:
            return
        self._count += 1
        if self._count >= self.delay:
            self._count = 0
            self.fired += 1
            raise GrowBackSignal(step + 1, target_dp=self._full)

    def on_fit_end(self, session, history):
        pass


def make_chaos_on_restart(schedule: ChaosSchedule,
                          ckpt_root) -> Callable:
    """Adapter for `fit_elastic(on_restart=...)`: at each elastic
    boundary (after the driver's `save_sync`, before the rebuild) pop
    ONE pending checkpoint fault from the schedule and apply it to the
    just-written step — the restore on the other side of the rebuild
    must fall back to last-good. Across ranks only rank 0 damages the
    files (every rank pops the event)."""
    def on_restart(session, sig):
        e = schedule.take_one(_CKPT_KINDS)
        if e is None or session.rank != 0:
            return
        hit = apply_ckpt_fault(e.kind, ckpt_root)
        print(f"[chaos] {e.kind} applied to checkpoint step {hit} "
              f"at elastic boundary ({sig})")
    return on_restart


def slow_prefill(engine, delay_s: float) -> Callable[[], None]:
    """Serve-side fault: every admission prefill sleeps `delay_s` first
    (a slow/overloaded prefill path). Returns an undo callable."""
    orig = engine._admit_batch

    def slowed(admitted):
        time.sleep(delay_s)
        return orig(admitted)

    engine._admit_batch = slowed

    def undo():
        engine._admit_batch = orig
    return undo
