"""The step loop as overlapped stages (the port of
`repro/engine/pipeline.py`):

    prefetch thread :  batch(step+1) -> stage (host, or onto the card
                       on a side stream)                 (Prefetcher)
    card            :  train_step(state, batch(step))
    writer thread   :  serialize + write checkpoint(step-k)
                       (AsyncCheckpointManager)
    monitor         :  robust z-score on step times  ->  RestartSignal

and the elastic driver (`fit_elastic`) that consumes the monitor's flag
or a `NodeLossError` (real or injected participant loss): checkpoint ->
halve the DP degree -> rebuild the session (combiner re-resolved for the
new span) -> resume from the manifest; and grows back the same way when
capacity returns. Per paper §5.4 Adasum needs no hyperparameter change
across a shrink.

Determinism: batches are addressed by step (pure (seed, step)
functions), so the prefetched stream is bitwise the synchronous one —
across save/restore/resume and elastic rebuilds too.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.control.noise import STAT_KEYS
from repro_torch.parallel.comm import Comm
from repro_torch.runtime import (ITEM_SHARDING, GrowBackSignal,
                                 NodeLossError, Prefetcher, RestartSignal,
                                 not_ported, plan_grow_back, plan_shrink)
from repro_torch.runtime.prefetch import DeviceStage


class StepPipeline:
    """Drives one `TrainSession`'s training loop.

    The session owns model, runtime and state; the pipeline owns the
    schedule: the resume decision, the prefetch lifecycle (depth and
    staging per EngineConfig.prefetch_depth / device_stage), step
    timing, callback dispatch, elastic flag consumption and the
    end-of-run barriers (pending checkpoint writes, prefetch
    shutdown)."""

    def __init__(self, session):
        self.session = session
        self.prefetcher: Optional[Prefetcher] = None

    def _fetch(self, step: int) -> Dict[str, Any]:
        s = self.session
        if self.prefetcher is None:
            return s.batch(step)
        return {k: v.to(s.device)
                for k, v in self.prefetcher.get(step).items()}

    def _straggler_flagged(self) -> bool:
        """Whether a StragglerCallback monitor is flagged. Each rank's
        monitor judges its own step times, so across ranks the flags are
        OR-reduced (a sum in rank order over the comm) and every rank
        takes the same decision."""
        from .session import StragglerCallback
        s = self.session
        flagged = any(cb.monitor.flagged for cb in s.callbacks
                      if isinstance(cb, StragglerCallback))
        if not s._ranked():
            return flagged
        v = torch.tensor([float(flagged)], device=s.device)
        return bool(s.comm.group_sum(v, s.comm.world).item() > 0)

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
                if s.config.elastic and self._straggler_flagged():
                    raise RestartSignal(step + 1)
            for cb in s.callbacks:
                cb.on_fit_end(s, history)
        except Exception as e:
            # the elastic and adaptive drivers stitch runs together
            # across rebuilds: hand them the steps this attempt completed
            e.history = history
            raise
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


# ------------------------------------------------------------------ elastic
class _Launch:
    """What a driver keeps across the sessions it builds: the device, the
    generator's starting state (every session draws the same initial
    weights, as the reference's key(0) does) and the launch's full comm —
    started here when WORLD_SIZE > 1 and no comm is given, and then
    destroyed by `close`."""

    def __init__(self, device, generator, comm: Optional[Comm],
                 dist_backend: Optional[str]):
        from .session import session_device
        world = (comm.world if comm is not None
                 else int(os.environ.get("WORLD_SIZE", "1")))
        self.device = session_device(device, generator, world)
        self._gen = (None if generator is None
                     else (generator.device, generator.get_state()))
        self.owns = comm is None and world > 1
        if self.owns:
            comm = Comm.init(dist_backend or (
                "nccl" if self.device.type == "cuda" else "gloo"),
                self.device)
        self.comm = comm

    def generator(self) -> Optional[torch.Generator]:
        if self._gen is None:
            return None                 # from_config's seed-0 generator
        g = torch.Generator(device=self._gen[0])
        g.set_state(self._gen[1])
        return g

    def close(self) -> None:
        if self.owns:
            self.comm.close()
            self.owns = False


def _tell_parked(full: Optional[Comm], live: Optional[Comm], msg: dict):
    """Rank 0's message to the evicted ranks parked on the full comm
    (collective over the full comm: every active rank calls it, and
    every parked rank waits in `_park`); nothing when no rank is
    parked."""
    if full is not None and live is not None and live.world < full.world:
        full.broadcast_object(msg if full.rank == 0 else None, 0)


def _park(full: Comm) -> dict:
    """An evicted rank waits for rank 0's next message. It holds no
    session, so SIGTERM takes its default action meanwhile."""
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    return full.broadcast_object(None, 0)


def _drop(session) -> None:
    """A closed session's state goes before the next one is built (two
    states never sit on the card at once)."""
    session.state = None
    if session.device.type == "cuda":
        torch.cuda.empty_cache()


def _rejoin(full: Comm, dp: int) -> Optional[Comm]:
    """Every rank of the full comm, after a grow-back message: the comm of
    the ranks 0..dp-1 (the full comm at dp = its world), None on the
    ranks that stay parked. Collective over the full comm."""
    full.align_groups()
    if dp == full.world:
        return full
    child = full.split([list(range(dp)), list(range(dp, full.world))])
    return child if full.rank < dp else None


def fit_elastic(config, steps: Optional[int] = None, *,
                callbacks: Optional[List] = None, max_restarts: int = 2,
                max_grow_backs: int = 4,
                on_restart: Optional[Callable] = None,
                model=None, device=None,
                generator: Optional[torch.Generator] = None,
                comm: Optional[Comm] = None, combine_impl: str = "kernel",
                dist_backend: Optional[str] = None,
                ) -> Tuple[List[Dict[str, float]], Any]:
    """Fault-tolerant driver (the reference's `fit_elastic`,
    pipeline.py:164-297): run `fit`, and on node loss (injected failure)
    or a flagged persistent straggler checkpoint, halve the DP degree
    (power of two), rebuild the session from the same EngineConfig and
    resume from the manifest. A `GrowBackSignal` (capacity returned)
    runs the same save -> rebuild -> resume machinery in the other
    direction: DP re-expands toward the run's original degree and the LR
    is rescaled by the AdaScale gain of the growth factor (from the live
    CombineStats; 1.0 without them) — per §5.4 nothing else changes.
    Returns (combined history, final session); the final session carries
    `elastic_log` (restarts / grow_backs / plans and the banked integrity
    counters of the closed sessions).

    The callback list is shared across attempts (a FailureInjector must
    not re-arm a failure it already fired), but straggler monitors are
    reset on restart — evicting the straggler clears the flag.
    `on_restart(session, signal)` runs on every active rank after each
    boundary `save_sync` and before the rebuild (the chaos harness
    corrupts the just-written checkpoint there).

    `device`, `generator`, `combine_impl` and `model` go to every
    session's `from_config`; the generator's state is taken once, so
    each session draws the same initial weights (a restore then
    overwrites them).

    One process (the lanes stacked on one device): dp is 1, so a shrink
    has nothing to drop and the signal is re-raised after the boundary
    save, and a grow-back resumes as it is — the reference at dp=1.

    Across ranks (one process a rank; `comm`, or the launch environment,
    whose process group the driver then starts and destroys at the end):
    the launch's full comm stays for the whole run. A shrink to n ranks
    splits the ranks in training into [0..n-1] and the rest (collective
    over them); the survivors build the next session on the first
    sub-communicator, passed in as `comm=` (so a session's `close` never
    destroys it), and the evicted ranks park: they block on a broadcast
    from rank 0 over the full comm, whose message is "grow back to
    degree m" (the ranks below m rejoin — on the full comm at m = its
    world — and restore from the boundary checkpoint; every rank first
    takes rank 0's count of process groups made, since the parked ranks
    sat out the survivors' splits), "done", or "exit" (the survivors
    stopped on an error or SIGTERM: a parked rank raises SystemExit with
    their code, or RuntimeError). A parked rank waits at most the
    process group's timeout. A rank that is parked when the run ends
    returns its own history (the steps it ran before it was evicted) and
    its last session, closed and without its state (a closed session's
    state is dropped before the next is built), whose `elastic_log` is
    rank 0's final one.
    Every decision is the same on every rank: the failures and signals
    come from the same callbacks, the straggler flags are OR-reduced,
    and the grow-back gain reads CombineStats that are rank-order sums.
    A shrink to one rank runs the one-device path. The ranks are live
    processes throughout, as the reference's devices are: a real process
    death (and NCCL across cards) is out of scope.
    """
    from repro_torch.control.noise import gain_for_factor
    from repro_torch.control.resize import log_effective
    from repro_torch.runtime import StepMonitor
    from .session import StragglerCallback, TrainSession, default_callbacks

    if config.model_mesh > 1:
        raise not_ported("fit_elastic with a model axis", ITEM_SHARDING)
    if not config.ckpt_dir:
        raise ValueError("fit_elastic needs EngineConfig.ckpt_dir (the "
                         "restart resumes from the manifest)")
    cbs = default_callbacks(config) if callbacks is None else list(callbacks)

    def _reset_monitors():
        for cb in cbs:
            if isinstance(cb, StragglerCallback):
                cb.monitor = StepMonitor(cb.monitor.cfg)

    launch = _Launch(device, generator, comm, dist_backend)
    full = live = launch.comm
    history: List[Dict[str, float]] = []
    restarts = grow_backs = 0
    full_dp = 0    # the original DP degree: the grow-back target
    elastic_log: Dict[str, Any] = {"restarts": 0, "grow_backs": 0,
                                   "plans": [],
                                   "prior_restore_fallbacks": 0,
                                   "prior_quarantined": []}
    session = None

    def _bank_counters(session):
        # each rebuild gets a fresh CheckpointManager; move the closing
        # session's integrity counters into the log so run_metadata stays
        # cumulative (and a parked rank's last session counts them once)
        ck = session.checkpoint
        if ck is not None:
            elastic_log["prior_restore_fallbacks"] += ck.restore_fallbacks
            elastic_log["prior_quarantined"] += [q["step"]
                                                 for q in ck.quarantined]
            ck.restore_fallbacks, ck.quarantined = 0, []

    def _say(msg: str):
        if full is None or full.rank == 0:
            print(msg)

    try:
        while True:
            if full is not None and live is None:
                # parked: wait for the survivors' next message
                msg = _park(full)
                if msg["kind"] == "exit":
                    if msg["code"] is not None:
                        raise SystemExit(msg["code"])
                    raise RuntimeError("the elastic run failed on the "
                                       "active ranks")
                elastic_log.clear()
                elastic_log.update(msg["log"])
                restarts = elastic_log["restarts"]
                grow_backs = elastic_log["grow_backs"]
                if msg["kind"] == "done":
                    return history, session
                config = dataclasses.replace(config, lr=msg["lr"])
                live = _rejoin(full, msg["dp"])
                _reset_monitors()
                continue
            session = TrainSession.from_config(
                config, model=model, device=launch.device,
                generator=launch.generator(), callbacks=cbs,
                combine_impl=combine_impl, comm=live)
            session.elastic_log = elastic_log
            if not full_dp:
                full_dp = session.runtime.dp_total
            if restarts or grow_backs:
                # after any elastic rebuild, validate + log the settings
                # actually in force (span can be re-clamped by the
                # smaller dp) — the check the resize driver runs
                log_effective(session,
                              label=f"rebuild #{restarts + grow_backs}")
            try:
                history += session.fit(steps)
                res = session._resilience_metadata()
                _tell_parked(full, live, {"kind": "done", "log": dict(
                    elastic_log,
                    prior_restore_fallbacks=res["restore_fallbacks"],
                    prior_quarantined=res["quarantined_steps"])})
                return history, session
            except (RestartSignal, NodeLossError) as e:
                history += getattr(e, "history", [])
                # state sits at a step boundary (failures fire at step
                # start, straggler flags after step end): checkpoint it
                session.save_sync()
                if on_restart is not None:
                    on_restart(session, e)
                plan = plan_shrink(session.runtime.dp_total)
                if not plan.shrunk or restarts >= max_restarts:
                    session.close()
                    raise
                _bank_counters(session)
                restarts += 1
                elastic_log["restarts"] = restarts
                elastic_log["plans"].append(
                    {"kind": "shrink", "old_dp": plan.old_dp,
                     "new_dp": plan.new_dp})
                _say(f"[elastic] {e}: restarting at dp={plan.new_dp} "
                     f"(was {plan.old_dp}), no hyperparameter change")
                session.close()    # the abandoned session's writer thread
                _drop(session)
                n, W = plan.new_dp, live.world
                child = live.split([list(range(n)), list(range(n, W))])
                live = child if live.rank < n else None
                _reset_monitors()
            except GrowBackSignal as e:
                history += getattr(e, "history", [])
                session.save_sync()
                if on_restart is not None:
                    on_restart(session, e)
                grow_backs += 1
                if grow_backs > max_grow_backs:
                    session.close()
                    raise
                _bank_counters(session)
                dp_now = session.runtime.dp_total
                # capacity comes back as far as the launch's ranks
                target = min(e.target_dp or full_dp,
                             full.world if full is not None else 1)
                prov = plan_grow_back(dp_now, target, config.lr)
                if not prov.grew:
                    # nothing to re-expand: resume as-is from the manifest
                    session.close()
                    _drop(session)
                    continue
                # AdaScale gain of the growth factor from live CombineStats
                stats = session._last_stats or {}
                var = float(stats.get("grad_var", 0.0))
                mu2 = float(stats.get("grad_mu2", 0.0))
                factor = prov.new_dp // prov.old_dp
                gain = (gain_for_factor(var, mu2, float(factor))
                        if (var > 0.0 or mu2 > 0.0) else 1.0)
                plan = plan_grow_back(dp_now, target, config.lr,
                                      lr_scale=gain)
                elastic_log["grow_backs"] = grow_backs
                elastic_log["plans"].append(
                    {"kind": "grow_back", "old_dp": plan.old_dp,
                     "new_dp": plan.new_dp, "old_lr": plan.old_lr,
                     "new_lr": plan.new_lr, "gain": gain})
                _say(f"[elastic] {e}: growing back to dp={plan.new_dp} "
                     f"(was {plan.old_dp}), lr {plan.old_lr:g}->"
                     f"{plan.new_lr:g} (adascale gain {gain:.3f} for "
                     f"factor {factor})")
                session.close()
                _drop(session)
                config = dataclasses.replace(config, lr=plan.new_lr)
                _tell_parked(full, live, {"kind": "grow", "dp": plan.new_dp,
                                          "lr": plan.new_lr,
                                          "log": elastic_log})
                live = _rejoin(full, plan.new_dp)
                _reset_monitors()
    except BaseException as e:
        # the survivors stop: the parked ranks stop with them
        if live is not None:
            code = e.code if isinstance(e, SystemExit) else None
            _tell_parked(full, live, {"kind": "exit", "code": code})
        raise
    finally:
        launch.close()
