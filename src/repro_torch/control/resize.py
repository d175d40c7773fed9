"""Planned resize execution: the controller's decisions, made real (the
port of `repro/control/resize.py`).

`fit_elastic`'s failure-shrink path generalizes into a *planned* resize:
save a synchronous checkpoint, mutate the EngineConfig (global batch,
Adasum span, LR), rebuild the session from it, and resume from the
manifest. The restore copies every leaf into the live tensors, and the
lane axis of per-lane optimizer state (and a delayed carry) is folded or
repeated across a span change (`reshard_lanes`), so resumed steps are
bitwise a plain session restored from the same checkpoint at the new
operating point. Batches are pure (seed, step) functions, so the data
stream stays aligned across the resize — step N+1's batch is the same
whether or not a resize happened at N (at the new batch size, no
skipped or replayed steps).

The reference keeps its mesh across a resize; the port keeps its comm:
dp does not change at a resize. The controller's `dp_total` is
`session.runtime.dp_total`. On one process (the lanes stacked on one
device) that is 1, so `plan_grow` doubles the batch and keeps the span;
across ranks the span grows with the batch as in the reference, up to
one lane a rank.

`fit_adaptive` is the driver (`fit_elastic`'s sibling);
`ControllerCallback` raises the `ResizeSignal`; `log_effective`
validates + logs the settings actually in force after ANY rebuild.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.runtime import ITEM_SHARDING, not_ported
from repro_torch.runtime.elastic import ResizePlan, ResizeSignal

from .controller import BatchController, ControllerConfig


def log_effective(session, label: str = "effective") -> Dict[str, Any]:
    """Validate and log (rank 0 prints) the *effective* global batch /
    span / LR a session will actually run — called after every rebuild
    (elastic shrink or controller resize), because the config a driver
    *asked* for can be silently adjusted (span clamped to the ranks,
    preset overrides). Raises if the effective combination is
    inconsistent."""
    cfg, rt = session.config, session.runtime
    cfg.validate(rt.dp_total)
    if cfg.global_batch % rt.span:
        raise ValueError(f"effective global_batch={cfg.global_batch} not "
                         f"divisible by effective span={rt.span}")
    eff = {"global_batch": cfg.global_batch, "span": rt.span,
           "lane_rows": cfg.global_batch // rt.span, "lr": cfg.lr,
           "dp": rt.dp_total, "combine_path": rt.combine_path}
    if session.rank == 0:
        print(f"[control] {label}: batch={eff['global_batch']} "
              f"span={eff['span']} lane_rows={eff['lane_rows']} "
              f"lr={eff['lr']:g} dp={eff['dp']} "
              f"combine_path={eff['combine_path']}")
    return eff


def apply_resize(config, plan: ResizePlan):
    """The config mutation a ResizePlan prescribes, validated. Span is
    written explicitly (not 0/auto) so the rebuilt runtime can't
    re-resolve it differently."""
    return dataclasses.replace(
        config, global_batch=plan.new_batch, span=plan.new_span,
        lr=plan.new_lr).validate()


class ControllerCallback:
    """Feeds per-step metrics to the BatchController; raises ResizeSignal
    when it decides to resize. Duck-typed Callback (no engine import —
    control sits below engine). Across ranks every rank feeds the same
    metrics (rank-order sums), so every rank raises at the same step."""

    def __init__(self, controller: BatchController):
        self.controller = controller

    def on_fit_start(self, session, start_step: int): ...

    def on_step_start(self, session, step: int): ...

    def on_fit_end(self, session, history): ...

    def on_step_end(self, session, step: int, metrics: Dict[str, float],
                    dt: float):
        plan = self.controller.observe(step, metrics)
        if plan is not None:
            raise ResizeSignal(step + 1, plan)


def fit_adaptive(config, steps: Optional[int] = None, *,
                 callbacks: Optional[List] = None, max_resizes: int = 8,
                 controller: Optional[BatchController] = None,
                 model=None, device=None, generator=None, comm=None,
                 combine_impl: str = "kernel",
                 dist_backend: Optional[str] = None,
                 ) -> Tuple[List[Dict[str, float]], Any]:
    """Noise-adaptive training driver: run `fit` with a BatchController
    watching the CombineStats metrics; on a ResizeSignal checkpoint,
    apply the plan to the config, rebuild the session (same comm — dp
    does not change), and resume from the manifest. Returns (combined
    history, final session); the executed plans are on
    `session.resize_log` (and `controller.decisions`).

    The sibling of `engine.pipeline.fit_elastic` — same
    save -> rebuild -> resume skeleton, but the rebuild is *planned*
    (a growth the controller chose) instead of reactive (a failure).
    `device`, `generator`, `model` and `combine_impl` go to every
    session's `from_config` (each session draws the same initial
    weights); `comm`, or the launch environment (whose process group the
    driver then starts and destroys at the end), gives the ranks."""
    from repro_torch.engine.pipeline import _Launch, _drop
    from repro_torch.engine.session import TrainSession, default_callbacks

    if config.model_mesh > 1:
        raise not_ported("fit_adaptive with a model axis", ITEM_SHARDING)
    if not config.ckpt_dir:
        raise ValueError("fit_adaptive needs EngineConfig.ckpt_dir (the "
                         "resize resumes from the manifest)")
    if not config.adaptive_batch:
        config = dataclasses.replace(config, adaptive_batch=True)
    config.validate()
    cbs = (default_callbacks(config) if callbacks is None
           else list(callbacks))
    history: List[Dict[str, float]] = []
    resize_log: List[Dict[str, Any]] = []
    ctrl = controller
    launch = _Launch(device, generator, comm, dist_backend)
    try:
        while True:
            session = TrainSession.from_config(
                config, model=model, device=launch.device,
                generator=launch.generator(), callbacks=cbs,
                combine_impl=combine_impl, comm=launch.comm)
            if ctrl is None:
                ctrl = BatchController(
                    ControllerConfig.from_engine(config),
                    global_batch=config.global_batch,
                    span=session.runtime.span,
                    dp_total=session.runtime.dp_total, lr=config.lr)
            if len(ctrl.decisions) < max_resizes:
                session.callbacks = list(session.callbacks) \
                    + [ControllerCallback(ctrl)]
            log_effective(session, label="resize" if resize_log else "start")
            session.resize_log = resize_log
            try:
                history += session.fit(steps)
                return history, session
            except ResizeSignal as e:
                history += getattr(e, "history", [])
                # the flagged step completed (the signal fires from
                # on_step_end, carrying step+1): checkpoint it, barrier
                session.save_sync()
                resize_log.append({"step": e.step, **e.plan.to_dict()})
                if session.rank == 0:
                    print(f"[control] resize at step {e.step}: "
                          f"{e.plan.describe()}")
                session.close()
                _drop(session)
                config = apply_resize(config, e.plan)
                ctrl.notify_resized(e.plan)
    finally:
        launch.close()
