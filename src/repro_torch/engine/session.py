"""TrainSession — the one-line integration the paper sells (the port's
subset of `repro/engine/session.py`):

    from repro_torch.engine import EngineConfig, TrainSession
    session = TrainSession.from_config(
        EngineConfig(arch="gemma-7b", reduced=True, span=2,
                     backend="gspmd_tree"), device="cpu")
    session.fit(3)

`fit` is the serial loop (the reference's prefetch stage changes no
result; the port does not overlap batch building with the step). Only
`LoggingCallback` is ported; checkpoints, straggler monitoring and
failure drills are ROADMAP.md queue 1 item 4.

Weights come from the port's seeded generator: the reference's
`jax.random.key(0)` draws cannot be reproduced in torch.

Across ranks: under `python -m torch.distributed.run --nproc-per-node N`
(WORLD_SIZE > 1 in the environment) `from_config` starts the process
group itself (`Comm.init`: nccl on cuda, gloo on the CPU, or the
`dist_backend` named) and runs one lane per rank. Each rank defaults to
`cuda:LOCAL_RANK`; ranks that share one card name it (`device="cuda:0"`)
and need gloo. Every rank draws the weights from the same seed and rank
0's are then broadcast. Only rank 0's `LoggingCallback` prints. `close()`
destroys the process group the session started.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import get_config, get_reduced
from repro_torch.control.noise import STAT_KEYS
from repro_torch.data import make_source
from repro_torch.models import build_model
from repro_torch.models.api import Model
from repro_torch.parallel.comm import Comm
from repro_torch.runtime import DeviceLike, make_generator, resolve_device

from .build import Runtime, build_runtime
from .config import EngineConfig

PyTree = Any


class Callback:
    """Hook points around the training loop. All default to no-ops."""

    def on_fit_start(self, session: "TrainSession", start_step: int): ...

    def on_step_start(self, session: "TrainSession", step: int): ...

    def on_step_end(self, session: "TrainSession", step: int,
                    metrics: Dict[str, float], dt: float): ...

    def on_fit_end(self, session: "TrainSession",
                   history: List[Dict[str, float]]): ...


class LoggingCallback(Callback):
    def __init__(self, every: int = 10):
        self.every = every

    def on_step_end(self, session, step, metrics, dt):
        last = step == session.config.steps - 1
        if session.rank == 0 and (step % self.every == 0 or last):
            print(f"[train] step {step:5d} loss {metrics['loss']:.4f} "
                  f"{dt*1e3:.0f}ms span={session.runtime.span} "
                  f"combine={session.config.combine}")


def default_callbacks(cfg: EngineConfig) -> List[Callback]:
    return [LoggingCallback(cfg.log_every)]


class TrainSession:
    """One training run on one device or as one rank of several: config ->
    (model, runtime, data, state)."""

    def __init__(self, config: EngineConfig, model: Model, runtime: Runtime,
                 source, generator: torch.Generator,
                 callbacks: Optional[List[Callback]] = None,
                 owns_comm: bool = False):
        self.config = config
        self.model = model
        self.runtime = runtime
        self.source = source
        self.device = generator.device
        self.comm = runtime.comm
        self.rank = self.comm.rank if self.comm is not None else 0
        self._owns_comm = owns_comm
        self.callbacks = (default_callbacks(config) if callbacks is None
                          else list(callbacks))
        self.state: PyTree = runtime.init_state(generator)
        self._last_stats: Dict[str, float] = {}

    @classmethod
    def from_config(cls, config: EngineConfig, *, model: Optional[Model] = None,
                    device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None,
                    callbacks: Optional[List[Callback]] = None,
                    combine_impl: str = "kernel", comm: Optional[Comm] = None,
                    dist_backend: Optional[str] = None) -> "TrainSession":
        """Builds everything on `device` (cuda unless the caller names the
        CPU); weights come from `generator` (default: seed 0 on that
        device). With WORLD_SIZE > 1 in the environment and no `comm`,
        starts the process group (`dist_backend`: nccl on cuda, gloo on
        the CPU by default) and the session owns it; a `comm` passed in
        stays the caller's."""
        config.validate()
        world = (comm.world if comm is not None
                 else int(os.environ.get("WORLD_SIZE", "1")))
        local_rank = (int(os.environ.get("LOCAL_RANK", "0")) if world > 1
                      else None)
        dev = resolve_device(device if device is not None
                             or generator is None else generator.device,
                             local_rank=local_rank)
        gen = generator if generator is not None else make_generator(dev)
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, session on {dev}")
        if model is None:
            if not config.arch:
                raise ValueError("EngineConfig.arch is empty — pass a "
                                 "built Model via from_config(model=...)")
            mcfg = (get_reduced(config.arch) if config.reduced
                    else get_config(config.arch))
            model = build_model(
                mcfg, param_dtype=getattr(torch, config.param_dtype),
                attn_chunk=min(config.attn_chunk, config.seq_len))
        owns = comm is None and world > 1
        if owns:
            comm = Comm.init(dist_backend or ("nccl" if dev.type == "cuda"
                                              else "gloo"), dev)
        try:
            # the span and batch checks come after the model's family check
            config.validate(dp_total=world)
            runtime = build_runtime(model, config.run_policy(), lr=config.lr,
                                    strict=config.strict,
                                    combine_impl=combine_impl, comm=comm)
            source = make_source(config.data_config(model.cfg.vocab_size),
                                 model.cfg)
            return cls(config, model, runtime, source, gen, callbacks,
                       owns_comm=owns)
        except BaseException:
            if owns:
                comm.close()
            raise

    def run_metadata(self) -> Dict[str, Any]:
        """What actually ran: the resolved combine path, the topology and
        the CombineStats keys seen last."""
        rt = self.runtime
        return {"arch": self.config.arch or self.model.cfg.name,
                "combine": self.config.combine,
                "backend": self.config.backend,
                "combine_path": rt.combine_path,
                "combine_point": rt.dopt.point,
                "span": rt.span,
                "dp": rt.dp_total,
                "local_steps": self.config.local_steps,
                "devices": 1,
                "device": str(self.device),
                "world": rt.dp_total,
                "dist_backend": self.comm.backend if self.comm else "none",
                "staged_bytes": (self.comm.total_staged_bytes()
                                 if self.comm else 0),
                "stats_enabled": rt.combine_stats,
                "combine_stats": dict(self._last_stats),
                "global_batch": self.config.global_batch,
                "lr": self.config.lr}

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The deterministic batch for `step`, on the session's device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.source.batch(step).items()}

    def step(self, batch: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, float]:
        """One optimizer step; advances self.state. With no batch, pulls
        the deterministic batch for the current step counter."""
        if batch is None:
            batch = self.batch(self.state["step"])
        self.state, metrics = self.runtime.train_step(self.state, batch)
        out = {k: float(v) for k, v in metrics.items()}
        stats = {k: out[k] for k in STAT_KEYS if k in out}
        if stats:
            self._last_stats = stats
        return out

    def fit(self, steps: Optional[int] = None) -> List[Dict[str, float]]:
        """Train to `steps` total from the current step. Returns the
        per-step history."""
        steps = self.config.steps if steps is None else steps
        self.config = dataclasses.replace(self.config, steps=steps)
        start = self.state["step"]
        for cb in self.callbacks:
            cb.on_fit_start(self, start)
        history: List[Dict[str, float]] = []
        for step in range(start, steps):
            for cb in self.callbacks:
                cb.on_step_start(self, step)
            t0 = time.perf_counter()
            metrics = self.step(self.batch(step))
            dt = time.perf_counter() - t0
            row = {"step": step, "loss": metrics["loss"], "s": dt}
            row.update({k: metrics[k] for k in STAT_KEYS if k in metrics})
            history.append(row)
            for cb in self.callbacks:
                cb.on_step_end(self, step, metrics, dt)
        for cb in self.callbacks:
            cb.on_fit_end(self, history)
        return history

    def close(self) -> None:
        """Destroy the process group the session started (no background
        threads in the port yet)."""
        if self._owns_comm:
            self.comm.close()
            self._owns_comm = False
