"""TrainSession — the one-line integration the paper sells — and the
legacy ServeSession (the port of `repro/engine/session.py`):

    from repro_torch.engine import EngineConfig, TrainSession
    session = TrainSession.from_config(
        EngineConfig(arch="gemma-7b", reduced=True, span=2,
                     backend="gspmd_tree", ckpt_dir="runs/g"),
        device="cpu")
    session.fit(3)

`fit` runs through `repro_torch.engine.pipeline.StepPipeline`: resume
from the latest checkpoint when one is ahead of the live state, batches
prefetched on a background thread, periodic atomic checkpoints written
off-thread (`CheckpointCallback`, the async manager), a SIGTERM save,
straggler monitoring (`StragglerCallback`) and, for drills, injected
node failures (`FailureInjectionCallback`). The elastic driver
(`pipeline.fit_elastic`) and the adaptive-batch driver
(`control.resize.fit_adaptive`) rebuild sessions around it and attach
their logs (`elastic_log`, `resize_log`). With combine_delay=1 the state
carries the pending carry (`state["pending"]`), which checkpoints hold,
and `use_delayed_stream` runs its correction beside the local step.

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

Checkpoints across ranks are the reference's files. Params (and state at
the `pre` point) are replicated bitwise, so rank 0's copy is the
checkpoint, and only rank 0 writes. At the `post` point each rank holds
its own lane's optimizer state with no lane axis; a save gathers it to
rank 0 one leaf at a time as the reference's full logical leaf
[span, ...] (lane l is rank l·g's state, g = dp / span ranks a lane), and
a restore gives each rank its own lane's row. The delayed combine's
pending carry is one lane a rank at every point, and goes the same way:
the checkpoint holds the reference's [span, ...] fp32 leaves under
`['pending']`. A restore across a span change reshards the stored
[old span, ...] leaf to [span, ...] before it takes the rank's row (the
reference's `reshard_lanes` of the full leaf). Saves and restores are
collective: every rank calls them; rank 0 validates a restore, and the
other ranks take its integrity counters. With more ranks than the span
asked (`span > world`, as after an elastic shrink) `from_config` clamps
the span to 0, one lane a rank, as the reference does for span > dp.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpoint import AsyncCheckpointManager, CheckpointManager
from repro_torch.checkpoint.manager import HostLeaf, host_leaf, lane_row
from repro_torch.control.noise import STAT_KEYS
from repro_torch.control.telemetry import run_fingerprint
from repro_torch.data import make_source
from repro_torch.models import build_model
from repro_torch.models.api import Model
from repro_torch.parallel.comm import Comm
from repro_torch.runtime import (DeviceLike, FailureInjector, StepMonitor,
                                 make_generator, resolve_device)

from .build import Runtime, build_runtime, make_serve_step
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


class CheckpointCallback(Callback):
    """Periodic atomic checkpoints + final save via the session manager."""

    def __init__(self, every: int = 50):
        self.every = every

    def on_step_end(self, session, step, metrics, dt):
        # every <= 0: periodic saves off — only the final on_fit_end save
        if session.checkpoint and self.every > 0 \
                and (step + 1) % self.every == 0:
            session.save(step + 1)

    def on_fit_end(self, session, history):
        if session.checkpoint and history:
            session.save(int(history[-1]["step"]) + 1)


class StragglerCallback(Callback):
    """Feeds step wall-times to the robust z-score StepMonitor."""

    def __init__(self, monitor: Optional[StepMonitor] = None):
        self.monitor = monitor or StepMonitor()

    def on_step_end(self, session, step, metrics, dt):
        self.monitor.observe(dt)

    def on_fit_end(self, session, history):
        if session.rank == 0:
            print(f"[train] monitor={self.monitor.summary()}")


class FailureInjectionCallback(Callback):
    """Recovery drills: raise at scheduled steps (simulated node loss)."""

    def __init__(self, fail_at: Sequence[int]):
        self.injector = FailureInjector(list(fail_at))

    def on_step_start(self, session, step):
        self.injector.check(step)


def default_callbacks(cfg: EngineConfig,
                      fail_at: Sequence[int] = ()) -> List[Callback]:
    cbs: List[Callback] = [LoggingCallback(cfg.log_every),
                           StragglerCallback()]
    if cfg.ckpt_dir:
        cbs.append(CheckpointCallback(cfg.ckpt_every))
    if fail_at:
        cbs.insert(0, FailureInjectionCallback(fail_at))
    return cbs


class TrainSession:
    """One training run on one device or as one rank of several: config ->
    (model, runtime, data, state)."""

    def __init__(self, config: EngineConfig, model: Model, runtime: Runtime,
                 source, generator: torch.Generator,
                 callbacks: Optional[List[Callback]] = None,
                 owns_comm: bool = False,
                 checkpoint: Optional[CheckpointManager] = None,
                 mesh=None):
        self.config = config
        # the (data, model) grid of the ranks (`launch.mesh.Mesh`)
        self.mesh = mesh
        self.model = model
        self.runtime = runtime
        self.source = source
        self.device = generator.device
        self.comm = runtime.comm
        self.rank = self.comm.rank if self.comm is not None else 0
        self._owns_comm = owns_comm
        self.callbacks = (default_callbacks(config) if callbacks is None
                          else list(callbacks))
        self.checkpoint = checkpoint
        self.state: PyTree = runtime.init_state(generator)
        self._last_stats: Dict[str, float] = {}
        self._delayed_stream = None
        # attached by the drivers: fit_elastic's shared restart log, and
        # fit_adaptive's executed resize plans
        self.elastic_log: Optional[Dict[str, Any]] = None
        self.resize_log: List[Dict[str, Any]] = []

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
        stays the caller's. The ranks form `config.rank_mesh(world)`;
        with a model axis, `pad_heads` pads for its size and each model
        group trains tensor-parallel (`engine.build`)."""
        config.validate()
        world = (comm.world if comm is not None
                 else int(os.environ.get("WORLD_SIZE", "1")))
        mesh = config.rank_mesh(world)
        dp, tp = mesh.axis_size("data"), mesh.axis_size("model")
        dev = session_device(device, generator, world)
        gen = generator if generator is not None else make_generator(dev)
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, session on {dev}")
        if model is None:
            if not config.arch:
                raise ValueError("EngineConfig.arch is empty — pass a "
                                 "built Model via from_config(model=...)")
            model = build_model(
                config.model_config(tp),
                param_dtype=getattr(torch, config.param_dtype),
                attn_chunk=min(config.attn_chunk, config.seq_len))
        owns = comm is None and world > 1
        if owns:
            comm = Comm.init(dist_backend or ("nccl" if dev.type == "cuda"
                                              else "gloo"), dev)
        try:
            # span can't exceed the data ranks: one lane a rank (the
            # reference's clamp of span > dp, session.py:177-180)
            if world > 1 and config.span > dp:
                config = dataclasses.replace(config, span=0)
            # the span and batch checks come after the model's family check
            config.validate(dp_total=dp)
            runtime = build_runtime(model, config.run_policy(), lr=config.lr,
                                    strict=config.strict,
                                    combine_impl=combine_impl, comm=comm,
                                    model_size=tp)
            source = make_source(config.data_config(model.cfg.vocab_size),
                                 model.cfg)
            ckpt = None
            if config.ckpt_dir:
                ckpt = (AsyncCheckpointManager if config.async_checkpoint
                        else CheckpointManager)(config.ckpt_dir)
            return cls(config, model, runtime, source, gen, callbacks,
                       owns_comm=owns, checkpoint=ckpt, mesh=mesh)
        except BaseException:
            if owns:
                comm.close()
            raise

    def run_metadata(self) -> Dict[str, Any]:
        """What actually ran: the resolved combine path, the topology, the
        CombineStats keys seen last, the fault-recovery counts and the
        run's fingerprint (git SHA, config hash)."""
        rt = self.runtime
        return {"arch": self.config.arch or self.model.cfg.name,
                "combine": self.config.combine,
                "backend": self.config.backend,
                "combine_path": rt.combine_path,
                "combine_point": rt.dopt.point,
                "span": rt.span,
                "dp": rt.dp_total,
                "local_steps": self.config.local_steps,
                "combine_delay": self.config.combine_delay,
                "devices": 1,
                "device": str(self.device),
                "world": self.comm.world if self.comm else 1,
                "data_mesh": rt.dp_total,
                "model_mesh": rt.model_size,
                "dist_backend": self.comm.backend if self.comm else "none",
                "staged_bytes": (self.comm.total_staged_bytes()
                                 if self.comm else 0),
                "stats_enabled": rt.combine_stats,
                "combine_stats": dict(self._last_stats),
                "adaptive_batch": self.config.adaptive_batch,
                "global_batch": self.config.global_batch,
                "lr": self.config.lr,
                "resilience": self._resilience_metadata(),
                **run_fingerprint(self.config)}

    def _resilience_metadata(self) -> Dict[str, Any]:
        """Fault-recovery accounting for the run: checkpoint restore
        fallbacks and quarantined steps (from the manager) and the
        elastic restart / grow-back counts (attached by fit_elastic),
        cumulative across elastic rebuilds: earlier sessions' counters
        are banked in elastic_log."""
        log = self.elastic_log or {}
        out: Dict[str, Any] = {
            "restore_fallbacks": log.get("prior_restore_fallbacks", 0),
            "quarantined_steps": list(log.get("prior_quarantined", [])),
            "restarts": log.get("restarts", 0),
            "grow_backs": log.get("grow_backs", 0)}
        if self.checkpoint is not None:
            out["restore_fallbacks"] += self.checkpoint.restore_fallbacks
            out["quarantined_steps"] += [
                q["step"] for q in self.checkpoint.quarantined]
        return out

    def use_delayed_stream(self, comm_delay: float = 0.0):
        """Route steps through a `DelayedCombineStream`: the pending
        carry's correction runs on a thread and CUDA stream of its own
        (after `comm_delay` seconds of injected interconnect latency)
        while the local step computes, and metrics gain compute_s /
        combine_wait_s. The same states, bitwise, as the single-program
        step. Needs combine_delay=1."""
        from repro_torch.runtime import DelayedCombineStream
        if self._delayed_stream is not None:
            self._delayed_stream.close()
        self._delayed_stream = DelayedCombineStream(
            self.runtime, comm_delay=comm_delay)
        return self._delayed_stream

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
        step = (self._delayed_stream.step if self._delayed_stream is not None
                else self.runtime.train_step)
        self.state, metrics = step(self.state, batch)
        out = {k: float(v) for k, v in metrics.items()}
        stats = {k: out[k] for k in STAT_KEYS if k in out}
        if stats:
            self._last_stats = stats
        return out

    def fit(self, steps: Optional[int] = None) -> List[Dict[str, float]]:
        """Train to `steps` total (resuming from the latest checkpoint when
        one is ahead of the live state). Returns the per-step history.
        The loop itself lives in `repro_torch.engine.pipeline`."""
        from .pipeline import StepPipeline
        steps = self.config.steps if steps is None else steps
        self.config = dataclasses.replace(self.config, steps=steps)
        return StepPipeline(self).run()

    # ------------------------------------------------------------ checkpoints
    def _ranked(self) -> bool:
        return self.comm is not None and self.comm.world > 1

    def _lane_state(self) -> bool:
        """Whether each rank holds only its own lane's optimizer state
        (whole: a sharded plan says how it is held instead)."""
        rt = self.runtime
        return (self._ranked() and rt.plan is None
                and rt.dopt.point == "post" and rt.span > 1)

    def _from_rank0(self, value: int) -> int:
        """Rank 0's int on every rank (a barrier too: every rank waits for
        rank 0 to get here)."""
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        return int(self.comm.broadcast(t, 0).item())

    def _lane_trees(self) -> List[str]:
        """The parts of the state that hold one lane a rank: the
        optimizer state at the post point, the pending carry."""
        out = ["inner"] if self._lane_state() else []
        if self._ranked() and "pending" in self.state:
            out.append("pending")
        return out

    def _gather_lanes(self, x: torch.Tensor) -> Optional[HostLeaf]:
        """The lanes' state leaf -> the reference's [span, ...] leaf on
        rank 0's host (None elsewhere): lane l is rank l·g's copy (g =
        world / span ranks a lane), and only those ranks send; collective."""
        g = self.comm.world // self.runtime.span
        rows = self.comm.gather_to_host(
            x, [l * g for l in range(self.runtime.span)])
        return None if rows is None else host_leaf(rows)

    def _save_tree(self) -> Optional[PyTree]:
        """The tree the checkpoint holds (rank 0), None on other ranks;
        collective when a rank holds a lane or a shard."""
        if not self._ranked():
            return self.state
        plan = self.runtime.plan
        parts = self._lane_trees()
        if not parts and plan is None:
            return self.state if self.rank == 0 else None
        st = self.state
        tree = dict(st, opt=dict(st["opt"]))
        if plan is not None:
            tree["params"] = plan.gather_tree(st["params"], "params")
            tree["opt"]["inner"] = _param_trees(
                st["opt"]["inner"], lambda t: plan.gather_tree(t, "state"))
        elif "inner" in parts:
            tree["opt"]["inner"] = T.map(self._gather_lanes,
                                         st["opt"]["inner"])
        if "pending" in parts:
            tree["pending"] = T.map(self._gather_lanes, st["pending"])
        return tree if self.rank == 0 else None

    def _manager(self):
        if self.checkpoint is None:
            raise ValueError("no ckpt_dir configured: the session has no "
                             "checkpoint manager")
        return self.checkpoint

    def latest_step(self) -> Optional[int]:
        """The newest checkpoint step (rank 0's view on every rank)."""
        self._manager()
        if not self._ranked():
            return self.checkpoint.latest_step()
        latest = self.checkpoint.latest_step() if self.rank == 0 else 0
        got = self._from_rank0(-1 if latest is None else latest)
        return None if got < 0 else got

    def save(self, step: Optional[int] = None):
        """Checkpoint the state as `step` (default: the state's own step
        counter); the write runs on the manager's thread when it is the
        async one."""
        self._manager()
        step = self.state["step"] if step is None else step
        tree = self._save_tree()
        if tree is None:
            return self.checkpoint.root / f"step_{step:08d}"
        return self.checkpoint.save(step, tree)

    def save_sync(self, step: Optional[int] = None):
        """save() + barrier: the checkpoint is durably on disk on return
        (the async writer only guarantees that at the next barrier), on
        every rank. The path for SIGTERM handlers."""
        path = self.save(step)
        wait = getattr(self.checkpoint, "wait", None)
        if wait is not None:
            wait()
        if self._ranked():
            self._from_rank0(0)
        return path

    def restore(self, step: Optional[int] = None) -> int:
        """Restore the state from the latest (or given) checkpoint, if
        any, into the live tensors (each leaf copied onto the session's
        device in the live leaf's dtype, one at a time). Returns the
        resumed step (0 when there is nothing to restore)."""
        self._manager()
        if step is None and self.latest_step() is None:
            return 0
        rows = {}
        parts = self._lane_trees()
        if parts:
            span = self.runtime.span
            lane = self.rank // (self.comm.world // span)
            where = {"inner": ("['opt']['inner']", self.state["opt"]
                               .get("inner")),
                     "pending": ("['pending']", self.state.get("pending"))}
            rows = {prefix + T.keystr(p): (lane, span) for part in parts
                    for prefix, tree in [where[part]]
                    for p, _ in T.flatten_with_path(tree)[0]}
        if self._ranked() and self.runtime.plan is not None:
            rows.update(self._shard_rows())
        if self._ranked():
            # rank 0 validates (and quarantines) first; the others then
            # read the step it settled on, and take its counters
            ck = self.checkpoint
            if self.rank == 0:
                self.state = ck.restore(self.state, step, rows)
            step, ck.restore_fallbacks, ck.quarantined = \
                self.comm.broadcast_object(
                    (self.state["step"], ck.restore_fallbacks,
                     ck.quarantined) if self.rank == 0 else None)
            if self.rank != 0:
                self.state = ck.restore(self.state, step, rows)
        else:
            self.state = self.checkpoint.restore(self.state, step, rows)
        start = self.state["step"]
        if self.rank == 0:
            print(f"[train] resumed from step {start}")
        return start

    def _shard_rows(self) -> Dict[str, Any]:
        """Per manifest path of the params and the optimizer state, how
        this rank takes its part of the stored full leaf under the plan
        (the lane state's row first, resharded to this run's span)."""
        plan, span = self.runtime.plan, self.runtime.span
        lane = plan.coords["lane"]
        out: Dict[str, Any] = {}

        def add(prefix, tree, which):
            for i, (p, _) in enumerate(T.flatten_with_path(tree)[0]):
                if plan.lanes(which):
                    shape = plan.shapes[i]
                    how = lambda a, dt, i=i, shape=shape: plan.take(
                        i, lane_row(a, lane, span, shape, dt), which)
                else:
                    how = lambda a, dt, i=i: plan.take(i, a, which)
                out[prefix + T.keystr(p)] = how

        add("['params']", self.state["params"], "params")
        inner = self.state["opt"]["inner"]
        if isinstance(inner, dict):
            for k, sub in inner.items():
                add(f"['opt']['inner'][{k!r}]", sub, "state")
        return out

    def close(self) -> None:
        """Release background resources (the async checkpoint writer,
        after its pending write) and destroy the process group the
        session started. The session is done after this."""
        if self._delayed_stream is not None:
            self._delayed_stream.close()
            self._delayed_stream = None
        close = getattr(self.checkpoint, "close", None)
        try:
            if close is not None:
                close()
        finally:
            if self._owns_comm:
                self.comm.close()
                self._owns_comm = False


def _param_trees(inner: PyTree, fn) -> PyTree:
    """`fn` over each params-shaped tree of an optimizer state ({'m': ...,
    'v': ...}; sgd's is empty)."""
    if isinstance(inner, dict):
        return {k: fn(v) for k, v in inner.items()}
    return inner


def session_device(device: DeviceLike, generator: Optional[torch.Generator],
                   world: int) -> torch.device:
    """The device a training run takes: `device`, else the generator's,
    else cuda; with more than one rank a bare `cuda` is
    `cuda:LOCAL_RANK`."""
    local_rank = (int(os.environ.get("LOCAL_RANK", "0")) if world > 1
                  else None)
    return resolve_device(device if device is not None or generator is None
                          else generator.device, local_rank=local_rank)


# ---------------------------------------------------------------- ServeSession
class ServeSession:
    """Legacy batched serving (session.py:344-441), a thin wrapper over
    `ServeEngine`: `generate(prompts, gen_len)` submits one request per
    row and drains the engine. `stepped_prefill=True` runs the old loop
    instead — the prompt fed one token at a time through the greedy
    serve step on a dense cache with one shared position, then greedy
    decode: the stepped reference the engine's paths are held to.
    Frontend and encoder-decoder models (per-batch encoder state, not
    per-slot) always take the stepped loop."""

    def __init__(self, config: EngineConfig, model: Model, params: PyTree,
                 checkpoint=None, loaded_step: Optional[int] = None):
        self.config = config
        self.model = model
        self.params = params
        self.checkpoint = checkpoint
        self._loaded_step = loaded_step
        self._step = make_serve_step(model)
        self._engine = None                     # built lazily

    @classmethod
    def from_config(cls, config: EngineConfig, *,
                    model: Optional[Model] = None,
                    params: Optional[PyTree] = None,
                    device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None,
                    mesh=None) -> "ServeSession":
        """Model and params as `ServeEngine.from_config` builds them (on
        `device`, `cuda` unless the caller says otherwise; with
        `ckpt_dir`, the latest checkpoint's params; heads padded for the
        mesh's model size under `pad_heads`)."""
        from .serving.engine import resolve_serve_parts
        model, params, checkpoint, loaded_step = resolve_serve_parts(
            config, model=model, params=params, device=device,
            generator=generator, mesh=mesh)
        return cls(config, model, params, checkpoint=checkpoint,
                   loaded_step=loaded_step)

    def engine(self, max_len: Optional[int] = None):
        """The ServeEngine behind this session: one engine, built lazily
        and rebuilt larger (capacity a power of two) when a call needs
        more. It shares the session's checkpoint manager."""
        from .serving import ServeEngine
        need = max_len or self.config.max_len or self.config.seq_len
        if self._engine is None or self._engine.max_len < need:
            cap = 1 << (need - 1).bit_length()
            cfg = dataclasses.replace(self.config, max_len=cap)
            self._engine = ServeEngine(cfg, self.model, self.params,
                                       checkpoint=self.checkpoint,
                                       loaded_step=self._loaded_step)
        return self._engine

    def generate(self, prompts, gen_len: int, max_len: Optional[int] = None,
                 frontend_embeds=None,
                 stepped_prefill: bool = False) -> torch.Tensor:
        """prompts: [B, T] int token ids (array or tensor). Returns
        [B, T+gen_len] int32 on the params' device: the prompts and the
        greedy continuations. Frontend and encoder-decoder models (and
        any call with `frontend_embeds`) take the stepped loop, as in the
        reference (session.py:401-418)."""
        dev = self.params["embed"]["table"].device
        prompts = torch.as_tensor(np.asarray(prompts, np.int32)).to(dev)
        B, T_ = prompts.shape
        max_len = max_len or (T_ + gen_len + 1)
        cfg = self.model.cfg
        if (stepped_prefill or frontend_embeds is not None
                or cfg.is_encoder_decoder or cfg.frontend != "none"):
            if frontend_embeds is not None:
                frontend_embeds = torch.as_tensor(
                    np.asarray(frontend_embeds, np.float32)).to(dev)
            return self._generate_stepped(prompts, gen_len, max_len,
                                          frontend_embeds)
        from .serving import GenerationRequest
        eng = self.engine(max_len)
        handles = [eng.submit(GenerationRequest(
            prompt=prompts[i].cpu().numpy(), max_new_tokens=gen_len))
            for i in range(B)]
        eng.drain()
        return torch.from_numpy(np.stack([h.output for h in handles])).to(
            prompts.device)

    def _generate_stepped(self, prompts: torch.Tensor, gen_len: int,
                          max_len: int, frontend_embeds=None
                          ) -> torch.Tensor:
        """The pre-engine loop: T serve steps over the prompt, then
        gen_len greedy steps, on a dense cache with one shared position
        (no host sync until the caller reads the result). An
        encoder-decoder's cache is built from the frames. A vision
        model's prompt is stepped WITHOUT its projected patches: the
        reference's loop passes them to `init_cache` only for an
        encoder-decoder (session.py:430-434), and the port mirrors it."""
        B, T_ = prompts.shape
        if self.model.cfg.is_encoder_decoder:
            cache = self.model.init_cache(self.params, B, max_len,
                                          frontend_embeds=frontend_embeds)
        else:
            cache = self.model.init_cache(self.params, B, max_len)
        nxt = prompts[:, :1]
        for t in range(T_):
            nxt, cache = self._step(self.params, prompts[:, t:t + 1], cache)
        cur, gen = nxt, []
        for _ in range(gen_len):
            gen.append(cur)
            cur, cache = self._step(self.params, cur, cache)
        return torch.cat([prompts] + gen, dim=1)
