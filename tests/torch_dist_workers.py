"""Rank processes for the port's multi-rank CPU tests (a helper module,
not a test file).

`launch(world, job, spec, tmp_path)` starts `world` processes of this
file, one per rank, with the environment `torch.distributed.run` would
give them (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE), one thread
each, over gloo with a `file://` store under tmp_path. Each runs
`JOBS[job](comm, spec)` and saves what it returns to `rank<r>.pt`. A
rank that fails fails the launch; a launch that outlives `timeout`
seconds is killed and fails. Nothing here imports jax.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def launch(world, job, spec, tmp_path, timeout=300, rc=0):
    """Run `job` on `world` ranks; returns each rank's result, by rank.
    With `rc` other than 0 every rank must exit with that code, and the
    ranks' logs are returned instead."""
    tag = f"{job}_w{world}_{int(time.time() * 1e6) % 10**9}"
    out = Path(tmp_path) / tag
    out.mkdir(parents=True)
    spec = dict(spec, store=str(out / "store"), out=str(out),
                timeout=timeout)
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
        log = open(out / f"log{r}.txt", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, job, json.dumps(spec)], env=env,
            stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise AssertionError(f"{job} on {world} ranks outlived "
                                     f"{timeout}s")
            if any(p.poll() not in (None, rc) for p in procs):
                break               # one rank failed: do not wait for the rest
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    texts = [(out / f"log{r}.txt").read_text() for r in range(world)]
    bad = [r for r, p in enumerate(procs) if p.returncode != rc]
    assert not bad, "\n".join(f"--- rank {r} (rc {procs[r].returncode})\n"
                              f"{texts[r][-4000:]}" for r in bad)
    if rc:
        return texts
    import torch
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# -------------------------------------------------------------------- jobs
def _np_tree(tree):
    from repro_torch import tree as T
    leaves, td = T.flatten(tree)
    return T.unflatten(td, [x.detach().float().numpy().copy()
                            if hasattr(x, "detach") else x for x in leaves])


def _same_on_all_ranks(comm, tree) -> bool:
    """Whether every rank holds the same bits of every leaf."""
    import hashlib
    import torch.distributed as dist
    from repro_torch import tree as T
    h = hashlib.sha256()
    for x in T.leaves(tree):
        h.update(x.detach().contiguous().view(-1).numpy().tobytes())
    seen = [None] * comm.world
    dist.all_gather_object(seen, h.hexdigest())
    return len(set(seen)) == 1


def job_rvh(comm, spec):
    """`adasum_rvh_pytree` of this rank's lane over every case of spec;
    per case the combined tree, the CombineStats levels and whether the
    ranks agree bitwise."""
    import numpy as np
    import torch
    from repro_torch.core import rvh
    from repro_torch.core.combine import stack_stats
    lanes = np.load(spec["lanes"])
    keys = spec["keys"]
    out = []
    for case in spec["cases"]:
        mine = {k: torch.from_numpy(lanes[k][comm.rank]).clone()
                for k in keys}
        collect = []
        got = rvh.adasum_rvh_pytree(
            mine, comm, per_layer=case["per_layer"],
            use_pallas=case["use_pallas"], compress=case["compress"],
            bucket_bytes=case["bucket_bytes"], impl=case.get("impl",
                                                             "kernel"),
            donate=True, collect=collect)
        out.append({"tree": _np_tree(got),
                    "levels": stack_stats(collect)["levels"].numpy(),
                    "bitwise": _same_on_all_ranks(comm, got),
                    "staged": comm.staged_bytes})
    if spec.get("local"):       # one bucket, with and without allgather
        seg = lanes["local_seg"]
        metas = rvh._round_metas(seg[::8192].astype(np.int64),
                                 int(seg.max()) + 1, 8192, comm.rank,
                                 comm.world, "cpu")
        run = lambda full: rvh.adasum_rvh_local(
            torch.from_numpy(lanes["local_buf"][comm.rank]).clone(), metas,
            comm, allgather_result=full).numpy()
        out.append({"full": run(True), "owned": run(False),
                    "staged": comm.staged_bytes})
    if spec.get("tp"):          # a (data 2, model 2) grid, TP leaf specs
        mcomm = comm.split([[0, 1], [2, 3]])
        dcomm = comm.split([[0, 2], [1, 3]])
        specs = {k: tuple(s) for k, s in spec["tp"]["specs"].items()}
        mine = {}
        for k in keys:
            x = torch.from_numpy(lanes[k][dcomm.rank]).clone()
            d = next((j for j, e in enumerate(specs[k]) if e == "model"),
                     None)
            if d is not None:
                n = x.shape[d] // 2
                x = x.narrow(d, mcomm.rank * n, n).clone()
            mine[k] = x
        collect = []
        got = rvh.adasum_rvh_pytree(
            mine, dcomm, bucket_bytes=spec["tp"]["bucket"],
            leaf_specs=specs, model_comm=mcomm, donate=True,
            collect=collect)
        whole = {k: v for k, v in got.items() if "model" not in specs[k]}
        out.append({"tree": _np_tree(got), "levels": collect[0].numpy(),
                    "data_bitwise": _same_in(dcomm, got),
                    "model_bitwise": _same_in(mcomm, whole)})
    return out


def job_train(comm, spec):
    """Train steps of every case of spec from the same params and
    batches; per case the losses, CombineStats metrics, final params and
    whether the ranks agreed bitwise after every step."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.configs import get_reduced
    from repro_torch.control.noise import STAT_KEYS
    from repro_torch.engine import build_runtime
    from repro_torch.models import build_model
    from repro_torch.parallel.policy import RunPolicy
    data = np.load(spec["inputs"])
    cfg = get_reduced(spec["arch"])
    model = build_model(cfg, compute_dtype=torch.float32,
                        attn_chunk=spec["attn_chunk"])
    init = {}
    for key in data.files:
        if key.startswith("init/"):
            node = init
            *path, leaf = key[5:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    out = []
    for case in spec["cases"]:
        rt = build_runtime(model, RunPolicy(**case["policy"]),
                           lr=case["lr"], comm=comm)
        params = params_from_numpy(init, device="cpu", cfg=cfg)
        state = {"params": params, "opt": rt.dopt.init(params), "step": 0}
        if rt.correction_fn is not None:        # the delayed zero carry
            state["pending"] = T.map(lambda x: torch.zeros(x.shape),
                                     params)
        losses, stats, bitwise = [], [], []
        for s in range(case["steps"]):
            batch = {k: torch.from_numpy(data[f"batch{s}/{k}"])
                     for k in ("tokens", "labels")}
            state, m = rt.train_step(state, batch)
            losses.append(float(m["loss"]))
            stats.append({k: float(m[k]) for k in STAT_KEYS if k in m})
            bitwise.append(_same_on_all_ranks(comm, state["params"]))
        out.append({"losses": losses, "stats": stats, "bitwise": bitwise,
                    "path": rt.combine_path,
                    "params": params_to_numpy(state["params"])})
    return out


def job_ckpt(comm, spec):
    """A TrainSession across the ranks with a checkpoint directory: fit to
    step 1, save it, fit to step 2; then restore step 1 in place and
    redo the step. Rank 0 also takes step 1 as one process with the
    lanes stacked and saves it (the single-process layout). Returns the
    uninterrupted and the resumed states and whether every leaf agrees
    bitwise."""
    import torch
    from repro_torch import tree as T
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.engine import EngineConfig, TrainSession, build_runtime
    from repro_torch.models import build_model
    model = build_model(get_reduced(spec["arch"]),
                        compute_dtype=torch.float32,
                        attn_chunk=spec["attn_chunk"])
    cfg = EngineConfig(**spec["config"], ckpt_dir=spec["dir"])
    s = TrainSession.from_config(
        cfg, model=model, device="cpu", comm=comm, callbacks=[],
        generator=torch.Generator().manual_seed(spec["seed"]))
    s.fit(1)
    s.save_sync(1)
    s.fit(2)
    full = [x.clone() if isinstance(x, torch.Tensor) else x
            for x in T.leaves(s.state)]
    live = [x for x in T.leaves(s.state) if isinstance(x, torch.Tensor)]
    assert s.restore(1) == 1
    # restored in place: the session's own tensors hold step 1 again
    assert all(a is b for a, b in zip(
        live, [x for x in T.leaves(s.state) if isinstance(x, torch.Tensor)]))
    s.step()
    again = T.leaves(s.state)
    same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(full, again))
    if comm.rank == 0:
        one = dataclasses.replace(cfg, span=cfg.span or comm.world,
                                  backend="gspmd_tree", ckpt_dir="")
        rt = build_runtime(model, one.run_policy(), lr=one.lr)
        params = model.init(torch.Generator().manual_seed(spec["seed"]))
        state = {"params": params, "opt": rt.dopt.init(params), "step": 0}
        state, _ = rt.train_step(state, s.batch(0))
        CheckpointManager(spec["single"]).save(1, state)
    return {"resumed_bitwise": same, "world_leaves": len(full),
            "inner": _np_tree(s.state["opt"]["inner"])}


def job_gather(comm, spec):
    """`Comm.gather_to_host` of a tensor holding rank + 1 from spec's
    source ranks onto rank 0, in 16-byte gloo messages; the rows (rank 0)
    and the bytes counted staged."""
    import torch
    import torch.distributed as dist
    from repro_torch.parallel import comm as C
    C.CHUNK_BYTES = 16
    x = torch.full((3, 5), float(comm.rank + 1))
    rows = comm.gather_to_host(x, spec["srcs"])
    dist.barrier()
    return {"rows": None if rows is None else rows.numpy(),
            "staged": comm.total_staged_bytes()}


def job_delayed(comm, spec):
    """The delayed combine across the ranks through a TrainSession with a
    checkpoint directory: the build's warnings and combine path, the
    cold-start correction, then 3 single-program steps (step 2 saved),
    and step 3 redone from the restored step 2 through the stream and
    through its serial step. Returns checksums of params and the pending
    carry after each, and whether the ranks agree on them."""
    import hashlib
    import warnings
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_reduced
    from repro_torch.engine import EngineConfig, TrainSession
    from repro_torch.engine.build import EngineWarning
    from repro_torch.models import build_model
    from repro_torch.runtime import DelayedCombineStream
    model = build_model(get_reduced(spec["arch"]),
                        compute_dtype=torch.float32,
                        attn_chunk=spec["attn_chunk"])
    cfg = EngineConfig(**spec["config"], ckpt_dir=spec["dir"])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        s = TrainSession.from_config(
            cfg, model=model, device="cpu", comm=comm, callbacks=[],
            generator=torch.Generator().manual_seed(spec["seed"]))
    warned = [str(w.message) for w in rec
              if issubclass(w.category, EngineWarning)]
    zero = all(bool((x == 0).all()) for x in T.leaves(
        s.runtime.correction_fn(s.state["pending"])))

    def digest():
        h = hashlib.sha256()
        for x in T.leaves([s.state["params"], s.state["pending"]]):
            h.update(x.detach().clone().view(-1).numpy().tobytes())
        return h.hexdigest()

    s.fit(2)
    s.save_sync(2)
    s.fit(3)
    out = {"single": digest()}
    assert s.restore(2) == 2
    s.use_delayed_stream(comm_delay=0.01)
    m = s.step()
    out["stream"] = digest()
    out["split_keys"] = sorted(k for k in ("compute_s", "combine_wait_s")
                               if k in m)
    assert s.restore(2) == 2
    serial = DelayedCombineStream(s.runtime)
    s.state, _ = serial.serial_step(s.state, s.batch(2))
    serial.close()
    out["serial"] = digest()
    # params are replicated; the carry is each rank's own lane
    out["params_same_on_all_ranks"] = _same_on_all_ranks(
        comm, s.state["params"])
    out.update(warned=warned, zero=zero, path=s.run_metadata()[
        "combine_path"], delay=s.run_metadata()["combine_delay"])
    s.close()
    return out


def _model(spec):
    """spec's model: the reference control tests' tiny dense decoder
    ("tiny"), or a reduced preset, fp32 compute."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import build_model
    cfg = (ModelConfig("ctl-tiny", "dense", 2, 64, 4, 2, 128, 257,
                       head_dim=16) if spec["arch"] == "tiny"
           else get_reduced(spec["arch"]))
    return build_model(cfg, compute_dtype=torch.float32,
                       attn_chunk=spec["attn_chunk"])


def _digest(tree) -> str:
    import hashlib
    from repro_torch import tree as T
    h = hashlib.sha256()
    for x in T.leaves(tree):
        h.update(x.detach().contiguous().view(-1).numpy().tobytes())
    return h.hexdigest()


class _Record:
    """Every step start (step, batch checksum), every fit start (start,
    dp, span) and the params' digest after every step, keyed by the
    session's place in the run (rebuilds so far, step)."""

    def __init__(self, rank):
        self.rank = rank
        self.seen, self.dps, self.sums, self.digests = [], [], [], {}

    def _segment(self, session):
        log = session.elastic_log or {}
        return (log.get("restarts", 0) + log.get("grow_backs", 0)
                + len(session.resize_log))

    def on_fit_start(self, session, start):
        self.dps.append((start, session.runtime.dp_total,
                         session.runtime.span))

    def on_step_start(self, session, step):
        import numpy as np
        self.seen.append(step)
        self.sums.append((step, float(np.asarray(
            session.batch(step)["tokens"], np.float64).sum())))

    def on_step_end(self, session, step, metrics, dt):
        self.digests[(self._segment(session), step)] = _digest(
            session.state["params"])

    def on_fit_end(self, session, history):
        pass


def _flag_on(rank, at):
    """A callback flagging this rank's straggler monitor after step
    `at` (on `rank` only)."""
    from repro_torch.engine import StragglerCallback

    class Flag:
        def on_fit_start(self, session, start): ...

        def on_step_start(self, session, step): ...

        def on_fit_end(self, session, history): ...

        def on_step_end(self, session, step, metrics, dt):
            if step == at and session.rank == rank:
                for cb in session.callbacks:
                    if isinstance(cb, StragglerCallback):
                        cb.monitor.flagged = True
    return Flag()


def _term_in_window(step, below):
    """SIGTERM to this process at `step`'s start in a session of fewer
    than `below` ranks: the window after an elastic rebuild."""
    import os
    import signal

    class Term:
        def on_fit_start(self, session, start): ...

        def on_step_end(self, session, step, metrics, dt): ...

        def on_fit_end(self, session, history): ...

        def on_step_start(self, session, s):
            if session.runtime.dp_total < below and s == step:
                os.kill(os.getpid(), signal.SIGTERM)
    return Term()


def job_elastic(comm, spec):
    """`fit_elastic` across the ranks with the callbacks spec names:
    FailureInjectionCallback(fail_at), a ChaosCallback and
    make_chaos_on_restart over spec's events, CapacityReturnCallback
    (grow_delay), a straggler flag on one rank, SIGTERM in the rebuild
    window. Returns what the run saw on this rank: the steps started, fit
    starts, batch checksums, params digests, history, elastic log,
    resilience and lr, and the final params."""
    import torch
    from repro_torch.bridge import params_to_numpy
    from repro_torch.chaos import (CapacityReturnCallback, ChaosCallback,
                                   ChaosSchedule, FaultEvent,
                                   make_chaos_on_restart)
    from repro_torch.engine import (CheckpointCallback, EngineConfig,
                                    FailureInjectionCallback,
                                    LoggingCallback, StragglerCallback,
                                    fit_elastic)
    cfg = EngineConfig(**spec["config"], ckpt_dir=spec["dir"])
    rec = _Record(comm.rank)
    cbs = [LoggingCallback(1), StragglerCallback(), rec]
    if cfg.ckpt_every:
        cbs.append(CheckpointCallback(cfg.ckpt_every))
    if spec.get("fail_at"):
        cbs.append(FailureInjectionCallback(spec["fail_at"]))
    sched = ChaosSchedule([FaultEvent(*e) for e in spec.get("chaos", [])])
    cbs.append(ChaosCallback(sched))
    if spec.get("grow_delay"):
        cbs.append(CapacityReturnCallback(delay=spec["grow_delay"]))
    if spec.get("flag"):
        cbs.append(_flag_on(*spec["flag"]))
    if spec.get("term"):
        cbs.append(_term_in_window(*spec["term"]))
    hist, sess = fit_elastic(
        cfg, spec["steps"], callbacks=cbs, model=_model(spec),
        device="cpu", generator=torch.Generator().manual_seed(spec["seed"]),
        comm=comm, on_restart=make_chaos_on_restart(sched, spec["dir"]))
    out = {"seen": rec.seen, "dps": rec.dps, "sums": rec.sums,
           "digests": rec.digests, "hist": [h["step"] for h in hist],
           "losses": [h["loss"] for h in hist], "log": sess.elastic_log,
           "resilience": sess.run_metadata()["resilience"],
           "lr": sess.config.lr, "dp": sess.runtime.dp_total,
           "pending": [e.kind for e in sched.pending()],
           "params": (None if sess.state is None       # parked at the end
                      else params_to_numpy(sess.state["params"]))}
    sess.close()
    return out


def job_compose(comm, spec):
    """The elastic run of job_elastic composed by hand from plain
    sessions, one a segment: spec's `segments` list (world, from step, to
    step, lr, fail step or None); each segment's ranks restore the last
    checkpoint and fit to its end, then save it. Returns the final params
    (rank 0)."""
    import dataclasses
    import torch
    from repro_torch.bridge import params_to_numpy
    from repro_torch.engine import EngineConfig, TrainSession
    cfg = EngineConfig(**spec["config"], ckpt_dir=spec["dir"])
    model = _model(spec)
    out, live = None, comm
    for world, stop, lr in spec["segments"]:
        comm.align_groups()
        if world != live.world:
            live = comm if world == comm.world else comm.split(
                [list(range(world)), list(range(world, comm.world))])
        if comm.rank < world:
            s = TrainSession.from_config(
                dataclasses.replace(cfg, lr=lr), model=model, device="cpu",
                comm=live, callbacks=[],
                generator=torch.Generator().manual_seed(spec["seed"]))
            s.fit(stop)
            s.save_sync()
            out = params_to_numpy(s.state["params"])
            s.close()
        comm.broadcast_object(None)       # every rank waits for them
    return {"params": out}


def job_lanes(comm, spec):
    """The lane-state restore across a span change at the post point:
    save at `world` ranks (adam, span auto: one lane a rank), restore on
    the first `world // 2` ranks of a split (a fold), and save on them and
    restore at `world` (a repeat). Returns each restore's inner state
    (and pending carry) on this rank, or None where it took no part."""
    import torch
    from repro_torch.engine import EngineConfig, TrainSession
    model = _model(spec)
    W = comm.world
    out = {}
    for tag, fields in spec["cases"].items():
        base = EngineConfig(**fields, ckpt_dir=spec["dir"] + "/" + tag)

        def session(c):
            return TrainSession.from_config(
                base, model=model, device="cpu", comm=c, callbacks=[],
                generator=torch.Generator().manual_seed(spec["seed"]))

        full = session(comm)
        full.fit(1)
        full.save_sync(1)
        full.close()
        half = comm.split([list(range(W // 2)), list(range(W // 2, W))])
        folded = None
        if comm.rank < W // 2:
            s = session(half)
            assert s.restore(1) == 1
            folded = _np_tree({k: s.state[k] for k in ("opt", "pending")
                               if k in s.state})
            s.step()
            s.save_sync(2)
            s.close()
        comm.broadcast_object(None)
        comm.align_groups()
        s = session(comm)
        assert s.restore(2) == 2
        grown = _np_tree({k: s.state[k] for k in ("opt", "pending")
                          if k in s.state})
        s.close()
        out[tag] = {"folded": folded, "grown": grown}
    return out


def job_adaptive(comm, spec):
    """`fit_adaptive` across the ranks (the real BatchController on spec's
    config), then a plain session at the first resize's operating point
    restored from its boundary checkpoint and fit to the end. Returns
    what the run saw on this rank, its resize log, LR and final params,
    and the plain session's final params."""
    import dataclasses
    import torch
    from repro_torch.bridge import params_to_numpy
    from repro_torch.control import fit_adaptive
    from repro_torch.control.resize import apply_resize, log_effective
    from repro_torch.engine import EngineConfig, TrainSession
    from repro_torch.runtime import ResizePlan
    cfg = EngineConfig(**spec["config"], ckpt_dir=spec["dir"])
    model = _model(spec)
    rec = _Record(comm.rank)

    class Rows:
        rows = []

        def on_fit_start(self, session, start): ...

        def on_step_end(self, session, step, metrics, dt): ...

        def on_fit_end(self, session, history): ...

        def on_step_start(self, session, step):
            self.rows.append((step, session.config.global_batch,
                              int(session.batch(step)["tokens"].shape[0])))

    gen = lambda: torch.Generator().manual_seed(spec["seed"])
    hist, sess = fit_adaptive(cfg, spec["steps"], callbacks=[rec, Rows()],
                              model=model, device="cpu", generator=gen(),
                              comm=comm)
    eff = log_effective(sess)
    out = {"seen": rec.seen, "rows": Rows.rows, "digests": rec.digests,
           "hist": [h["step"] for h in hist],
           "losses": [h["loss"] for h in hist],
           "resize_log": sess.resize_log, "lr": sess.config.lr, "eff": eff,
           "meta": sess.run_metadata(),
           "params": params_to_numpy(sess.state["params"])}
    sess.close()
    first = sess.resize_log[0]
    plan = ResizePlan(**{k: v for k, v in first.items() if k != "step"})
    plain = TrainSession.from_config(
        apply_resize(dataclasses.replace(cfg, adaptive_batch=False), plan),
        model=model, device="cpu", comm=comm, callbacks=[],
        generator=gen())
    assert plain.restore(first["step"]) == first["step"]
    plain.fit(spec["steps"] if len(sess.resize_log) == 1
              else sess.resize_log[1]["step"])
    out["plain_params"] = params_to_numpy(plain.state["params"])
    plain.close()
    return out


def job_shard(comm, spec):
    """The sharded ranked step (ZeRO-1 state, ZeRO-2 lane gradients, FSDP
    params) for every case of spec, from the same params and batches;
    per case the losses, whether the whole leaves agreed bitwise across
    the ranks after every step, each rank's bytes of params and state
    against the plan's `local_shape`, and (rank 0) the params and state
    gathered to full leaves — beside the same steps with the lanes
    stacked on one process (rank 0)."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.bridge import params_from_numpy
    from repro_torch.engine import build_runtime
    from repro_torch.parallel.policy import RunPolicy
    data = np.load(spec["inputs"])
    out = []
    for case in spec["cases"]:
        model = _case_model(case)
        init = _init_tree(data, case["name"])
        rt = build_runtime(model, RunPolicy(**case["policy"]),
                           lr=case["lr"], comm=comm)
        plan = rt.plan
        params = plan.shard_params(params_from_numpy(init, device="cpu"))
        state = {"params": params, "opt": rt.dopt.init(params), "step": 0}
        batches = [{k: torch.from_numpy(data[f"{case['name']}/batch{s}/{k}"])
                    for k in ("tokens", "labels", "frontend_embeds")
                    if f"{case['name']}/batch{s}/{k}" in data.files}
                   for s in range(case["steps"])]
        losses, bitwise = [], []
        for b in batches:
            state, m = rt.train_step(state, b)
            losses.append(float(m["loss"]))
            whole = [x for i, x in enumerate(T.leaves(state["params"]))
                     if plan.dims[i] is None or not plan.fsdp]
            bitwise.append(_same_on_all_ranks(comm, whole))
        nbytes = lambda tree: [x.numel() * x.element_size()
                               for x in T.leaves(tree)]
        want = lambda which, tree: [
            int(np.prod(s)) * x.element_size()
            for s, x in zip(plan.local_shapes(which), T.leaves(tree))]
        inner = state["opt"]["inner"]
        subs = list(inner.values()) if isinstance(inner, dict) else []
        res = {"losses": losses, "bitwise": bitwise, "path": rt.combine_path,
               "sharded_leaves": sum(d is not None for d in plan.dims),
               "params_bytes": (nbytes(state["params"]),
                                want("params", state["params"])),
               "state_bytes": ([nbytes(t) for t in subs],
                               [want("state", t) for t in subs])}
        full_p = plan.gather_tree(state["params"], "params")
        full_s = {k: plan.gather_tree(t, "state") for k, t in
                  (inner.items() if isinstance(inner, dict) else ())}
        if comm.rank == 0:
            res["params"] = _np_tree(full_p)
            res["state"] = {k: _np_tree(t) for k, t in full_s.items()}
            pol = dict(case["policy"], backend="gspmd_tree",
                       span=case["policy"].get("span") or comm.world)
            one = build_runtime(model, RunPolicy(**pol), lr=case["lr"])
            p1 = params_from_numpy(init, device="cpu")
            s1 = {"params": p1, "opt": one.dopt.init(p1), "step": 0}
            for b in batches:
                s1, _ = one.train_step(s1, b)
            res["single_params"] = _np_tree(s1["params"])
            i1 = s1["opt"]["inner"]
            res["single_state"] = {k: _np_tree(t) for k, t in (
                i1.items() if isinstance(i1, dict) else ())}
        out.append(res)
    if spec.get("ckpt"):
        out.append(_shard_ckpt(comm, spec["ckpt"]))
    return out


def _case_model(case):
    import dataclasses
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_reduced(case["arch"]),
                              **case.get("cfg", {}))
    return build_model(cfg, compute_dtype=torch.float32,
                       attn_chunk=case["attn_chunk"])


def _batch(data, name, step):
    """Step `step`'s batch of case `name` from the inputs file: tokens,
    labels and, for a frontend model, frontend_embeds."""
    import torch
    keys = ("tokens", "labels", "frontend_embeds")
    return {k: torch.from_numpy(data[f"{name}/batch{step}/{k}"])
            for k in keys if f"{name}/batch{step}/{k}" in data.files}


def _init_tree(data, prefix):
    init = {}
    for key in data.files:
        if key.startswith(prefix + "/init/"):
            node = init
            *path, leaf = key[len(prefix) + 6:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return init


def _shard_ckpt(comm, spec):
    """A sharded TrainSession on every rank: step 1 saved, then step 2 (the
    uninterrupted run). Ranks 0 and 1 then restore step 1 into a sharded
    world-2 session and take step 2; rank 0 also restores it into one
    process, unsharded, and takes step 2. Returns (rank 0) the gathered
    states and the manifest's leaf shapes."""
    import dataclasses
    import json
    from pathlib import Path
    import torch
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.engine import EngineConfig, TrainSession
    model = _case_model(spec)
    cfg = EngineConfig(**spec["config"], ckpt_dir=spec["dir"])
    gen = lambda: torch.Generator().manual_seed(spec["seed"])

    def full(s):        # a copy: whole leaves are the live tensors
        plan = s.runtime.plan
        inner = s.state["opt"]["inner"]
        return _np_tree((plan.gather_tree(s.state["params"], "params"),
                         {k: plan.gather_tree(v, "state")
                          for k, v in inner.items()}))

    s = TrainSession.from_config(cfg, model=model, device="cpu", comm=comm,
                                 callbacks=[], generator=gen())
    out = {"world4_sharded": sum(d is not None for d in s.runtime.plan.dims)}
    s.fit(1)
    s.save_sync(1)
    saved = full(s)
    s.fit(2)
    after = full(s)
    halves = comm.split([[0, 1], [2, 3]])
    solo = comm.split([[r] for r in range(comm.world)])
    if comm.rank < 2:
        s2 = TrainSession.from_config(cfg, model=model, device="cpu",
                                      comm=halves, callbacks=[],
                                      generator=gen())
        s2.restore(1)
        got = full(s2)
        out["world2_plan"] = (s2.runtime.plan.g, s2.runtime.plan.span)
        s2.step()
        nxt = full(s2)
        if comm.rank == 0:
            out["w2_restored"] = got
            out["w2_next"] = nxt
    dist.barrier()
    if comm.rank == 0:
        one_cfg = dataclasses.replace(cfg, span=cfg.span or comm.world,
                                      backend="gspmd_tree")
        s1 = TrainSession.from_config(one_cfg, model=model, device="cpu",
                                      comm=solo, callbacks=[],
                                      generator=gen())
        s1.restore(1)
        inner = s1.state["opt"]["inner"]
        out["one_restored"] = _np_tree((s1.state["params"], dict(inner)))
        s1.step()
        inner = s1.state["opt"]["inner"]
        out["one_next"] = _np_tree((s1.state["params"], dict(inner)))
        out["saved"] = saved
        out["after"] = after
        man = json.loads((Path(spec["dir"]) / "step_00000001" /
                          "manifest.json").read_text())
        out["manifest"] = {e["path"]: e["shape"] for e in man["leaves"]}
        s1.close()
    dist.barrier()
    return out


def _same_in(comm, tree) -> bool:
    """Whether every rank of `comm` holds the same bits of every leaf."""
    import hashlib
    import torch.distributed as dist
    from repro_torch import tree as T
    h = hashlib.sha256()
    for x in T.leaves(tree):
        h.update(x.detach().contiguous().view(-1).numpy().tobytes())
    seen = [None] * comm.world
    dist.all_gather_object(seen, h.hexdigest(), group=comm.group)
    return len(set(seen)) == 1


def job_tp(comm, spec):
    """The model axis on a (data, model) grid of the 4 ranks: every
    training case of spec from the same params and batches (losses,
    bitwise checks across each data group and, for the leaves the axis
    does not shard, each model group; each rank's param shapes; rank 0:
    params and state gathered to full leaves); RVH of synthetic lanes
    with TP leaf specs on a (2, 2) grid (each rank's result); and a
    checkpoint saved at (2, 2) restored at (4, 1) and in one process,
    and saves of those restored at (2, 2)."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.bridge import params_from_numpy
    from repro_torch.core import rvh
    from repro_torch.engine import build_runtime
    from repro_torch.parallel.policy import RunPolicy
    data = np.load(spec["inputs"])
    out = {"cases": []}
    for case in spec["cases"]:
        model = _case_model(case)
        init = _init_tree(data, case["name"])
        D, M = case["mesh"]
        rt = build_runtime(model, RunPolicy(**case["policy"]),
                           lr=case["lr"], comm=comm, model_size=M)
        plan = rt.plan
        params = plan.shard_params(params_from_numpy(init, device="cpu"))
        state = {"params": params, "opt": rt.dopt.init(params), "step": 0}
        batches = [_batch(data, case["name"], s)
                   for s in range(case["steps"])]
        res = {"losses": [], "data_bitwise": [], "model_bitwise": [],
               "path": rt.combine_path, "dp": rt.dp_total,
               "model": rt.model_size,
               "shapes": [tuple(x.shape) for x in T.leaves(params)],
               "plan_shapes": plan.local_shapes("params"),
               "sharded": sum(d is not None for d in plan.mdims)}
        for b in batches:
            state, m = rt.train_step(state, b)
            res["losses"].append(float(m["loss"]))
            # the state too at the pre point, where ZeRO-1 leaves it
            # whole (at the post point each data rank holds its own
            # lane's)
            inner = state["opt"]["inner"]
            held = [[x for i, x in enumerate(T.leaves(t))
                     if plan.dims[i] is None]
                    for t in (inner.values() if isinstance(inner, dict)
                              else ())] if rt.dopt.point == "pre" else ()
            res["data_bitwise"].append(_same_in(plan.comm, (
                state["params"], held)))
            whole = [x for i, x in enumerate(T.leaves(state["params"]))
                     if plan.mdims[i] is None]
            res["model_bitwise"].append(_same_in(rt.model_comm, whole))
        inner = state["opt"]["inner"]
        full_p = plan.gather_tree(state["params"], "params")
        full_s = {k: plan.gather_tree(t, "state") for k, t in
                  (inner.items() if isinstance(inner, dict) else ())}
        if comm.rank == 0:
            res["params"] = _np_tree(full_p)
            res["state"] = {k: _np_tree(t) for k, t in full_s.items()}
        out["cases"].append(res)
    # RVH on a (2, 2) grid with TP leaf specs
    lanes = np.load(spec["rvh"]["lanes"])
    mcomm = comm.split([[0, 1], [2, 3]])
    dcomm = comm.split([[0, 2], [1, 3]])
    specs = {k: tuple(v) for k, v in spec["rvh"]["specs"].items()}
    mine = {}
    for k, sp in specs.items():
        x = torch.from_numpy(lanes[k][dcomm.rank]).clone()
        d = next((i for i, e in enumerate(sp) if e == "model"), None)
        if d is not None:
            n = x.shape[d] // 2
            x = x.narrow(d, mcomm.rank * n, n).clone()
        mine[k] = x
    collect = []
    got = rvh.adasum_rvh_pytree(
        mine, dcomm, per_layer=True, bucket_bytes=spec["rvh"]["bucket"],
        leaf_specs=specs, model_comm=mcomm, donate=True, collect=collect)
    out["rvh"] = {"tree": _np_tree(got), "levels": collect[0].numpy(),
                  "data_bitwise": _same_in(dcomm, got)}
    if spec.get("ckpt"):
        out["ckpt"] = _tp_ckpt(comm, spec["ckpt"])
    return out


def _tp_ckpt(comm, spec):
    """Checkpoints across grids: a (2, 2) session saves step 1; a (4, 1)
    session and a one-process session (rank 0) restore it; each then
    takes a step and saves it, and a (2, 2) session restores each of
    those. Returns (rank 0) every state, gathered to full leaves."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.engine import EngineConfig, TrainSession
    model = _case_model(spec)
    base = EngineConfig(**spec["config"])
    gen = lambda: torch.Generator().manual_seed(spec["seed"])

    def full(s):
        plan = s.runtime.plan
        inner = s.state["opt"]["inner"]
        if plan is None:
            return _np_tree((s.state["params"], dict(inner)))
        return _np_tree((plan.gather_tree(s.state["params"], "params"),
                         {k: plan.gather_tree(v, "state")
                          for k, v in inner.items()}))

    def session(c, d, mesh, dirname):
        cfg = dataclasses.replace(base, data_mesh=mesh[0],
                                  model_mesh=mesh[1],
                                  ckpt_dir=spec["dir"] + dirname)
        return TrainSession.from_config(cfg, model=model, device="cpu",
                                        comm=c, callbacks=[],
                                        generator=gen())

    out = {}
    s = session(comm, None, (2, 2), "/a")
    out["a_mesh"] = (s.runtime.dp_total, s.runtime.model_size)
    s.fit(1)
    s.save_sync(1)
    out["a_saved"] = full(s)
    s.close()
    s4 = session(comm, None, (4, 1), "/a")
    s4.restore(1)
    out["b_restored"] = full(s4)
    s4.config = dataclasses.replace(s4.config, ckpt_dir=spec["dir"] + "/b")
    s4.checkpoint = type(s4.checkpoint)(spec["dir"] + "/b")
    s4.step()
    s4.save_sync(2)
    out["b_saved"] = full(s4)
    s4.close()
    solo = comm.split([[r] for r in range(comm.world)])
    if comm.rank == 0:
        s1 = session(solo, None, (1, 1), "/a")
        s1.restore(1)
        out["c_restored"] = full(s1)
        s1.checkpoint = type(s1.checkpoint)(spec["dir"] + "/c")
        s1.step()
        s1.save_sync(2)
        out["c_saved"] = full(s1)
        s1.close()
    dist.barrier()
    for tag in ("b", "c"):
        s = session(comm, None, (2, 2), "/" + tag)
        s.restore(2)
        out[tag + "_back"] = full(s)
        s.close()
    return out if comm.rank == 0 else {}


def job_grid(comm, spec):
    """Both axes at once on a (data, model) grid of the ranks: every case
    of spec from the same params and batches, built by `build_runtime` or,
    where the case names a `session`, by `TrainSession.from_config` of the
    preset. Per case: the losses and metrics; whether the leaves whole on
    the data axis agree bitwise across each data group, and those whole
    on both across each model group, after every step; the shapes this
    rank holds of params, optimizer state and the lane gradient (the tree
    the combiner gets); rank 0: params and state gathered to full leaves.
    Then checkpoints between the first case's session and one process
    (`_grid_ckpt`)."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.bridge import params_from_numpy
    from repro_torch.engine import EngineConfig, TrainSession, build_runtime
    from repro_torch.engine import build as B
    from repro_torch.parallel.policy import RunPolicy
    data = np.load(spec["inputs"])
    seen = []
    make = B.make_combiner

    def spy(*a, **kw):               # the first lane tree of a case
        combine = make(*a, **kw)

        def run(tree):
            if not seen:
                seen.append([tuple(x.shape) for x in T.leaves(tree)])
            return combine(tree)
        return run
    B.make_combiner = spy
    out = {"cases": []}
    first = None                     # the first case's session
    for case in spec["cases"]:
        seen.clear()
        model = _case_model(case)
        init = _init_tree(data, case["name"])
        session = None
        if case.get("session"):
            session = TrainSession.from_config(
                EngineConfig.preset(case["arch"], **case["session"],
                                    ckpt_dir=spec["dir"] + "/"
                                    + case["name"]),
                model=model, device="cpu", comm=comm, callbacks=[])
            rt = session.runtime
        else:
            rt = build_runtime(model, RunPolicy(**case["policy"]),
                               lr=case["lr"], comm=comm,
                               model_size=case["mesh"][1])
        plan = rt.plan
        params = plan.shard_params(params_from_numpy(init, device="cpu"))
        state = {"params": params, "opt": rt.dopt.init(params), "step": 0}
        pol = (session.config.run_policy() if session
               else RunPolicy(**case["policy"]))
        res = {"losses": [], "metrics": [], "data_bitwise": [],
               "model_bitwise": [], "path": rt.combine_path,
               "mesh": (rt.dp_total, rt.model_size),
               "point": rt.dopt.point, "dims": plan.dims,
               "policy": {k: getattr(pol, k) for k in case["policy"]},
               "both": sum(a is not None and b is not None
                           for a, b in zip(plan.dims, plan.mdims))}
        for s in range(case["steps"]):
            b = _batch(data, case["name"], s)
            if session:
                session.state = state
                m = session.step(b)
                state = session.state
            else:
                state, m = rt.train_step(state, b)
            res["losses"].append(float(m["loss"]))
            res["metrics"].append({k: float(v) for k, v in m.items()})
            whole = [x for i, x in enumerate(T.leaves(state["params"]))
                     if plan.dims[i] is None or not plan.fsdp]
            both = [x for i, x in enumerate(T.leaves(state["params"]))
                    if plan.mdims[i] is None
                    and (plan.dims[i] is None or not plan.fsdp)]
            res["data_bitwise"].append(_same_in(plan.comm, whole))
            res["model_bitwise"].append(rt.model_comm is None
                                        or _same_in(rt.model_comm, both))
        inner = state["opt"]["inner"]
        res["shapes"] = {
            "params": [tuple(x.shape) for x in T.leaves(state["params"])],
            "state": {k: [tuple(x.shape) for x in T.leaves(t)]
                      for k, t in inner.items()},
            "grads": seen[0]}
        full_p = plan.gather_tree(state["params"], "params")
        full_s = {k: plan.gather_tree(t, "state") for k, t in inner.items()}
        if comm.rank == 0:
            res["params"] = _np_tree(full_p)
            res["state"] = {k: _np_tree(t) for k, t in full_s.items()}
        out["cases"].append(res)
        if session is not None and first is None:
            first = session
        elif session is not None:
            session.close()
    B.make_combiner = make
    if spec.get("ckpt"):
        out["ckpt"] = _grid_ckpt(comm, first, spec)
    if first is not None:
        first.close()
    return out


def _grid_ckpt(comm, s, spec):
    """The session of the (data, model) grid saves its state; rank 0
    restores it into one process (the lanes stacked) and takes a step,
    saved in a directory of its own, which the grid then restores.
    Returns (rank 0) the grid's saved state, the one process's restored
    state, the one process's saved state and the grid's restored state,
    each as full leaves."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.engine import TrainSession

    def full(sess):
        plan = sess.runtime.plan
        inner = sess.state["opt"]["inner"]
        if plan is None:
            return _np_tree((sess.state["params"], dict(inner)))
        return _np_tree((plan.gather_tree(sess.state["params"], "params"),
                         {k: plan.gather_tree(v, "state")
                          for k, v in inner.items()}))

    out = {}
    s.save_sync(2)
    out["grid_saved"] = full(s)
    solo = comm.split([[r] for r in range(comm.world)])
    if comm.rank == 0:
        one = TrainSession.from_config(
            dataclasses.replace(s.config, model_mesh=1), model=s.model,
            device="cpu", comm=solo, callbacks=[])
        one.restore(2)
        out["one_restored"] = full(one)
        one.step()
        one.checkpoint = CheckpointManager(spec["dir"] + "/one")
        one.save_sync(3)
        out["one_saved"] = full(one)
        out["one_span"] = one.runtime.span
        one.close()
    dist.barrier()
    s.checkpoint = CheckpointManager(spec["dir"] + "/one")
    s.restore(3)
    out["grid_restored"] = full(s)
    return out if comm.rank == 0 else {}


JOBS = {"rvh": job_rvh, "train": job_train, "ckpt": job_ckpt,
        "gather": job_gather, "delayed": job_delayed,
        "elastic": job_elastic, "compose": job_compose, "lanes": job_lanes,
        "adaptive": job_adaptive, "shard": job_shard, "tp": job_tp,
        "grid": job_grid}


def main():
    job, spec = sys.argv[1], json.loads(sys.argv[2])
    import torch
    torch.set_num_threads(1)
    from repro_torch.parallel.comm import Comm
    comm = Comm.init("gloo", torch.device("cpu"),
                     init_method="file://" + spec["store"],
                     timeout_s=spec["timeout"])
    rank = comm.rank
    try:
        result = JOBS[job](comm, spec)
    finally:
        comm.close()
    torch.save(result, Path(spec["out"]) / f"rank{rank}.pt")


if __name__ == "__main__":
    main()
