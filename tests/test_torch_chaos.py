"""The port's `repro_torch.chaos` held against `repro.chaos`:
`ChaosSchedule.generate` gives the reference's events for the same seed;
the checkpoint faults damage a port checkpoint the way the reference's
damage the same files (byte for byte), and the port's restore then
quarantines and falls back as the reference's tests/test_chaos.py
TestCheckpointIntegrity asserts; the train-side injectors (node loss,
SIGTERM, straggler, comm_spike, capacity return, the restart hook) on
one process; `comm_spike` is bitwise latency-only and an empty schedule
a bitwise no-op; `slow_prefill` and the serve invariants on the port's
engine (every request terminal, zero leaked pages), and hot-reload
falling back past a bit-flipped watched checkpoint.
"""
import shutil
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import chaos as JC
from repro_torch import tree as T
from repro_torch.chaos import (CapacityReturnCallback, ChaosCallback,
                               ChaosSchedule, FaultEvent, apply_ckpt_fault,
                               bitflip_leaf, drop_leaf, drop_manifest,
                               make_chaos_on_restart, slow_prefill,
                               tear_leaf)
from repro_torch.checkpoint import (CheckpointIntegrityError,
                                    CheckpointManager)
from repro_torch.configs.base import ModelConfig
from repro_torch.engine import (EngineConfig, GenerationRequest,
                                ServeEngine, StragglerCallback,
                                TrainSession, fit_elastic)
from repro_torch.models import build_model
from repro_torch.runtime import GrowBackSignal, NodeLossError, RestartSignal

TINY = ModelConfig("chaos-tiny", "dense", 2, 64, 4, 2, 128, 257,
                   head_dim=16)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread in this process: the tiny model's ops gain
    nothing from more, and in a run of several test workers the extra
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(chunk=16):
    return build_model(TINY, compute_dtype=torch.float32, attn_chunk=chunk)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"step": seed, "params": {"w": torch.randn(4, 3, generator=g),
                                     "b": torch.randn(3, generator=g)}}


# ------------------------------------------------------------- schedules
@pytest.mark.parametrize("seed,steps,kw", [
    (0, 50, {}), (11, 200, dict(rate=0.2)), (7, 120, dict(
        rate=0.3, kinds=("node_loss", "ckpt_bitflip", "comm_spike"))),
    (3, 80, dict(rate=0.5, min_step=4, max_arg_s=0.2))])
def test_generate_gives_the_references_events(seed, steps, kw):
    got = ChaosSchedule.generate(seed, steps, **kw).pending()
    want = JC.ChaosSchedule.generate(seed, steps, **kw).pending()
    assert [(e.step, e.kind, e.arg) for e in got] == \
        [(e.step, e.kind, e.arg) for e in want]
    assert got, "empty schedule"
    assert ChaosSchedule.KINDS == JC.ChaosSchedule.KINDS


def test_at_take_consume_events():
    s = ChaosSchedule([FaultEvent(3, "node_loss"),
                       FaultEvent(3, "comm_spike", 0.01),
                       FaultEvent(5, "ckpt_bitflip")])
    assert [e.kind for e in s.at(3, kinds=("node_loss",))] == ["node_loss"]
    assert len(s) == 2
    e = s.take_one(("ckpt_bitflip", "ckpt_torn"))
    assert e.kind == "ckpt_bitflip" and len(s) == 1
    assert s.take_one(("ckpt_torn",)) is None
    assert [e.kind for e in s.take(("comm_spike",))] == ["comm_spike"]
    assert not s.pending() and len(s.applied) == 3
    with pytest.raises(ValueError, match="unknown fault kind"):
        ChaosSchedule([FaultEvent(1, "meteor")])
    with pytest.raises(ValueError, match="unknown fault kind"):
        ChaosSchedule.generate(0, 10, kinds=("meteor",))


# ------------------------------------------------------ checkpoint faults
def _mgr(tmp_path, steps=(1, 2), name="ck"):
    mgr = CheckpointManager(tmp_path / name, keep=5)
    for s in steps:
        mgr.save(s, _state(s))
    return mgr


FAULTS = {"ckpt_bitflip": (bitflip_leaf, JC.bitflip_leaf,
                           "checksum mismatch"),
          "ckpt_torn": (tear_leaf, JC.tear_leaf, "unreadable leaf"),
          "ckpt_drop_leaf": (drop_leaf, JC.drop_leaf, "missing leaf")}


@pytest.mark.parametrize("kind", sorted(FAULTS))
def test_fault_quarantines_and_falls_back(tmp_path, capsys, kind):
    """The port's fault on a port checkpoint is the reference's fault on
    the same files (same step hit, same bytes after), and the restore
    quarantines the newest step and falls back to last-good."""
    mine, theirs, problem = FAULTS[kind]
    mgr = _mgr(tmp_path)
    twin = tmp_path / "twin"
    shutil.copytree(mgr.root, twin)
    assert mine(mgr.root) == theirs(twin) == 2
    for f in sorted((twin / "step_00000002").iterdir()):
        assert f.read_bytes() == (mgr.root / "step_00000002" /
                                  f.name).read_bytes()
    assert sorted(p.name for p in (twin / "step_00000002").iterdir()) == \
        sorted(p.name for p in (mgr.root / "step_00000002").iterdir())
    out = mgr.restore(_state())
    assert out["step"] == 1
    assert torch.equal(out["params"]["w"], _state(1)["params"]["w"])
    assert mgr.restore_fallbacks == 1
    assert [q["step"] for q in mgr.quarantined] == [2]
    assert (mgr.root / "step_00000002.bad").exists()
    assert mgr.latest_step() == 1
    assert problem in str(mgr.quarantined[0]["problems"])
    assert "quarantined step 2" in capsys.readouterr().out


def test_drop_manifest_step_invisible(tmp_path):
    mgr = _mgr(tmp_path)
    assert drop_manifest(mgr.root) == 2
    assert mgr.latest_step() == 1
    assert mgr.restore(_state())["step"] == 1
    assert mgr.restore_fallbacks == 0 and not mgr.quarantined
    assert apply_ckpt_fault("ckpt_drop_manifest", mgr.root) == 1


def test_explicit_bad_step_and_all_corrupt(tmp_path):
    mgr = _mgr(tmp_path)
    assert apply_ckpt_fault("reload_corrupt", mgr.root) == 2
    with pytest.raises(CheckpointIntegrityError,
                       match="step 2 failed integrity"):
        mgr.restore(_state(), step=2)
    assert (mgr.root / "step_00000002.bad").exists()
    tear_leaf(mgr.root)                  # the only step left
    with pytest.raises(ValueError, match="no valid checkpoints"):
        mgr.restore(_state())
    assert len(mgr.quarantined) == 2
    empty = CheckpointManager(tmp_path / "empty")
    assert bitflip_leaf(empty.root) is None
    with pytest.raises(ValueError, match="no checkpoints under"):
        empty.restore(_state())


def test_validate_step_lists_every_problem(tmp_path):
    mgr = _mgr(tmp_path, steps=(1,))
    assert mgr.validate_step(1) == []
    tear_leaf(mgr.root, index=0)
    drop_leaf(mgr.root, index=1)
    probs = mgr.validate_step(1)
    assert len(probs) == 2
    assert any("unreadable" in p for p in probs)
    assert any("missing leaf" in p for p in probs)


# ---------------------------------------------------- train-side injectors
BASE = dict(optimizer="momentum", lr=0.02, seq_len=32, global_batch=8,
            span=2, backend="gspmd_tree", log_every=1, ckpt_every=0)


def _session(model, tmp_path=None, **over):
    cfg = EngineConfig(**dict(BASE, **over), ckpt_dir=str(tmp_path) if
                       tmp_path else "")
    return TrainSession.from_config(
        cfg, model=model, device="cpu", callbacks=[],
        generator=torch.Generator().manual_seed(5))


def _bits(tree):
    return [x.clone() for x in T.leaves(tree)]


def test_empty_schedule_is_a_bitwise_noop():
    model = _model(32)
    a, b = _session(model), _session(model)
    b.callbacks = [ChaosCallback(ChaosSchedule())]
    a.fit(3)
    b.fit(3)
    for x, y in zip(T.leaves(a.state["params"]), T.leaves(b.state["params"])):
        assert torch.equal(x, y)


def test_comm_spike_is_bitwise_latency_only():
    """comm_spike sets the delayed stream's comm_delay for one round and
    restores it: the same params and carry bits as an unspiked stream
    (three rounds each)."""
    model = _model(32)
    runs = []
    for events in ([], [FaultEvent(0, "comm_spike", 0.02),
                        FaultEvent(1, "comm_spike", 0.03)]):
        s = _session(model, combine_delay=1)
        stream = s.use_delayed_stream(comm_delay=0.0)
        s.callbacks = [ChaosCallback(ChaosSchedule(events))]
        hist = s.fit(3)
        runs.append((_bits([s.state["params"], s.state["pending"]]),
                     [h["combine_wait_s"] for h in hist]))
        assert stream.comm_delay == 0.0
        s.close()
    for x, y in zip(runs[0][0], runs[1][0]):
        assert torch.equal(x, y)


def test_node_loss_straggler_and_sigterm(tmp_path):
    model = _model(32)
    s = _session(model)
    s.callbacks = [ChaosCallback(ChaosSchedule([FaultEvent(1,
                                                           "node_loss")]))]
    with pytest.raises(NodeLossError, match="step 1"):
        s.fit(3)
    assert s.state["step"] == 1
    # a straggler event flags the monitors; elastic raises at the boundary
    s = _session(model, tmp_path / "a", elastic=True)
    scb = StragglerCallback()
    s.callbacks = [scb, ChaosCallback(ChaosSchedule([FaultEvent(
        0, "straggler")]))]
    with pytest.raises(RestartSignal) as ei:
        s.fit(3)
    assert ei.value.step == 1 and scb.monitor.flagged
    # SIGTERM at step 2's start: the preemption handler saves, exits 143
    s = _session(model, tmp_path / "b", async_checkpoint=True)
    s.callbacks = [ChaosCallback(ChaosSchedule([FaultEvent(2, "sigterm")]))]
    try:
        with pytest.raises(SystemExit) as ei:
            s.fit(4)
        assert ei.value.code == 143
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        s.close()
    mgr = CheckpointManager(tmp_path / "b")
    assert mgr.latest_step() == 2 and mgr.validate_step(2) == []


class _Fake:
    """A session stand-in: rank and dp only."""

    def __init__(self, dp, rank=0):
        self.rank = rank
        self.runtime = type("R", (), {"dp_total": dp})()


def test_capacity_return_and_restart_hook(tmp_path):
    cb = CapacityReturnCallback(delay=2)
    cb.on_fit_start(_Fake(4), 0)
    cb.on_step_end(_Fake(4), 0, {}, 0.0)            # at full: nothing
    cb.on_fit_start(_Fake(2), 1)
    cb.on_step_end(_Fake(2), 1, {}, 0.0)
    with pytest.raises(GrowBackSignal) as ei:
        cb.on_step_end(_Fake(2), 2, {}, 0.0)
    assert (ei.value.step, ei.value.target_dp, cb.fired) == (3, 4, 1)
    # the restart hook pops one fault per boundary; only rank 0 writes
    mgr = _mgr(tmp_path)
    sched = ChaosSchedule([FaultEvent(0, "ckpt_torn"),
                           FaultEvent(0, "ckpt_bitflip")])
    hook = make_chaos_on_restart(sched, mgr.root)
    hook(_Fake(2, rank=1), NodeLossError("x"))
    assert len(sched) == 1 and mgr.validate_step(2) == []
    hook(_Fake(2, rank=0), NodeLossError("x"))
    assert not sched.pending()
    assert any("checksum" in p for p in mgr.validate_step(2))


def test_one_process_elastic_with_chaos_boundary_fault(tmp_path):
    """On one process the loss is re-raised after the boundary save (dp
    1); the hook damaged that save, so the next run falls back to the
    periodic step-2 save and replays step 2."""
    model = _model(32)
    cfg = EngineConfig(**dict(BASE, ckpt_every=2), elastic=True,
                       ckpt_dir=str(tmp_path / "ck"))
    sched = ChaosSchedule([FaultEvent(3, "node_loss"),
                           FaultEvent(0, "ckpt_bitflip")])
    from repro_torch.engine import CheckpointCallback
    with pytest.raises(NodeLossError):
        fit_elastic(cfg, 5, callbacks=[CheckpointCallback(2),
                                       ChaosCallback(sched)],
                    model=model, device="cpu",
                    on_restart=make_chaos_on_restart(sched, cfg.ckpt_dir))
    assert not sched.pending()
    hist, sess = fit_elastic(cfg, 5, callbacks=[], model=model,
                             device="cpu")
    assert [h["step"] for h in hist] == [2, 3, 4]
    res = sess.run_metadata()["resilience"]
    assert res["restore_fallbacks"] == 1 and res["quarantined_steps"] == [3]
    sess.close()


# ---------------------------------------------------------- serve side
def _engine(params=None, **cfg_kw):
    model = _model()
    if params is None:
        params = model.init(torch.Generator().manual_seed(0))
    cfg_kw.setdefault("max_slots", 2)
    cfg_kw.setdefault("max_len", 48)
    return ServeEngine(EngineConfig(**cfg_kw), model, params)


def _req(n=8, gen=8, **kw):
    rng = np.random.RandomState(3)
    return GenerationRequest(prompt=rng.randint(0, 257, n),
                             max_new_tokens=gen, **kw)


def test_slow_prefill_deadline_kills_are_terminal():
    eng = _engine()
    undo = slow_prefill(eng, 0.05)
    h = eng.submit(_req(deadline_s=1e-6))
    eng.drain()
    undo()
    assert h.done and h.failed and h.finish_reason == "deadline"
    tp = eng.throughput()
    assert tp["deadline_kills"] == 1 and tp["failed"] == 1
    assert tp["completed"] == 0
    assert eng.leaked_pages() == 0
    # undone: the engine's own admission again, which meets no deadline
    assert "slowed" not in getattr(eng._admit_batch, "__name__", "")
    h = eng.submit(_req())
    eng.drain()
    assert h.done and not h.failed and len(h.tokens) == 8


def test_serve_chaos_every_request_terminal(tmp_path):
    """Slow prefill, a short page pool, deadlines, the pressure ladder and
    a drain at once: every submitted request ends terminal, and no page
    leaks after the drain and a prefix flush."""
    eng = _engine(max_slots=2, max_len=48, page_size=8, kv_pages=9,
                  pressure_ladder=True)
    undo = slow_prefill(eng, 0.002)
    hs = [eng.submit(_req(16, 20)), eng.submit(_req(16, 20, max_retries=0)),
          eng.submit(_req(8, 6, deadline_s=1e-6))]
    eng.step()
    hs.append(eng.submit(_req(8, 4)))
    eng.request_drain()
    eng.drain()
    undo()
    assert all(h.done for h in hs)
    assert hs[2].failed and hs[2].finish_reason == "deadline"
    tp = eng.throughput()
    assert tp["degradation_changes"] >= 1
    assert eng.leaked_pages() == 0
    eng.flush_prefix()
    assert eng._pool.pages_used == 0


def test_hot_reload_falls_back_past_bitflipped_checkpoint(tmp_path):
    """A watched checkpoint bit-flipped before the poll: the reloader
    quarantines it and serves the last good step."""
    model = _model()
    p0 = model.init(torch.Generator().manual_seed(0))
    mgr = CheckpointManager(tmp_path / "ck", keep=5)
    eng = ServeEngine(EngineConfig(max_slots=2, max_len=48, hot_reload=True,
                                   ckpt_dir=str(mgr.root)),
                      model, p0, checkpoint=mgr)
    for s, scale in ((1, 1.01), (2, 1.02)):
        mgr.save(s, {"params": T.map(lambda x: x * scale, p0)})
    assert bitflip_leaf(mgr.root) == 2
    h = eng.submit(_req())
    eng.drain()
    assert h.done and not h.failed
    assert eng.loaded_step == 1
    assert eng.throughput()["restore_fallbacks"] == 1
    assert [q["step"] for q in mgr.quarantined] == [2]
    assert eng.leaked_pages() == 0
