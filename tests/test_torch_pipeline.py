"""The port's pipelined training loop and the small pieces of ROADMAP item
4 (`repro_torch.runtime`, `engine/pipeline.py`, the session's
checkpoints and callbacks, `adascale`, `optim/schedules.py` and
`optim/scaling.py`), against the JAX package where it has the same
function:

  * `Prefetcher`: the prefetched stream is bitwise the synchronous one,
    across a seek, never past its limit, and synchronous after close;
  * `StepMonitor` / `FailureInjector` give the reference's flags and
    raises on the same inputs;
  * resume: a fresh session on the checkpoint directory continues
    bitwise as the uninterrupted run (one device, span 2 at the post
    point: lane-axis optimizer state), with prefetch on, with the
    device stage, and off;
  * the `--fail-at` drill through the train CLI: the run dies with
    NodeLossError, running it again resumes and its final checkpoint is
    bitwise the uninterrupted run's;
  * `adascale` against the reference's `_adascale` (rtol 1e-5: the same
    fp32 moments in another library), gain 1 at equal lanes and S at
    orthogonal ones, per-leaf and whole-model;
  * schedules and `DynamicLossScaler` against the reference (rtol 1e-6);
  * the config's new fields, their checks, round trip and CLI flags.
"""
import dataclasses
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch import tree as T
from repro_torch.core.combine import CombineConfig
from repro_torch.data import DataConfig, make_source
from repro_torch.engine import EngineConfig, TrainSession, make_combiner
from repro_torch.engine.session import (CheckpointCallback,
                                        FailureInjectionCallback,
                                        StragglerCallback, default_callbacks)
from repro_torch.runtime import (FailureInjector, NodeLossError, Prefetcher,
                                 StepMonitor, StragglerConfig)
from repro_torch.runtime.prefetch import DeviceStage


@pytest.fixture(autouse=True)
def _keep_sigterm():
    """Sessions with a ckpt_dir install a SIGTERM handler (the preemption
    save); put the process's own back after each test."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


def small_source(seed=0):
    return make_source(DataConfig(seq_len=16, global_batch=4,
                                  vocab_size=64, seed=seed))


# ----------------------------------------------------------------- prefetch
class TestPrefetcher:
    @pytest.mark.parametrize("stage", ["host", "device"])
    def test_stream_bitwise_identical(self, stage):
        src = small_source()
        ds = DeviceStage("cpu") if stage == "device" else None
        with Prefetcher(src, stage=ds, claim=ds.claim if ds else None) as pf:
            for step in (0, 1, 2, 3):
                got = pf.get(step)
                want = src.batch(step)
                for k in want:
                    assert got[k].dtype == torch.from_numpy(want[k]).dtype
                    np.testing.assert_array_equal(got[k].numpy(), want[k])

    def test_seek_preserves_determinism(self):
        src = small_source()
        with Prefetcher(src, depth=2) as pf:
            pf.get(0)
            pf.get(1)           # steps 2, 3 now speculatively in flight
            got = pf.get(7)     # a resume at step 7
            np.testing.assert_array_equal(got["tokens"].numpy(),
                                          src.batch(7)["tokens"])
            got = pf.get(8)     # the speculation after the seek is used
            np.testing.assert_array_equal(got["tokens"].numpy(),
                                          src.batch(8)["tokens"])
        assert pf.hits >= 1

    def test_limit_stops_end_of_run_speculation(self):
        src = small_source()
        with Prefetcher(src, limit=4) as pf:
            pf.get(3)
            assert not pf._pending
            np.testing.assert_array_equal(pf.get(4)["tokens"].numpy(),
                                          src.batch(4)["tokens"])

    def test_close_falls_back_synchronous(self):
        src = small_source()
        pf = Prefetcher(src)
        pf.close()
        np.testing.assert_array_equal(pf.get(3)["tokens"].numpy(),
                                      src.batch(3)["tokens"])
        with pytest.raises(ValueError, match="depth"):
            Prefetcher(src, depth=0)


# ------------------------------------------------- monitor and injector
def test_step_monitor_matches_reference():
    from repro.runtime import StepMonitor as JMon
    from repro.runtime import StragglerConfig as JCfg
    rng = np.random.default_rng(0)
    times = list(0.1 + 0.001 * rng.standard_normal(12)) + [1.0, 1.2, 0.9,
                                                           0.1, 1.1]
    kw = dict(min_steps=5, patience=2, window=10)
    mine, ref = StepMonitor(StragglerConfig(**kw)), JMon(JCfg(**kw))
    for t in times:
        mine.observe(t)
        ref.observe(t)
        assert mine.flagged == ref.flagged
    assert mine.flagged and mine.summary() == ref.summary()


def test_failure_injector_fires_once():
    inj = FailureInjector([2, 4])
    inj.check(1)
    with pytest.raises(NodeLossError, match="step 2"):
        inj.check(2)
    inj.check(2)            # fired once: a resumed run passes step 2
    assert issubclass(NodeLossError, RuntimeError)
    cbs = default_callbacks(EngineConfig(ckpt_dir="x"), fail_at=[3])
    assert [type(c) for c in cbs][0] is FailureInjectionCallback
    assert any(isinstance(c, CheckpointCallback) for c in cbs)
    assert any(isinstance(c, StragglerCallback) for c in cbs)


# ------------------------------------------------------------- resume
_CFG = dict(arch="gemma-7b", reduced=True, span=2, backend="gspmd_tree",
            optimizer="adam", combine_point="post", seq_len=16,
            global_batch=8, log_every=10 ** 6)


def _session(root, **kw):
    cfg = EngineConfig(**dict(_CFG, ckpt_dir=str(root), **kw))
    return TrainSession.from_config(cfg, device="cpu", callbacks=[
        CheckpointCallback(cfg.ckpt_every)])


def _state_bits(state):
    return [x.clone() if isinstance(x, torch.Tensor) else x
            for x in T.leaves(state)]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    old = signal.getsignal(signal.SIGTERM)
    try:
        s = _session(tmp_path_factory.mktemp("full"), ckpt_every=2)
        s.fit(3)
        s.close()
    finally:
        signal.signal(signal.SIGTERM, old)
    return _state_bits(s.state)


@pytest.mark.parametrize("mode", [dict(prefetch=True),
                                  dict(prefetch=True, device_stage=True,
                                       prefetch_depth=2),
                                  dict(prefetch=False),
                                  dict(async_checkpoint=False)])
def test_resume_bitwise_equals_uninterrupted(tmp_path, capsys,
                                             uninterrupted, mode):
    """fit(2) saves step 2; a fresh session on the same directory resumes
    there and its step 3 state (params, lane-axis adam state, counters)
    is bitwise the uninterrupted run's."""
    first = _session(tmp_path, ckpt_every=2, **mode)
    first.fit(2)
    first.close()
    assert first.checkpoint.all_steps() == [2]
    again = _session(tmp_path, ckpt_every=2, **mode)
    hist = again.fit(3)
    assert "resumed from step 2" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [2]
    assert again.state["opt"]["inner"]["m"]["embed"]["table"].shape[0] == 2
    _same(_state_bits(again.state), uninterrupted)
    assert again.checkpoint.all_steps() == [2, 3]
    again.close()
    meta = again.run_metadata()["resilience"]
    assert meta == {"restore_fallbacks": 0, "quarantined_steps": [],
                    "restarts": 0, "grow_backs": 0}


def test_fit_continues_live_state_and_saves(tmp_path):
    """A checkpoint behind the live state is never restored (no roll
    back); save/save_sync default to the state's step."""
    s = _session(tmp_path, ckpt_every=1)
    s.fit(1)
    s.save_sync()
    before = _state_bits(s.state)
    assert s.fit(1) == []                 # already there: nothing to do
    _same(_state_bits(s.state), before)
    assert s.latest_step() == 1
    s.close()


def test_writer_error_fails_the_fit(tmp_path, monkeypatch):
    """A failed background write surfaces at the next barrier and fails
    the run, never silently."""
    from repro_torch.checkpoint import CheckpointManager

    def boom(*a, **k):
        raise OSError("disk full")
    s = _session(tmp_path, ckpt_every=1)
    monkeypatch.setattr(CheckpointManager, "save", boom)
    with pytest.raises(OSError, match="disk full"):
        s.fit(1)


# ------------------------------------------------------------- CLI drill
def _final_crcs(root):
    import json
    from pathlib import Path
    steps = sorted(Path(root).glob("step_*[0-9]"))
    m = json.loads((steps[-1] / "manifest.json").read_text())
    return m["step"], [(e["path"], e["crc32"]) for e in m["leaves"]]


def test_fail_at_drill_resumes_to_the_uninterrupted_params(tmp_path,
                                                           capsys):
    from repro_torch.launch.train import main
    argv = ["--device", "cpu", "--arch", "gemma-7b", "--reduced",
            "--steps", "4", "--seq", "16", "--batch", "8", "--span", "2",
            "--backend", "gspmd_tree", "--optimizer", "adam",
            "--ckpt-every", "2", "--log-every", "100"]
    main(argv + ["--ckpt-dir", str(tmp_path / "full")])
    with pytest.raises(NodeLossError, match="step 3"):
        main(argv + ["--ckpt-dir", str(tmp_path / "drill"),
                     "--fail-at", "3"])
    hist = main(argv + ["--ckpt-dir", str(tmp_path / "drill")])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "prefetch=on depth=1" in out
    assert [h["step"] for h in hist] == [2, 3]
    assert _final_crcs(tmp_path / "drill") == _final_crcs(tmp_path / "full")
    assert main(argv + ["--ckpt-dir", str(tmp_path / "drill")]) == []
    assert "nothing to do" in capsys.readouterr().out


# -------------------------------------------------------------- adascale
def _adascale_cases():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    eye = np.eye(4, dtype=np.float32) * 3.0
    rand = {"a": rng.standard_normal((4, 6, 5)).astype(np.float32),
            "b": rng.standard_normal((4, 7)).astype(np.float32)}
    return {"equal": {"w": np.stack([x] * 4)},
            "orthogonal": {"w": eye},
            "random": rand}


@pytest.mark.parametrize("per_layer", [True, False])
@pytest.mark.parametrize("case", ["equal", "orthogonal", "random"])
def test_adascale_matches_reference(case, per_layer):
    from repro.core.combine import CombineConfig as JCC
    from repro.engine import make_combiner as jmake
    lanes = _adascale_cases()[case]
    got = make_combiner(CombineConfig(op="adascale", per_layer=per_layer))(
        {k: torch.from_numpy(v) for k, v in lanes.items()})
    want = jmake(JCC(op="adascale", per_layer=per_layer))(
        {k: jnp.asarray(v) for k, v in lanes.items()})
    for k in lanes:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
    if case == "equal":        # gain 1: the mean
        np.testing.assert_allclose(got["w"].numpy(), lanes["w"][0],
                                   rtol=1e-5, atol=1e-6)
    if case == "orthogonal":   # gain S: the sum
        np.testing.assert_allclose(got["w"].numpy(), lanes["w"].sum(0),
                                   rtol=1e-4, atol=1e-5)


def test_adascale_trains_and_builds_across_ranks():
    """Stacked lanes train; across ranks the registry builds the ranked
    combiner (its run is tests/test_torch_dist_train.py's)."""
    from types import SimpleNamespace
    s = TrainSession.from_config(
        EngineConfig(arch="gemma-7b", reduced=True, combine="adascale",
                     span=2, optimizer="sgd", seq_len=16, global_batch=8),
        device="cpu", callbacks=[])
    assert np.isfinite(s.step()["loss"])
    c = make_combiner(CombineConfig(op="adascale"),
                      comm=SimpleNamespace(world=2, rank=0))
    assert c.combine_path == "adascale"


# --------------------------------------------- schedules and loss scaler
@pytest.mark.parametrize("name,kw", [
    ("constant", dict(base_lr=0.1)),
    ("linear_warmup_decay", dict(base_lr=0.1, warmup_steps=5,
                                 total_steps=20)),
    ("cosine_warmup", dict(base_lr=0.1, warmup_steps=5, total_steps=20,
                           min_frac=0.1)),
    ("step_decay", dict(base_lr=0.1, boundaries=[3, 7],
                        factors=[0.5, 0.1]))])
def test_schedules_match_reference(name, kw):
    from repro.optim import schedules as JS
    from repro_torch.optim import get_schedule
    mine, ref = get_schedule(name, **kw), JS.get_schedule(name, **kw)
    for step in (0, 1, 4, 5, 6, 10, 19, 20, 25):
        np.testing.assert_allclose(float(mine(step)),
                                   float(ref(jnp.asarray(step))), rtol=1e-6)


def test_loss_scaler_matches_reference():
    from repro.optim.scaling import DynamicLossScaler as JScaler
    from repro_torch.optim import DynamicLossScaler
    kw = dict(init_scale=8.0, growth_interval=2, max_scale=32.0,
              min_scale=2.0)
    mine, ref = DynamicLossScaler(**kw), JScaler(**kw)
    ms, rs = mine.init(), ref.init()
    g = {"w": np.array([1.0, 2.0], np.float32)}
    bad = {"w": np.array([1.0, np.inf], np.float32)}
    for grads in (g, g, g, g, bad, g, bad, bad, bad):
        tg = {k: torch.from_numpy(v) for k, v in grads.items()}
        jg = {k: jnp.asarray(v) for k, v in grads.items()}
        fin = mine.check_finite(tg)
        assert bool(fin) == bool(ref.check_finite(jg))
        ms, rs = mine.update(ms, fin), ref.update(rs, ref.check_finite(jg))
        assert float(ms.scale) == float(rs.scale)
        assert int(ms.good_steps) == int(rs.good_steps)
    np.testing.assert_allclose(
        mine.unscale(tg, ms)["w"].numpy(), np.asarray(ref.unscale(jg, rs)["w"]))
    assert float(mine.scale_loss(torch.tensor(2.0), ms)) == \
        float(ref.scale_loss(jnp.asarray(2.0), rs))


# ---------------------------------------------------------------- config
def test_config_fields_defaults_and_round_trip():
    from repro.engine.config import EngineConfig as JEC
    jd = dataclasses.asdict(JEC())
    cfg = EngineConfig(ckpt_dir="ck", ckpt_every=3, prefetch_depth=2,
                       device_stage=True, async_checkpoint=False,
                       hot_reload=True)
    for k in ("prefetch", "prefetch_depth", "device_stage",
              "async_checkpoint", "hot_reload", "ckpt_dir", "ckpt_every"):
        assert getattr(EngineConfig(), k) == jd[k], k
    assert EngineConfig.from_dict(cfg.to_dict()) == cfg
    cli = EngineConfig.from_cli(
        ["--arch", "gemma-7b", "--ckpt-dir", "ck", "--ckpt-every", "3",
         "--prefetch-depth", "2", "--device-stage", "--sync-checkpoint",
         "--hot-reload"])
    assert (cli.ckpt_dir, cli.ckpt_every, cli.prefetch_depth,
            cli.device_stage, cli.async_checkpoint, cli.hot_reload) == \
        ("ck", 3, 2, True, False, True)
    assert EngineConfig.from_cli(["--arch", "gemma-7b",
                                  "--no-prefetch"]).prefetch is False


@pytest.mark.parametrize("kw,match", [
    (dict(prefetch_depth=0), "prefetch_depth"),
    (dict(prefetch=False, device_stage=True), "require prefetch"),
    (dict(prefetch=False, prefetch_depth=2), "require prefetch"),
    (dict(hot_reload=True), "needs ckpt_dir")])
def test_config_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        EngineConfig(**kw).validate()
