"""The port's `repro_torch.control` held against `repro.control` and
`repro.runtime.elastic` on the same inputs: NoiseEMA and gain_for_factor
(exact: the same host float arithmetic), the four planners over
parametrised grids (plans equal), BatchController on seeded metric
streams (the same plans at the same steps, through notify_resized),
ControllerConfig.from_engine, config_hash / run_fingerprint, the
controller knobs of EngineConfig (defaults, errors, CLI flags, a
reference config dict), and per_layer_orthogonality on seeded grads
(rtol 1e-6: the port sums the same fp32 products in torch's order).

Then the drivers with the reference's own assertions
(tests/test_control.py TestAdaptiveEndToEnd, tests/test_chaos.py's
scripted grow-then-shrink): on one process, the lanes stacked (dp 1, so
`plan_grow` doubles the batch and keeps the span), and on 4 gloo ranks
(span 2 -> 4 with batch 8 -> 16), where every rank holds the same resize
log, LR and params bits, and the resumed segment is bitwise a plain port
session restored from the same boundary checkpoint.

The model is the reference control tests' tiny dense decoder
(`ModelConfig("ctl-tiny", "dense", 2, 64, 4, 2, 128, 257,
head_dim=16)`), fp32.
"""
import dataclasses
import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.control import controller as JCtl
from repro.control import noise as JN
from repro.control import telemetry as JTel
from repro.core.orthogonality import per_layer_orthogonality as j_orth
from repro.engine import EngineConfig as JEngineConfig
from repro.runtime import elastic as JE
from repro_torch.control import (BatchController, ControllerConfig,
                                 NoiseEMA, config_hash, fit_adaptive,
                                 gain_for_factor, git_sha, run_fingerprint)
from repro_torch.control.noise import STAT_KEYS
from repro_torch.control.resize import log_effective
from repro_torch.configs.base import ModelConfig
from repro_torch.core.orthogonality import per_layer_orthogonality
from repro_torch.engine import EngineConfig, TrainSession
from repro_torch.models import build_model
from repro_torch.runtime import elastic as E

from torch_dist_workers import launch

TINY = ("ctl-tiny", "dense", 2, 64, 4, 2, 128, 257)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread in this process: the tiny model's ops gain
    nothing from more, and in a run of several test workers the extra
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny():
    return build_model(ModelConfig(*TINY, head_dim=16),
                       compute_dtype=torch.float32, attn_chunk=32)


# ------------------------------------------------------------- noise math
@pytest.mark.parametrize("decay", [0.0, 0.5, 0.9])
def test_noise_ema_equals_reference(decay):
    rng = np.random.RandomState(int(decay * 10))
    stream = list(rng.lognormal(3.0, 1.5, 40))
    stream[5], stream[11], stream[17] = float("nan"), float("inf"), None
    a, b = NoiseEMA(decay), JN.NoiseEMA(decay)
    assert a.value is None and b.value is None
    for x in stream:
        assert a.update(x) == b.update(x)
        assert a.count == b.count
    assert math.isfinite(a.value)


def test_gain_for_factor_equals_reference():
    rng = np.random.RandomState(0)
    for var, mu2 in itertools.product(
            [0.0, 1e-6, 0.3, 2.0] + list(rng.rand(3) * 10),
            [0.0, 1e-8, 0.1, 5.0]):
        for factor in (0.5, 1.0, 2.0, 4.0, 8.0):
            assert gain_for_factor(var, mu2, factor) == \
                JN.gain_for_factor(var, mu2, factor), (var, mu2, factor)


# --------------------------------------------------------------- planners
@pytest.mark.parametrize("dp", [1, 2, 4, 8, 6])
def test_plan_grow_equals_reference(dp):
    for batch, span, factor, grow_span, cap, scale in itertools.product(
            (1, 4, 8, 12, 16), (1, 2, 4), (2, 4, 3), (True, False),
            (0, 16, 24), (1.0, 1.7)):
        args = (batch, span, dp, 0.1)
        kw = dict(factor=factor, grow_span=grow_span, max_global_batch=cap,
                  lr_scale=scale, reason="r")
        assert dataclasses.asdict(E.plan_grow(*args, **kw)) == \
            dataclasses.asdict(JE.plan_grow(*args, **kw)), (args, kw)


@pytest.mark.parametrize("dp", [1, 2, 8])
def test_plan_shrink_batch_equals_reference(dp):
    for batch, span, factor, shrink_span, floor, scale in itertools.product(
            (1, 2, 6, 8, 16, 32), (1, 2, 4, 8), (2, 4), (True, False),
            (0, 4, 8), (1.0, 0.5)):
        args = (batch, span, dp, 0.2)
        kw = dict(factor=factor, shrink_span=shrink_span,
                  min_global_batch=floor, lr_scale=scale)
        got = E.plan_shrink_batch(*args, **kw)
        want = JE.plan_shrink_batch(*args, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.changed, got.shrank, got.grew, got.describe()) == \
            (want.changed, want.shrank, want.grew, want.describe())


def test_plan_shrink_and_grow_back_equal_reference():
    for dp in range(1, 17):
        got, want = E.plan_shrink(dp), JE.plan_shrink(dp)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.shrunk, got.grew) == (want.shrunk, want.grew)
        for target, scale in itertools.product((0, 1, 3, 4, 7, 8, 16),
                                               (1.0, 1.5)):
            got = E.plan_grow_back(dp, target, 0.1, lr_scale=scale)
            want = JE.plan_grow_back(dp, target, 0.1, lr_scale=scale)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -------------------------------------------------------------- controller
CONTROLLERS = {
    "default": dict(),
    "fast": dict(patience=2, cooldown=3, warmup=1, max_global_batch=64),
    "linear_capped": dict(patience=1, cooldown=0, lr_rescale="linear",
                          max_global_batch=16, ema=0.5),
    "shrink": dict(grow_threshold=2.0, shrink_threshold=0.25, patience=2,
                   cooldown=1, warmup=1, ema=0.0, min_global_batch=4),
    "none_nospan": dict(patience=3, cooldown=2, lr_rescale="none",
                        grow_span=False, grow_factor=4),
}


@pytest.mark.parametrize("name", sorted(CONTROLLERS))
def test_batch_controller_equals_reference(name):
    """A seeded noise stream that rises, falls and spikes (NaN too): both
    controllers emit the same plans at the same steps, notified of each
    other's plans alike."""
    kw = CONTROLLERS[name]
    rng = np.random.RandomState(len(name))
    a = BatchController(ControllerConfig(**kw), global_batch=8, span=2,
                        dp_total=8, lr=0.05)
    b = JCtl.BatchController(JCtl.ControllerConfig(**kw), global_batch=8,
                             span=2, dp_total=8, lr=0.05)
    plans = []
    for step in range(160):
        level = 200.0 if step < 60 else (0.5 if step < 110 else 80.0)
        m = {"noise_scale": float(level * rng.lognormal(0.0, 0.8)),
             "grad_var": float(rng.rand() * 2), "grad_mu2": float(rng.rand())}
        if step % 37 == 5:
            m["noise_scale"] = float("nan")
        pa, pb = a.observe(step, dict(m)), b.observe(step, dict(m))
        assert (pa is None) == (pb is None), step
        if pa is not None:
            assert dataclasses.asdict(pa) == dataclasses.asdict(pb), step
            plans.append((step, pa))
            a.notify_resized(pa)
            b.notify_resized(pb)
    assert a.global_batch == b.global_batch and a.lr == b.lr
    assert a.span == b.span
    assert plans, "the stream never moved the controller"


def test_controller_config_from_engine_equals_reference():
    over = dict(grow_factor=4, grow_threshold=3.5, grow_patience=5,
                grow_cooldown=7, max_global_batch=128, grow_span=False,
                lr_rescale="linear", noise_ema=0.8, shrink_threshold=0.5,
                min_global_batch=4)
    for fields in ({}, over):
        got = ControllerConfig.from_engine(EngineConfig(**fields))
        want = JCtl.ControllerConfig.from_engine(JEngineConfig(**fields))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# --------------------------------------------------------------- telemetry
def test_config_hash_and_fingerprint_equal_reference():
    d = {"arch": "gemma-7b", "lr": 0.001, "span": 4, "steps": [1, 2],
         "nested": {"b": 1, "a": None}}
    assert config_hash(d) == JTel.config_hash(d)
    assert config_hash(d) != config_hash(dict(d, lr=0.002))
    sha = git_sha()
    assert sha == JTel.git_sha()
    cfg = EngineConfig(arch="gemma-7b")
    fp = run_fingerprint(cfg)
    assert fp == {"git_sha": sha, "config_hash": config_hash(cfg)}
    assert run_fingerprint() == {"git_sha": sha}


# ------------------------------------------------------ EngineConfig knobs
def test_controller_knobs_match_reference_defaults_and_dict():
    ref = JEngineConfig(arch="gemma-7b", adaptive_batch=True,
                        ckpt_dir="/tmp/x", grow_threshold=1.5)
    port = EngineConfig.from_dict(ref.to_dict())
    for f in ("grow_factor", "grow_threshold", "grow_patience",
              "grow_cooldown", "max_global_batch", "grow_span",
              "lr_rescale", "noise_ema", "shrink_threshold",
              "min_global_batch", "adaptive_batch", "elastic"):
        assert getattr(port, f) == getattr(ref, f), f
        assert getattr(EngineConfig(), f) == getattr(JEngineConfig(), f), f
    port.validate()
    assert EngineConfig.from_dict(port.to_dict()) == port


@pytest.mark.parametrize("over", [
    dict(grow_factor=1), dict(grow_factor=3), dict(grow_threshold=0.0),
    dict(grow_patience=0), dict(grow_cooldown=-1),
    dict(max_global_batch=-2), dict(noise_ema=1.0),
    dict(shrink_threshold=-1.0), dict(grow_threshold=2.0,
                                      shrink_threshold=2.5),
    dict(min_global_batch=-4), dict(lr_rescale="cubic"),
    dict(adaptive_batch=True), dict(elastic=True),
    dict(adaptive_batch=True, ckpt_dir="c", combine_stats=False),
    dict(adaptive_batch=True, ckpt_dir="c", combine_delay=1),
    dict(adaptive_batch=True, ckpt_dir="c", elastic=True)])
def test_controller_validation_is_the_references(over):
    with pytest.raises(ValueError) as want:
        JEngineConfig(**over).validate()
    with pytest.raises(ValueError) as got:
        EngineConfig(**over).validate()
    assert str(got.value) == str(want.value)


def test_controller_cli_flags_parse_as_reference():
    argv = ["--arch", "gemma-7b", "--reduced", "--adaptive-batch",
            "--ckpt-dir", "ck", "--grow-factor", "4", "--grow-threshold",
            "3", "--grow-patience", "2", "--grow-cooldown", "5",
            "--max-global-batch", "64", "--no-grow-span",
            "--shrink-threshold", "0.5", "--min-global-batch", "4",
            "--lr-rescale", "linear", "--noise-ema", "0.7"]
    got, want = EngineConfig.from_cli(argv), JEngineConfig.from_cli(argv)
    for f in dataclasses.fields(EngineConfig):
        if hasattr(want, f.name):
            assert getattr(got, f.name) == getattr(want, f.name), f.name


# ------------------------------------------------------------ orthogonality
@pytest.mark.parametrize("n,stacked", [(2, False), (4, True), (8, False)])
def test_per_layer_orthogonality_equals_reference(n, stacked):
    rng = np.random.RandomState(n)
    lanes = [{"w": rng.randn(6, 5).astype(np.float32),
              "b": {"x": rng.randn(7).astype(np.float32) * 1e-3,
                    "y": rng.randn(3, 2).astype(np.float32)}}
             for _ in range(n)]
    lanes[1]["w"] = lanes[0]["w"] * 2.0            # one parallel pair
    if stacked:
        st = lambda f: {"w": f([l["w"] for l in lanes]),
                        "b": {k: f([l["b"][k] for l in lanes])
                              for k in ("x", "y")}}
        got = per_layer_orthogonality(st(lambda xs: torch.from_numpy(
            np.stack(xs))))
        want = j_orth(st(lambda xs: jnp.asarray(np.stack(xs))))
    else:
        got = per_layer_orthogonality([
            {"w": torch.from_numpy(l["w"]),
             "b": {k: torch.from_numpy(v) for k, v in l["b"].items()}}
            for l in lanes])
        want = j_orth([jax.tree.map(jnp.asarray, l) for l in lanes])
    assert sorted(got) == sorted(want)
    assert "['b']['x']" in got and "__mean__" in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


# -------------------------------------------------- the driver, one process
def _record(seen):
    class Record:
        def on_fit_start(self, session, start): ...

        def on_fit_end(self, session, history): ...

        def on_step_end(self, session, step, metrics, dt): ...

        def on_step_start(self, session, step):
            seen.append((step, session.config.global_batch,
                         int(session.batch(step)["tokens"].shape[0])))
    return Record()


def test_stats_on_is_bitwise_noop_and_surfaces_metrics():
    """combine_stats=True must not perturb training (bitwise params) while
    surfacing the STAT_KEYS metrics and the run_metadata fields."""
    model = _tiny()

    def run(stats):
        cfg = EngineConfig(combine="adasum", span=2, backend="gspmd_tree",
                           optimizer="momentum", lr=0.05, seq_len=32,
                           global_batch=8, data_seed=7, combine_stats=stats)
        sess = TrainSession.from_config(
            cfg, model=model, device="cpu", callbacks=[],
            generator=torch.Generator().manual_seed(0))
        return sess, [sess.step(sess.batch(s)) for s in range(4)]

    s_on, h_on = run(True)
    s_off, h_off = run(False)
    for a, b in zip(jax.tree.leaves(s_on.state["params"]),
                    jax.tree.leaves(s_off.state["params"])):
        assert torch.equal(a, b)
    assert [m["loss"] for m in h_on] == [m["loss"] for m in h_off]
    for k in STAT_KEYS:
        assert k in h_on[-1] and k not in h_off[-1], k
    md = s_on.run_metadata()
    assert md["stats_enabled"] is True and md["adaptive_batch"] is False
    assert set(STAT_KEYS) <= set(md["combine_stats"])
    assert md["combine_stats"]["noise_scale"] > 0
    assert len(md["git_sha"]) >= 7 and md["config_hash"]
    assert s_off.run_metadata()["stats_enabled"] is False


def test_fit_adaptive_resizes_and_keeps_stream_aligned(tmp_path):
    """The reference's acceptance on one process: >= 1 controller resize,
    each step consumed once in order, rows doubling at the boundary, the
    effective point validated after the rebuilds, LR rescaled upward.
    dp is 1, so the span stays (the reference grows it with dp = 8)."""
    seen = []
    cfg = EngineConfig(combine="adasum", span=2, backend="gspmd_tree",
                       optimizer="momentum", lr=0.02, seq_len=32,
                       global_batch=8, data_seed=11, steps=14,
                       ckpt_dir=str(tmp_path), ckpt_every=0,
                       adaptive_batch=True, grow_threshold=1.0,
                       grow_patience=2, grow_cooldown=3,
                       max_global_batch=32)
    hist, sess = fit_adaptive(cfg, 14, callbacks=[_record(seen)],
                              model=_tiny(), device="cpu")
    assert len(sess.resize_log) >= 1, sess.resize_log
    assert [s for s, _, _ in seen] == list(range(14)), seen
    assert [h["step"] for h in hist] == list(range(14))
    assert np.isfinite([h["loss"] for h in hist]).all()
    first = sess.resize_log[0]
    rows = {s: r for s, _, r in seen}
    assert rows[first["step"]] == rows[first["step"] - 1] * 2
    eff = log_effective(sess)
    assert eff["global_batch"] == sess.config.global_batch > 8
    assert eff["span"] == 2 and eff["dp"] == 1
    assert all(p["old_span"] == p["new_span"] == 2 for p in sess.resize_log)
    assert sess.config.lr > 0.02
    md = sess.run_metadata()
    assert md["adaptive_batch"] is True
    assert md["global_batch"] == eff["global_batch"]
    sess.close()


def test_grow_then_shrink_contiguity_through_resize_machinery(tmp_path):
    """A scripted grow at step 3 then shrink at step 7 both run through
    the planned-resize machinery, the stream contiguous and the batch
    rows tracking the plans (the reference's regression)."""
    class Scripted(BatchController):
        def observe(self, step, metrics):
            if step == 3 and self.global_batch == 8:
                return E.plan_grow(self.global_batch, self.span,
                                   self.dp_total, self.lr, lr_scale=2.0)
            if step == 7 and self.global_batch == 16:
                return E.plan_shrink_batch(self.global_batch, self.span,
                                           self.dp_total, self.lr,
                                           lr_scale=0.5)
            return None

    seen = []
    cfg = EngineConfig(combine="adasum", span=2, backend="gspmd_tree",
                       optimizer="momentum", lr=0.02, seq_len=32,
                       global_batch=8, data_seed=11, steps=10,
                       ckpt_dir=str(tmp_path), ckpt_every=0,
                       adaptive_batch=True)
    ctrl = Scripted(ControllerConfig(), global_batch=8, span=2,
                    dp_total=1, lr=0.02)
    hist, sess = fit_adaptive(cfg, 10, callbacks=[_record(seen)],
                              controller=ctrl, model=_tiny(), device="cpu")
    assert [s for s, _, _ in seen] == list(range(10)), seen
    assert [h["step"] for h in hist] == list(range(10))
    batches = {s: b for s, b, _ in seen}
    assert batches[3] == 8 and batches[4] == 16
    assert batches[7] == 16 and batches[8] == 8
    assert sess.config.global_batch == 8
    assert sess.config.lr == 0.02
    kinds = ["grow" if p["new_batch"] > p["old_batch"] else "shrink"
             for p in sess.resize_log]
    assert kinds == ["grow", "shrink"], sess.resize_log
    assert np.isfinite([h["loss"] for h in hist]).all()
    sess.close()


def test_fit_adaptive_needs_ckpt_dir():
    with pytest.raises(ValueError, match="ckpt_dir"):
        fit_adaptive(EngineConfig(), 1)


# ---------------------------------------------------- the driver, 4 ranks
@pytest.fixture(scope="module")
def adaptive_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("adaptive")
    cfg = dict(combine="adasum", span=2, backend="gspmd_tree",
               optimizer="momentum", lr=0.02, seq_len=32, global_batch=8,
               data_seed=11, ckpt_every=0, adaptive_batch=True,
               grow_threshold=1.0, grow_patience=2, grow_cooldown=3,
               max_global_batch=16)
    return launch(4, "adaptive", {"arch": "tiny", "attn_chunk": 32,
                                  "seed": 3, "dir": str(tmp / "ck"),
                                  "config": cfg, "steps": 10}, tmp,
                  timeout=240)


def test_fit_adaptive_across_ranks_grows_batch_and_span(adaptive_ranks):
    """4 ranks: batch 8 -> 16 and span 2 -> 4 (one lane a rank, the
    reference's growth with dp = 4) at the controller's step; the stream
    contiguous, rows doubling at the boundary, LR rescaled upward."""
    r0 = adaptive_ranks[0]
    log = r0["resize_log"]
    assert len(log) == 1, log
    p = log[0]
    assert (p["old_batch"], p["new_batch"]) == (8, 16)
    assert (p["old_span"], p["new_span"]) == (2, 4)
    assert p["new_lr"] > p["old_lr"] == 0.02
    assert r0["seen"] == list(range(10)) and r0["hist"] == list(range(10))
    rows = {s: n for s, _, n in r0["rows"]}
    assert rows[p["step"]] == 2 * rows[p["step"] - 1] == 16
    assert r0["eff"]["span"] == 4 and r0["eff"]["dp"] == 4
    assert r0["meta"]["adaptive_batch"] is True
    assert np.isfinite(r0["losses"]).all()


def test_fit_adaptive_across_ranks_agrees(adaptive_ranks):
    """Every rank took the same decisions (resize log, LR bitwise) and
    holds the same params bits after every step; the resumed segment is
    bitwise a plain session restored from the boundary checkpoint at the
    resized point."""
    r0 = adaptive_ranks[0]
    for r in adaptive_ranks:
        assert r["resize_log"] == r0["resize_log"]
        assert r["lr"] == r0["lr"]
        assert r["digests"] == r0["digests"]
        for a, b in zip(jax.tree.leaves(r["params"]),
                        jax.tree.leaves(r0["params"])):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jax.tree.leaves(r["plain_params"]),
                        jax.tree.leaves(r["params"])):
            np.testing.assert_array_equal(a, b)
