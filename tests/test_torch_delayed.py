"""The port's delayed combine (combine_delay=1) against the JAX package and
against its own contracts, after `tests/test_delayed_combine.py`:

  * combine_delay=0 is the synchronous step: no carry, no delayed pieces,
    bitwise-repeatable states for every span and combine point;
  * the single-program step, `DelayedCombineStream.step` and its
    `serial_step` give bitwise the same params and pending carry; the
    step-0 correction of the zero carry is exactly zero;
  * a restart in the middle of a round, from a checkpoint that holds the
    carry, is bitwise the uninterrupted run; a delayed checkpoint
    crosses between the packages both ways;
  * across ranks (two gloo ranks): the span == dp fallback warns once
    and names the path it takes ('rvh'), the stream and the serial step
    redo a round bitwise from a restored checkpoint, on every rank;
  * run_metadata and the config / CLI round-trip;
  * the correction on stacked lanes against the reference's
    `build_delayed_correction` (fused or not) on the same numpy lanes,
    and a 3-round delayed trajectory against the reference's real
    `build_runtime` (span 4 on an 8-device CPU mesh) from the same
    params on the same batches.

Tolerances: the correction within 1e-6 of each leaf's largest element
(the dots' summation order moves the Adasum scalars by ~1e-7 relative;
the lane mean is the same fp32 arithmetic); the trajectory's losses 1e-4
absolute and params as test_torch_train.py holds adam's (at most 1% of
the elements beyond 1e-6, none beyond lr a round); the carry within
1e-5 absolute (one round's local deltas, ~lr in size).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import combine as JC
from repro.engine import EngineConfig as JEngineConfig
from repro_torch import tree as T
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.core import combine as C
from repro_torch.data import pipeline as TP
from repro_torch.engine import EngineConfig, TrainSession, build_runtime
from repro_torch.models import build_model
from repro_torch.parallel.policy import RunPolicy
from repro_torch.runtime import DelayedCombineStream

from conftest import run_in_subprocess
from torch_dist_workers import launch

TINY = ("tiny", "dense", 2, 32, 2, 1, 64, 97)
SEQ, BATCH, LR = 16, 16, 1e-3


def _model():
    return build_model(ModelConfig(*TINY, head_dim=16),
                       compute_dtype=torch.float32, attn_chunk=16)


def _session(model, **kw):
    cfg = EngineConfig(**{**dict(combine="adasum", backend="gspmd_tree",
                                 span=4, optimizer="adam", seq_len=SEQ,
                                 global_batch=BATCH, data_seed=3), **kw})
    return TrainSession.from_config(
        cfg, model=model, device="cpu", callbacks=[],
        generator=torch.Generator().manual_seed(0))


def _snapshot(state, parts=("params", "pending")):
    return [x.clone() for p in parts if p in state
            for x in T.leaves(state[p])]


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------- combine_delay=0 contract
@pytest.mark.parametrize("point", ["pre", "post"])
@pytest.mark.parametrize("span", [2, 4])
def test_delay0_is_the_synchronous_step(span, point):
    model = _model()
    runs = []
    for _ in range(2):
        s = _session(model, span=span, combine_point=point, combine_delay=0)
        assert "pending" not in s.state
        rt = s.runtime
        assert rt.correction_fn is None and rt.local_fn is None
        assert rt.fold_fn is None
        for i in range(3):
            s.step(s.batch(i))
        runs.append(_snapshot(s.state))
        s.close()
    assert _equal(*runs)


# ----------------------------------------- delayed execution paths, bitwise
@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_delayed_paths_bitwise_and_cold_start_zero(optimizer):
    """single-program, stream and serial rounds give the same params and
    carry, bit for bit; the zero carry's correction is exactly zero and
    the correction does not consume a carry it is not handed over."""
    model = _model()
    s = _session(model, optimizer=optimizer, combine_delay=1)
    pending = s.state["pending"]
    assert all(x.shape[0] == 4 and x.dtype == torch.float32
               for x in T.leaves(pending))
    corr = s.runtime.correction_fn(pending)
    assert all(bool((x == 0).all()) for x in T.leaves(corr))
    assert all(x.numel() > 0 for x in T.leaves(pending))
    s.close()
    finals = {}
    for mode in ("single", "stream", "serial"):
        s = _session(model, optimizer=optimizer, combine_delay=1)
        if mode == "stream":
            s.use_delayed_stream(comm_delay=0.002)
            for i in range(4):
                m = s.step(s.batch(i))
            assert m["compute_s"] > 0 and m["combine_wait_s"] >= 0, m
        elif mode == "serial":
            stream = DelayedCombineStream(s.runtime)
            for i in range(4):
                s.state, m = stream.serial_step(s.state, s.batch(i))
            stream.close()
            assert "compute_s" in m and "combine_wait_s" in m
        else:
            for i in range(4):
                m = s.step(s.batch(i))
            assert "compute_s" not in m
        finals[mode] = _snapshot(s.state)
        s.close()
    assert _equal(finals["single"], finals["stream"])
    assert _equal(finals["single"], finals["serial"])


def test_delayed_checkpoint_restart_mid_round_bitwise(tmp_path):
    """6 straight rounds == 3 rounds + a checkpoint (the carry parked
    mid-pipeline) + a fresh session's resume + 3 more rounds, bitwise on
    params and carry: the in-flight delta is replayed, never dropped or
    applied twice. The checkpoint holds the reference's [span, ...] fp32
    `['pending']` leaves."""
    model = _model()
    a = _session(model, combine_delay=1)
    a.fit(6)

    def build(ck):
        cfg = EngineConfig(combine="adasum", backend="gspmd_tree", span=4,
                           optimizer="adam", seq_len=SEQ,
                           global_batch=BATCH, data_seed=3, combine_delay=1,
                           ckpt_dir=str(ck), ckpt_every=3, log_every=1)
        return TrainSession.from_config(
            cfg, model=model, device="cpu",
            generator=torch.Generator().manual_seed(0))

    b1 = build(tmp_path / "ck")
    b1.fit(3)
    assert b1.checkpoint.latest_step() == 3
    b1.close()
    man = json.loads((tmp_path / "ck" / "step_00000003" / "manifest.json")
                     .read_text())
    pend = [e for e in man["leaves"] if e["path"].startswith("['pending']")]
    assert len(pend) == len(T.leaves(a.state["params"]))
    assert all(e["shape"][0] == 4 and e["dtype"] == "float32"
               for e in pend)
    b2 = build(tmp_path / "ck")
    b2.fit(6)
    assert b2.state["step"] == 6
    assert _equal(_snapshot(a.state), _snapshot(b2.state))
    a.close()
    b2.close()


# ------------------------------------------------------------ across ranks
@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("delayed_ranks")
    return launch(2, "delayed", {
        "arch": "gemma-7b", "attn_chunk": 16, "seed": 7,
        "dir": str(tmp / "ck"),
        "config": dict(arch="gemma-7b", reduced=True, optimizer="momentum",
                       lr=LR, span=0, backend="gspmd_tree", seq_len=16,
                       global_batch=8, combine_delay=1)}, tmp)


def test_ranked_span_eq_dp_fallback_warns_once_and_tags_path(ranked):
    """backend='gspmd_tree' at span == dp: the reference falls back (with
    a warning) to the tree GSPMD runs across devices; the port runs RVH
    minus the cross-rank mean, warns once and says 'rvh'."""
    for r in ranked:
        assert len(r["warned"]) == 1, r["warned"]
        assert "runs as RVH" in r["warned"][0]
        assert r["path"] == "rvh" and r["delay"] == 1
        assert r["zero"]


def test_ranked_stream_and_serial_redo_the_round_bitwise(ranked):
    """Round 3 redone from the restored step-2 checkpoint (which holds
    each rank's carry as a lane row) through the stream (its exchange on
    a process group of its own, beside the step's collectives) and its
    serial step: bitwise the single-program round on each rank, with
    the params the same on both."""
    for r in ranked:
        assert r["stream"] == r["single"] and r["serial"] == r["single"]
        assert r["split_keys"] == ["combine_wait_s", "compute_s"]
        assert r["params_same_on_all_ranks"]
    # each rank's carry is its own lane's delta
    assert ranked[0]["single"] != ranked[1]["single"]


# ----------------------------------------------------- metadata and config
def test_run_metadata_keys():
    s = _session(_model(), span=2, combine_delay=1)
    md = s.run_metadata()
    for key in ("arch", "combine", "backend", "combine_path", "span", "dp",
                "local_steps", "combine_delay", "devices"):
        assert key in md, (key, md)
    assert md["combine_delay"] == 1 and md["combine_path"] == "gspmd-fused"
    assert not md["stats_enabled"]
    s.close()


def test_combine_delay_config_validation_and_cli_roundtrip():
    with pytest.raises(ValueError, match="combine_delay must be 0"):
        EngineConfig(combine_delay=2, global_batch=16).validate()
    with pytest.raises(ValueError, match="mutually exclusive"):
        EngineConfig(combine_delay=1, accum_steps=2,
                     global_batch=16).validate()
    with pytest.raises(ValueError, match="mutually exclusive"):
        EngineConfig(combine_delay=1, adaptive_batch=True,
                     ckpt_dir="ck").validate()
    EngineConfig(combine_delay=1, global_batch=16).validate()
    argv = ["--arch", "gemma-7b", "--combine-delay", "1", "--batch", "16"]
    cfg = EngineConfig.from_cli(argv)
    assert cfg.combine_delay == 1
    assert EngineConfig.from_dict(cfg.to_dict()) == cfg
    assert JEngineConfig.from_cli(argv).combine_delay == 1
    assert EngineConfig.from_cli(
        ["--arch", "gemma-7b", "--batch", "16"]).combine_delay == 0


def test_stream_needs_a_delayed_runtime():
    s = _session(_model(), combine_delay=0)
    with pytest.raises(ValueError, match="delayed-mode Runtime"):
        s.use_delayed_stream()
    s.close()


# ------------------------------------------------ against the JAX package
def _lanes(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((n, 3000)).astype(np.float32),
            "b": (3 * rng.standard_normal((n, 17, 64))).astype(np.float32),
            "c": rng.standard_normal((n, 5)).astype(np.float32)}


@pytest.mark.parametrize("cfg", [
    dict(), dict(per_layer=False), dict(use_pallas=True),
    dict(fused=False), dict(op="sum"), dict(backend="linear")])
def test_correction_matches_reference(cfg):
    lanes = _lanes()
    want = JC.build_delayed_correction(JC.CombineConfig(**cfg))(
        {k: jnp.asarray(v) for k, v in lanes.items()})
    got = C.build_delayed_correction(C.CombineConfig(**cfg))(
        {k: torch.from_numpy(v) for k, v in lanes.items()})
    for k in lanes:
        w = np.asarray(want[k])
        err = np.abs(got[k].numpy() - w).max()
        assert err <= 1e-6 * max(np.abs(w).max(), 1.0), (k, err)
    # one lane combines to itself: a zero correction
    one = C.fused_correction_tree({"a": torch.ones(1, 8)}, C.CombineConfig())
    assert torch.equal(one["a"], torch.zeros(8))


def test_delayed_trajectory_matches_reference_build_runtime(tmp_path):
    """3 delayed rounds of the reference's `build_runtime` (span 4 < dp
    8: the fused correction) and of the port's stacked lanes, adam at the
    post point, from the port's params on the pipeline's batches."""
    model = _model()
    params = params_to_numpy(model.init(torch.Generator().manual_seed(5)))
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat["init/" + prefix + k] = v
    walk(params, "")
    np.savez(tmp_path / "init.npz", **flat)
    out = tmp_path / "ref.npz"
    run_in_subprocess(f"""
import jax, numpy as np
from repro.configs.base import ModelConfig
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.engine import build_runtime
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.parallel.policy import RunPolicy
data = np.load({str(tmp_path / "init.npz")!r})
mesh = make_mesh_compat((8, 1), ("data", "model"))
model = build_model(ModelConfig(*{TINY!r}, head_dim=16),
                    compute_dtype=jax.numpy.float32, attn_chunk=16)
rt = build_runtime(model, mesh, RunPolicy(span=4, backend="gspmd_tree",
                   optimizer="adam", combine_delay=1), lr={LR})
state = rt.init_state(jax.random.key(0))
paths = jax.tree_util.tree_flatten_with_path(state["params"])[0]
state["params"] = jax.tree_util.tree_unflatten(
    jax.tree_util.tree_structure(state["params"]),
    [jax.device_put(data["init/" + "/".join(k.key for k in p)], v.sharding)
     for p, v in paths])
flat = lambda t: {{"/".join(k.key for k in p): np.asarray(v) for p, v in
                  jax.tree_util.tree_flatten_with_path(t)[0]}}
src = SyntheticLM(DataConfig(seq_len={SEQ}, global_batch={BATCH},
                             vocab_size=97, seed=3))
step = jax.jit(rt.train_step)
losses = []
for s in range(3):
    state, m = step(state, src.batch(s))
    losses.append(float(m["loss"]))
np.savez({str(out)!r}, losses=np.asarray(losses),
         **{{"params/" + k: v for k, v in flat(state["params"]).items()}},
         **{{"pending/" + k: v for k, v in flat(state["pending"]).items()}})
""", devices=8, timeout=600)
    ref = np.load(out)
    rt = build_runtime(model, RunPolicy(span=4, backend="gspmd_tree",
                                        optimizer="adam", combine_delay=1),
                       lr=LR)
    p = params_from_numpy(params, device="cpu", cfg=model.cfg)
    state = {"params": p, "opt": rt.dopt.init(p), "step": 0,
             "pending": T.map(lambda x: torch.zeros((4,) + tuple(x.shape)),
                              p)}
    src = TP.SyntheticLM(TP.DataConfig(seq_len=SEQ, global_batch=BATCH,
                                       vocab_size=97, seed=3))
    for s in range(3):
        state, m = rt.train_step(state, {k: torch.from_numpy(v) for k, v in
                                         src.batch(s).items()})
        np.testing.assert_allclose(float(m["loss"]), ref["losses"][s],
                                   atol=1e-4)
    for part in ("params", "pending"):
        got = params_to_numpy(state[part])
        keys = [k for k in ref.files if k.startswith(part + "/")]
        assert len(keys) == len(T.leaves(state[part]))
        for key in keys:
            node = got
            for q in key.split("/")[1:]:
                node = node[q]
            diff = np.abs(node - ref[key])
            if part == "params":
                assert diff.max() <= 3 * LR and (diff > 1e-6).mean() < 1e-2
            else:
                assert diff.max() <= 1e-5, (key, diff.max())


_CROSS = r"""
import sys, json, numpy as np, jax
from repro.configs.base import ModelConfig
from repro.engine import EngineConfig, TrainSession
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
a_dir, b_dir, out = sys.argv[1:4]
cfg = dict(json.loads(sys.argv[4]))
model = build_model(ModelConfig(*json.loads(sys.argv[5]), head_dim=16),
                    attn_chunk=16, compute_dtype=jax.numpy.float32)
mesh = make_mesh_compat((4, 1), ("data", "model"))
flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                  jax.tree_util.tree_flatten_with_path(t)[0]}
# A: the reference's own delayed run, step 1 checkpointed, then step 2
s = TrainSession.from_config(EngineConfig(**cfg, ckpt_dir=a_dir),
                             model=model, mesh=mesh)
s.fit(1); s.checkpoint.wait()
s.fit(2); s.close()
res = {"A/" + k: v for k, v in flat(s.state).items()}
# B: the port's step-1 checkpoint (with its pending carry), one more step
t = TrainSession.from_config(EngineConfig(**cfg, ckpt_dir=b_dir),
                             model=model, mesh=mesh, callbacks=[])
t.fit(2)
res.update({"B/" + k: v for k, v in flat(t.state).items()})
np.savez(out, **res)
print("OK")
"""


def test_delayed_checkpoint_crosses_packages(tmp_path):
    """A delayed run's checkpoint (params, adam's lane-axis state and the
    [span, ...] fp32 `['pending']` carry) restores across the packages
    both ways: the reference (4 CPU devices, span 2) takes one more round
    from the port's step 1, the port from the reference's, each agreeing
    with the other's own step 2; the port re-saves the reference's step
    with the same manifest entries."""
    import signal
    import subprocess
    import sys
    from repro_torch.checkpoint import CheckpointManager
    from torch_dist_workers import SRC
    cfg = dict(combine="adasum", backend="gspmd_tree", span=2,
               optimizer="adam", lr=LR, seq_len=SEQ, global_batch=BATCH,
               data_seed=3, combine_delay=1, ckpt_every=10 ** 6,
               log_every=10 ** 6)
    model = _model()

    def port(ck):
        return TrainSession.from_config(
            EngineConfig(**cfg, ckpt_dir=str(ck)), model=model,
            device="cpu", callbacks=[],
            generator=torch.Generator().manual_seed(0))

    old = signal.getsignal(signal.SIGTERM)
    try:
        s = port(tmp_path / "B")
        s.fit(1)
        s.save_sync(1)
        s.fit(2)
        mine = {T.keystr(p): v.clone() for p, v in
                T.flatten_with_path(s.state)[0]
                if isinstance(v, torch.Tensor)}
        s.close()
    finally:
        signal.signal(signal.SIGTERM, old)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run(
        [sys.executable, "-c", _CROSS, str(tmp_path / "A"),
         str(tmp_path / "B"), str(tmp_path / "ref.npz"), json.dumps(cfg),
         json.dumps(TINY)], env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr[-4000:]
    ref = dict(np.load(tmp_path / "ref.npz"))

    def close(got, want, part):
        diff = np.abs(got.detach().float().numpy() - want)
        if part == "params":
            assert diff.max() <= 3 * LR and (diff > 1e-6).mean() < 1e-2
        else:
            assert diff.max() <= 1e-5, diff.max()

    for part in ("params", "pending"):
        keys = [k for k in mine if k.startswith(f"['{part}']")]
        assert keys and all("B/" + k in ref for k in keys)
        for k in keys:
            close(mine[k], ref["B/" + k], part)
    # the reference's step-1 checkpoint into the port, one more round
    t = port(tmp_path / "A")
    assert t.restore(1) == 1
    assert t.state["pending"]["embed"]["table"].shape[0] == 2
    CheckpointManager(tmp_path / "C").save(1, t.state)
    want = json.loads((tmp_path / "A" / "step_00000001" / "manifest.json")
                      .read_text())
    got = json.loads((tmp_path / "C" / "step_00000001" / "manifest.json")
                     .read_text())
    keys = ("file", "path", "shape", "dtype", "crc32")
    assert [[e[k] for k in keys] for e in got["leaves"]] == \
        [[e[k] for k in keys] for e in want["leaves"]]
    t.step()
    for part in ("params", "pending"):
        for p, v in T.flatten_with_path(t.state[part])[0]:
            close(v, ref[f"A/['{part}']" + T.keystr(p)], part)
    t.close()
