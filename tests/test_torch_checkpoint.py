"""The port's checkpoint manager (`repro_torch.checkpoint`): the reference
manager's cases (tests/test_checkpoint_data.py, tests/test_pipeline.py's
async cases, tests/test_chaos.py's corruption cases) on port state, the
bf16 payload without ml_dtypes, and checkpoints across frameworks:

  * a `repro` TrainSession checkpoint (span 2 at the post point, so the
    optimizer state carries the lane axis) restores into the port, and
    a port checkpoint into `repro`, on a 2-device CPU mesh in a JAX
    subprocess;
  * a port re-save of the restored state gives the reference's manifest
    entry for entry (file, path, shape, dtype, crc32);
  * one step from the restored state in each framework agrees within
    tests/test_torch_train.py's tolerances (params 1e-5 absolute; under
    adam at most 1% of the elements beyond 1e-6 and none beyond lr a
    step: adam moves an element by ~lr whatever its gradient's size).
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import CheckpointManager as JCM
from repro_torch import tree as T
from repro_torch.checkpoint import (AsyncCheckpointManager,
                                    CheckpointIntegrityError,
                                    CheckpointManager, reshard_lanes)
from repro_torch.engine import EngineConfig, TrainSession

SRC = Path(__file__).resolve().parents[1] / "src"
LR = 1e-3


@pytest.fixture(autouse=True)
def _keep_sigterm():
    """Sessions with a ckpt_dir install a SIGTERM handler (the preemption
    save); put the process's own back after each test."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


def state_like(seed=0, lanes=2):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 3, generator=g)},
            "opt": {"inner": {"m": torch.zeros(lanes, 4, 3)}, "step": 3},
            "step": 7}


def zeros_like(s):
    return T.map(lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor)
                 else 0, s)


def assert_equal(a, b):
    for x, y in zip(T.leaves(a), T.leaves(b)):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def manifest(root, step):
    return json.loads((Path(root) / f"step_{step:08d}" / "manifest.json")
                      .read_text())


# ------------------------------------------------- the reference's cases
class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        cm = CheckpointManager(tmp_path)
        s = state_like()
        cm.save(7, s)
        like = zeros_like(s)
        r = cm.restore(like)
        assert_equal(r, s)
        # restored in place: the template's own tensors hold the state
        assert r["params"]["w"] is like["params"]["w"]
        assert isinstance(r["step"], int) and r["opt"]["step"] == 3

    def test_atomic_no_partial_visible(self, tmp_path):
        cm = CheckpointManager(tmp_path)
        (tmp_path / "step_00000005.tmp").mkdir()
        assert cm.latest_step() is None
        cm.save(5, state_like())
        assert cm.latest_step() == 5

    def test_keep_n_gc(self, tmp_path):
        cm = CheckpointManager(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            cm.save(s, state_like(s))
        assert cm.all_steps() == [3, 4]

    def test_elastic_lane_reshard(self):
        arr = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
        down = reshard_lanes(arr, (4, 3))
        assert down.shape == (4, 3)
        np.testing.assert_allclose(down[0], arr[:2].mean(0))
        assert reshard_lanes(down, (8, 3)).shape == (8, 3)
        with pytest.raises(ValueError, match="cannot reshard"):
            reshard_lanes(arr, (3, 3))

    def test_elastic_restore_different_span(self, tmp_path):
        cm = CheckpointManager(tmp_path)
        s = state_like()
        s["opt"]["inner"]["m"] = torch.arange(24.).reshape(2, 4, 3)
        cm.save(1, s)
        like = zeros_like(state_like(lanes=4))             # span 2 -> 4
        r = cm.restore(like)
        assert r["opt"]["inner"]["m"].shape == (4, 4, 3)
        assert torch.equal(r["opt"]["inner"]["m"][1], s["opt"]["inner"]["m"][0])

    def test_restore_keeps_live_device_and_dtype(self, tmp_path):
        """A leaf restores in the live leaf's dtype (copy_ casts)."""
        cm = CheckpointManager(tmp_path)
        s = state_like()
        cm.save(1, s)
        like = zeros_like(s)
        like["params"]["w"] = like["params"]["w"].double()
        r = cm.restore(like)
        assert r["params"]["w"].dtype == torch.float64
        assert torch.equal(r["params"]["w"].float(), s["params"]["w"])

    def test_bf16_roundtrip_is_mldtypes_bytes(self, tmp_path):
        """bf16 leaves: the raw payload, '<V2' in the header, "bfloat16"
        in the manifest — np.save's bytes for an ml_dtypes array."""
        import ml_dtypes
        cm = CheckpointManager(tmp_path)
        w = torch.randn(5, 3).bfloat16()
        cm.save(1, {"params": {"w": w}, "step": 1})
        f = tmp_path / "step_00000001" / "leaf-00000.npy"
        ref = tmp_path / "ref.npy"
        np.save(ref, w.float().numpy().astype(ml_dtypes.bfloat16))
        assert f.read_bytes() == ref.read_bytes()
        assert manifest(tmp_path, 1)["leaves"][0]["dtype"] == "bfloat16"
        like = {"params": {"w": torch.zeros(5, 3, dtype=torch.bfloat16)},
                "step": 0}
        assert torch.equal(cm.restore(like)["params"]["w"], w)
        got = cm.restore_params({"w": torch.empty(5, 3, device="meta")},
                                device="cpu")
        assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], w)

    def test_restore_params_by_path(self, tmp_path):
        cm = CheckpointManager(tmp_path)
        s = state_like()
        cm.save(2, s)
        got = cm.restore_params({"w": torch.empty(4, 3, device="meta")},
                                device="cpu")
        assert torch.equal(got["w"], s["params"]["w"])
        with pytest.raises(ValueError, match=r"\['params'\]\['nope'\]"):
            cm.restore_params({"w": torch.empty(4, 3, device="meta"),
                               "nope": torch.empty(2, device="meta")},
                              device="cpu")


# ------------------------------------------------------- async manager
class TestAsyncCheckpoint:
    def test_roundtrip_through_barrier(self, tmp_path):
        cm = AsyncCheckpointManager(tmp_path)
        s = state_like(7)
        cm.save(7, s)
        assert cm.latest_step() == 7        # a barrier
        assert_equal(cm.restore(zeros_like(s)), s)
        cm.close()

    def test_snapshot_survives_in_place_update(self, tmp_path):
        """The host snapshot is taken before save() returns, so a later
        in-place step (the port's adam and combine write in place)
        cannot change what is written."""
        cm = AsyncCheckpointManager(tmp_path)
        w = torch.arange(12, dtype=torch.float32).reshape(4, 3)
        state = {"w": w.clone()}
        cm.save(1, state)
        state["w"].mul_(0).sub_(1.0)        # the next step, in place
        cm.wait()
        r = cm.restore({"w": torch.zeros(4, 3)})
        assert torch.equal(r["w"], w)
        cm.close()

    def test_overlapping_saves_serialize(self, tmp_path):
        cm = AsyncCheckpointManager(tmp_path, keep=10)
        for s in range(5):
            cm.save(s, state_like(s))
        assert cm.all_steps() == [0, 1, 2, 3, 4]
        cm.close()

    def test_writer_error_surfaces_at_barrier(self, tmp_path):
        cm = AsyncCheckpointManager(tmp_path)
        cm.save(1, {"w": torch.zeros(3)})
        cm.wait()
        cm._future = cm._pool.submit(lambda: (_ for _ in ()).throw(
            OSError("disk full")))
        with pytest.raises(OSError, match="disk full"):
            cm.latest_step()
        cm.close()

    def test_sigterm_drains_inflight_write_then_saves(self, tmp_path):
        """SIGTERM during a background write must not be dropped: drain,
        final save, exit 143 — with both checkpoints durable."""
        code = rf"""
import os, signal, torch
from repro_torch.checkpoint import AsyncCheckpointManager
cm = AsyncCheckpointManager(r"{tmp_path}/ck")
state = {{"w": torch.zeros(256, 256), "step": 1}}
cm.install_preemption_handler(lambda: (cm.save(9, state), cm.wait()))
cm.save(1, state)                      # in-flight background write
try:
    os.kill(os.getpid(), signal.SIGTERM)
except SystemExit as e:
    assert e.code == 143, e.code
    assert cm.all_steps() == [1, 9], cm.all_steps()
    print("OK")
"""
        res = subprocess.run([sys.executable, "-c", code],
                             env=dict(os.environ, PYTHONPATH=str(SRC)),
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0 and "OK" in res.stdout, res.stderr


# ------------------------------------------------ integrity / quarantine
def _two_steps(root):
    cm = CheckpointManager(root)
    cm.save(1, state_like(1))
    cm.save(2, state_like(2))
    return cm


def _flip(root, step):
    f = Path(root) / f"step_{step:08d}" / "leaf-00001.npy"
    b = bytearray(f.read_bytes())
    b[-1] ^= 0x40
    f.write_bytes(bytes(b))


def _tear(root, step):
    f = Path(root) / f"step_{step:08d}" / "leaf-00001.npy"
    f.write_bytes(f.read_bytes()[:20])


def _drop_leaf(root, step):
    (Path(root) / f"step_{step:08d}" / "leaf-00001.npy").unlink()


@pytest.mark.parametrize("fault,problem", [
    (_flip, "checksum mismatch"), (_tear, "unreadable leaf"),
    (_drop_leaf, "missing leaf")])
def test_corrupt_newest_quarantined_falls_back(tmp_path, capsys, fault,
                                               problem):
    cm = _two_steps(tmp_path)
    fault(tmp_path, 2)
    r = cm.restore(zeros_like(state_like()))
    assert_equal(r["params"], state_like(1)["params"])
    assert cm.restore_fallbacks == 1
    assert [q["step"] for q in cm.quarantined] == [2]
    assert problem in str(cm.quarantined[0]["problems"])
    assert (tmp_path / "step_00000002.bad").is_dir()
    assert cm.all_steps() == [1]
    assert "quarantined step 2" in capsys.readouterr().out


def test_missing_manifest_step_invisible(tmp_path):
    cm = _two_steps(tmp_path)
    (tmp_path / "step_00000002" / "manifest.json").unlink()
    assert cm.latest_step() == 1
    cm.restore(zeros_like(state_like()))
    assert cm.restore_fallbacks == 0 and not cm.quarantined


def test_explicit_bad_step_raises_and_all_corrupt_is_valueerror(tmp_path):
    cm = _two_steps(tmp_path)
    _flip(tmp_path, 2)
    with pytest.raises(CheckpointIntegrityError, match="step 2"):
        cm.restore(zeros_like(state_like()), step=2)
    assert cm.all_steps() == [1]
    _flip(tmp_path, 1)
    assert cm.validate_step(1)
    with pytest.raises(ValueError, match="all quarantined"):
        cm.restore(zeros_like(state_like()))


# ------------------------------------------------ across frameworks
ARCH, SEQ, BATCH = "gemma-7b", 16, 8
_CFG = dict(arch=ARCH, reduced=True, span=2, backend="gspmd_tree",
            optimizer="adam", combine_point="post", lr=LR, seq_len=SEQ,
            global_batch=BATCH, ckpt_every=10 ** 6, log_every=10 ** 6)

_REF = r"""
import sys, json, numpy as np, jax
from repro.configs.base import get_reduced
from repro.engine import EngineConfig, TrainSession
from repro.models import build_model
a_dir, b_dir, out = sys.argv[1:4]
cfg = dict(json.loads(sys.argv[4]))
model = build_model(get_reduced(cfg["arch"]), attn_chunk=16,
                    compute_dtype=jax.numpy.float32)
flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                  jax.tree_util.tree_flatten_with_path(t)[0]}
# A: the reference's own run; its step-1 checkpoint is what the port
# restores, and its step 2 the uninterrupted trajectory
s = TrainSession.from_config(EngineConfig(**cfg, ckpt_dir=a_dir),
                             model=model)
assert s.runtime.span == 2, s.runtime.span
s.fit(1); s.checkpoint.wait()
s.fit(2); s.close()
res = {"A/" + k: v for k, v in flat(s.state).items()}
# B: the port's step-1 checkpoint, restored here, one more step
t = TrainSession.from_config(EngineConfig(**cfg, ckpt_dir=b_dir),
                             model=model, callbacks=[])
t.fit(2)
res.update({"B/" + k: v for k, v in flat(t.state).items()})
np.savez(out, **res)
print("OK")
"""


def _port_session(ckpt_dir, **kw):
    """fp32 compute on both sides, as tests/test_torch_train.py runs."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    cfg = EngineConfig(**dict(_CFG, ckpt_dir=str(ckpt_dir), **kw))
    model = build_model(get_reduced(ARCH), compute_dtype=torch.float32,
                        attn_chunk=16)
    return TrainSession.from_config(cfg, model=model, device="cpu",
                                    callbacks=[])


def _flat(state):
    return {T.keystr(p): v for p, v in T.flatten_with_path(state)[0]}


def _close(got, want):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    diff = np.abs(g - np.asarray(want, np.float32))
    assert diff.max() <= 3 * LR and (diff > 1e-6).mean() < 1e-2


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cross")
    a, b = tmp / "A", tmp / "B"
    # the port's run: step 1 checkpointed into B, then the step after
    old = signal.getsignal(signal.SIGTERM)
    try:
        s = _port_session(b)
        s.fit(1)
        s.save_sync(1)
        s.fit(2)
        port_uninterrupted = {k: (v.clone() if isinstance(v, torch.Tensor)
                                  else v) for k, v in _flat(s.state).items()}
        s.close()
    finally:
        signal.signal(signal.SIGTERM, old)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    res = subprocess.run(
        [sys.executable, "-c", _REF, str(a), str(b), str(tmp / "ref.npz"),
         json.dumps(_CFG)], env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr[-4000:]
    ref = dict(np.load(tmp / "ref.npz"))
    return {"tmp": tmp, "a": a, "b": b, "ref": ref,
            "port": port_uninterrupted}


def test_reference_checkpoint_restores_into_port(cross, capsys):
    """repro's step-1 checkpoint (lane-axis adam state [2, ...]) restores
    into the port; re-saved by the port it gives the same manifest,
    entry for entry, and the files' bytes; one step on from it agrees
    with the reference's own step."""
    s = _port_session(cross["a"])
    assert s.restore(1) == 1
    assert "resumed from step 1" in capsys.readouterr().out
    m = s.state["opt"]["inner"]["m"]["embed"]["table"]
    assert m.shape[0] == 2
    c = cross["tmp"] / "C"
    CheckpointManager(c).save(1, s.state)
    want, got = manifest(cross["a"], 1), manifest(c, 1)
    keys = ("file", "path", "shape", "dtype", "crc32")
    assert [[e[k] for k in keys] for e in got["leaves"]] == \
        [[e[k] for k in keys] for e in want["leaves"]]
    assert got["n_leaves"] == want["n_leaves"] and got["step"] == 1
    for e in want["leaves"]:
        assert (c / "step_00000001" / e["file"]).read_bytes() == \
            (cross["a"] / "step_00000001" / e["file"]).read_bytes()
    s.step()
    for k, v in _flat(s.state["params"]).items():
        _close(v, cross["ref"]["A/['params']" + k])
    assert s.state["step"] == int(cross["ref"]["A/['step']"]) == 2
    s.close()


def test_port_checkpoint_restores_into_reference(cross):
    """The port's step-1 checkpoint restores into repro (fp32); the
    reference's step from it agrees with the port's uninterrupted step,
    and the reference's manifest reads the port's files (crc32 and
    dtypes validated on load)."""
    ref = cross["ref"]
    for k, v in cross["port"].items():
        if k.startswith("['params']"):
            _close(v, ref["B/" + k])
    assert int(ref["B/['opt']['step']"]) == cross["port"]["['opt']['step']"]
    assert not JCM(cross["b"]).validate_step(1)


def test_reference_bf16_leaf_restores_into_port(tmp_path):
    """A bf16 leaf written by repro (ml_dtypes on its side) restores into
    the port, which reads it without ml_dtypes."""
    w = jnp.asarray(np.random.default_rng(0).standard_normal((6, 5)),
                    jnp.bfloat16)
    JCM(tmp_path).save(3, {"params": {"w": w, "b": jnp.ones(5)},
                           "step": jnp.asarray(3, jnp.int32)})
    cm = CheckpointManager(tmp_path)
    like = {"params": {"w": torch.zeros(6, 5, dtype=torch.bfloat16),
                       "b": torch.zeros(5)}, "step": 0}
    r = cm.restore(like)
    want = torch.from_numpy(np.array(w.astype(jnp.float32)))
    assert torch.equal(r["params"]["w"].float(), want) and r["step"] == 3
    got = cm.restore_params({"w": torch.empty(6, 5, device="meta"),
                             "b": torch.empty(5, device="meta")},
                            device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(), want)
