"""The port's multi-rank training step (one process per rank over gloo on
the CPU) against the JAX package's real `build_runtime` on a 4-device
CPU mesh: RVH at span == dp with sgd (lr 1), momentum, adam and lamb,
local steps, accumulation and int8 wire compression; the hierarchical
span 2 < dp 4 path with adam, accumulation and local steps (each rank
taking its share of every microbatch); sum, mean, adasum-linear and
adascale at span == dp; the delayed combine at span == dp and at span 2
(no CombineStats there, as in the reference). Both sides start from the same params
(drawn by the port, carried through numpy) and take the same batches
(the pipeline's, with some labels masked so that the ranks of a lane
group hold different token counts). Every rank's params must be bitwise
equal after every step. Then the train CLI under
`torch.distributed.run`.

Tolerances (test_torch_train.py's), with their reasons:
  * losses 1e-4 absolute; params 1e-5 absolute over two steps at lr 1e-3
    (under adam at most 1% of the elements may differ by more than 1e-6,
    none by more than lr a step: adam moves an element by ~lr whatever
    its gradient's size);
  * sgd at lr 1: the update is the combined gradient itself, held within
    1e-5 of its leaf's largest element (summation order through the
    Adasum scalars);
  * CombineStats metrics: rtol 1e-3, as for the stacked lanes; under
    int8 round 0 dots the dequantized partner half against the
    reference's exact probe, rtol INT8_STATS_RTOL (lane_cos and the noise
    scale divide by small differences of the level-0 sums).
  * int8: the reference's device 0 keeps its own chunk exact where the
    port dequantizes it on every rank (core/rvh.py); at lr 1e-3 with
    momentum that moves params by ~1e-6, inside the 1e-5 above.
"""
import gc
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch import tree as T
from repro_torch.bridge import params_to_numpy
from repro_torch.configs import get_reduced
from repro_torch.control.noise import STAT_KEYS
from repro_torch.data import pipeline as TP
from repro_torch.models import build_model

from torch_dist_workers import SRC, launch

ARCH, SEQ, BATCH, LR, CHUNK = "gemma-7b", 16, 8, 1e-3, 16
INT8_STATS_RTOL = 1e-2

CASES = {   # name: (RunPolicy kwargs, lr)
    "rvh_sgd_lr1": (dict(span=0, backend="rvh", optimizer="sgd"), 1.0),
    "rvh_momentum": (dict(span=0, backend="rvh", optimizer="momentum"), LR),
    "rvh_adam": (dict(span=0, backend="rvh", optimizer="adam"), LR),
    "rvh_lamb": (dict(span=0, backend="rvh", optimizer="lamb"), LR),
    "rvh_local2_adam": (dict(span=0, backend="rvh", optimizer="adam",
                             local_steps=2), LR),
    "rvh_accum2_momentum": (dict(span=0, backend="rvh", optimizer="momentum",
                                 accum_steps=2), LR),
    "rvh_int8_momentum": (dict(span=0, backend="rvh", optimizer="momentum",
                               compress="int8"), LR),
    "span2_adam": (dict(span=2, backend="gspmd_tree", optimizer="adam"), LR),
    # the other combiners across ranks, at span == dp
    "sum_sgd_lr1": (dict(span=0, combine_op="sum", optimizer="sgd"), 1.0),
    "mean_momentum": (dict(span=0, combine_op="mean",
                           optimizer="momentum"), LR),
    "linear_adam": (dict(span=0, backend="linear", optimizer="adam"), LR),
    "adascale_sgd_lr1": (dict(span=0, combine_op="adascale",
                              optimizer="sgd"), 1.0),
    # accumulation and local steps across the ranks of a lane group
    "span2_accum2_momentum": (dict(span=2, backend="gspmd_tree",
                                   optimizer="momentum", accum_steps=2), LR),
    "span2_local2_momentum": (dict(span=2, backend="gspmd_tree",
                                   optimizer="momentum", local_steps=2), LR),
    # the delayed combine: RVH minus the cross-rank mean at span == dp,
    # the hierarchical RVH below it
    "rvh_delay_momentum": (dict(span=0, backend="rvh", optimizer="momentum",
                                combine_delay=1), LR),
    "span2_delay_adam": (dict(span=2, backend="gspmd_tree", optimizer="adam",
                              combine_delay=1), LR),
}
STEPS = 2

_REF = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from repro.configs.base import get_reduced
from repro.engine import build_runtime
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.parallel.policy import RunPolicy
inputs, out_path, cases, steps, keys = (sys.argv[1], sys.argv[2],
    eval(sys.argv[3]), int(sys.argv[4]), eval(sys.argv[5]))
data = np.load(inputs)
mesh = make_mesh_compat((4, 1), ("data", "model"))
model = build_model(get_reduced("gemma-7b"), compute_dtype=jnp.float32,
                    attn_chunk=16)
flat = lambda t: {"/".join(k.key for k in p): np.asarray(v) for p, v in
                  jax.tree_util.tree_flatten_with_path(t)[0]}
res = {}
for name, (pol, lr) in cases.items():
    rt = build_runtime(model, mesh, RunPolicy(**pol), lr=lr)
    state = rt.init_state(jax.random.key(0))
    paths = jax.tree_util.tree_flatten_with_path(state["params"])[0]
    state["params"] = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(state["params"]),
        [jax.device_put(data["init/" + "/".join(k.key for k in p)], v.sharding)
         for p, v in paths])
    step = jax.jit(rt.train_step)
    for s in range(steps):
        state, m = step(state, {k: data[f"batch{s}/{k}"]
                                for k in ("tokens", "labels")})
        res[f"{name}/loss{s}"] = np.asarray(m["loss"])
        for k in keys:
            if k in m:          # the delayed path collects no stats
                res[f"{name}/{k}{s}"] = np.asarray(m[k])
    for k, v in flat(state["params"]).items():
        res[f"{name}/final/{k}"] = v
np.savez(out_path, **res)
print("OK")
"""


def _inputs(path):
    """Port-drawn params and pipeline batches with ragged label masks."""
    cfg = get_reduced(ARCH)
    model = build_model(cfg, compute_dtype=torch.float32, attn_chunk=CHUNK)
    params = params_to_numpy(model.init(torch.Generator().manual_seed(7)))
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                out["init/" + prefix + k] = v
    walk(params, "")
    src = TP.SyntheticLM(TP.DataConfig(seq_len=SEQ, global_batch=BATCH,
                                       vocab_size=cfg.vocab_size, seed=3))
    rng = np.random.default_rng(11)
    for s in range(STEPS):
        b = src.batch(s)
        masked = rng.integers(0, SEQ // 2, size=BATCH)   # per-row prefix
        for r, n in enumerate(masked):
            b["labels"][r, :n] = -100
        out[f"batch{s}/tokens"] = b["tokens"]
        out[f"batch{s}/labels"] = b["labels"]
    np.savez(path, **out)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    inputs = _inputs(tmp / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF, str(tmp / "inputs.npz"),
         str(tmp / "ref.npz"), repr(CASES), str(STEPS), repr(STAT_KEYS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = launch(4, "train", {
            "inputs": str(tmp / "inputs.npz"), "arch": ARCH,
            "attn_chunk": CHUNK,
            "cases": [dict(policy=pol, lr=lr, steps=STEPS)
                      for pol, lr in CASES.values()]}, tmp, timeout=300)
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log
    port = {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}
    return port, np.load(tmp / "ref.npz"), inputs


def _path(pol):
    """The combine path the port names: RVH for the Adasum tree (at span
    < dp the hierarchical one), else the registry entry."""
    op = pol.get("combine_op", "adasum")
    if op == "adasum" and pol.get("backend") != "linear":
        return "hier-rvh" if pol["span"] else "rvh"
    return "adasum-linear" if op == "adasum" else op


def _leaf(tree, key):
    for p in key.split("/"):
        tree = tree[p]
    return tree


@pytest.mark.parametrize("name", list(CASES))
def test_train_steps_match_reference_build_runtime(runs, name):
    port, ref, inputs = runs
    ranks = port[name]
    pol, lr = CASES[name]
    # every rank: the same bits after every step
    assert all(all(r["bitwise"]) for r in ranks), [r["bitwise"]
                                                   for r in ranks]
    assert ranks[0]["path"] == _path(pol)
    got = ranks[0]
    for s in range(STEPS):
        np.testing.assert_allclose(got["losses"][s], ref[f"{name}/loss{s}"],
                                   atol=1e-4)
        keys = [k for k in STAT_KEYS if f"{name}/{k}{s}" in ref.files]
        assert sorted(got["stats"][s]) == sorted(keys)
        assert keys or pol.get("combine_delay")
        for k in keys:
            want = float(ref[f"{name}/{k}{s}"])
            if pol.get("compress") == "int8":
                err = abs(got["stats"][s][k] - want) / max(abs(want), 1e-30)
                print(f"{name} step {s} {k}: int8 off by {err:.2e}")
                assert err <= INT8_STATS_RTOL, (k, got["stats"][s][k], want)
            else:
                np.testing.assert_allclose(got["stats"][s][k], want,
                                           rtol=1e-3, atol=1e-9, err_msg=k)
    finals = [k[len(name) + 7:] for k in ref.files
              if k.startswith(f"{name}/final/")]
    assert len(finals) == len(T.leaves(got["params"]))
    for key in finals:
        g, w = _leaf(got["params"], key), ref[f"{name}/final/{key}"]
        diff = np.abs(g - w)
        if lr == 1.0:
            upd = w - inputs["init/" + key]
            assert diff.max() <= 1e-5 * np.abs(upd).max(), (key, diff.max())
        elif pol["optimizer"] == "adam":
            assert diff.max() <= STEPS * LR and (diff > 1e-6).mean() < 1e-2
        else:
            assert diff.max() <= 1e-5, (key, diff.max())


@pytest.mark.parametrize("world,span", [(2, 0), (4, 2)])
def test_checkpoint_across_ranks_is_the_stacked_layout(tmp_path, world,
                                                       span):
    """Adam at the post point (each rank holds its own lane's state), at
    span == dp (world 2) and below it (world 4, span 2: lane l is ranks
    2l and 2l+1): rank 0 writes the reference's logical layout — the same
    files, paths, shapes and dtypes as one process with the lanes
    stacked; at span == dp its lane-axis optimizer state and counters are
    bitwise that process's (the lane gradients are the same arithmetic on
    the same rows); below it the lane gradient is the lane group's
    token-weighted all-reduce, so the state is held within rtol 1e-4;
    params within the tolerances above (RVH and the stacked tree sum the
    Adasum dots in another order) — and restoring step 1 in place (each
    rank its own lane's row) and redoing step 2 is bitwise the
    uninterrupted run on every rank."""
    import json
    from pathlib import Path
    ck, single = tmp_path / "ck", tmp_path / "single"
    ranks = launch(world, "ckpt", {
        "arch": ARCH, "attn_chunk": CHUNK, "seed": 7, "dir": str(ck),
        "single": str(single),
        "config": dict(arch=ARCH, reduced=True, optimizer="adam", lr=LR,
                       span=span, backend="gspmd_tree" if span else "",
                       seq_len=SEQ, global_batch=BATCH)}, tmp_path)
    assert all(r["resumed_bitwise"] for r in ranks)
    read = lambda root: json.loads(
        (Path(root) / "step_00000001" / "manifest.json").read_text())
    got, want = read(ck), read(single)
    keys = ("file", "path", "shape", "dtype")
    assert [[e[k] for k in keys] for e in got["leaves"]] == \
        [[e[k] for k in keys] for e in want["leaves"]]
    m = [e for e in got["leaves"] if e["path"].startswith("['opt']['inner']")]
    assert m and all(e["shape"][0] == 2 for e in m)
    for g, w in zip(got["leaves"], want["leaves"]):
        a = np.load(ck / "step_00000001" / g["file"])
        b = np.load(single / "step_00000001" / w["file"])
        if g["path"].startswith("['params']"):
            diff = np.abs(a - b)
            assert diff.max() <= LR and (diff > 1e-6).mean() < 1e-2
        elif span and g["path"].startswith("['opt']['inner']"):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-9,
                                       err_msg=g["path"])
        else:
            assert g["crc32"] == w["crc32"], g["path"]
            np.testing.assert_array_equal(a, b)
    # each rank holds its own lane's state, with no lane axis
    for rank in ranks:
        assert rank["inner"]["m"]["embed"]["table"].ndim == 2


@pytest.mark.parametrize("world,srcs", [(2, [0, 1]), (4, [0, 2])])
def test_gather_to_host_takes_the_lane_leaders_rows(tmp_path, world, srcs):
    """The gather a checkpoint at the post point makes: the tensors of the
    source ranks (one a lane), stacked in rank order on rank 0's host,
    sent in many gloo messages; the other ranks get None; CPU tensors
    stage nothing."""
    ranks = launch(world, "gather", {"srcs": srcs}, tmp_path)
    rows = ranks[0]["rows"]
    assert rows.shape == (len(srcs), 3, 5)
    for i, r in enumerate(srcs):
        assert (rows[i] == r + 1).all(), (i, rows[i])
    assert all(r["rows"] is None for r in ranks[1:])
    assert all(r["staged"] == 0 for r in ranks)


def test_train_cli_on_two_cpu_ranks():
    """`torch.distributed.run` on two CPU ranks: rank 0 alone prints the
    [train] line (path rvh, world 2, gloo) and the final loss; the two
    flags a one-device run cannot use run here, and so do a non-Adasum
    combiner with the delayed combine and fp64 dots."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
            "--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "2",
            "--seq", "32", "--batch", "8"]
    for extra, path in (([], "path=rvh"),
                        (["--compress", "int8", "--combine", "adasum-rvh",
                          "--optimizer", "momentum"], "path=rvh"),
                        (["--combine", "sum", "--optimizer", "momentum",
                          "--combine-delay", "1", "--acc-dtype", "float64"],
                         "path=sum")):
        res = subprocess.run(base + extra, env=env, capture_output=True,
                             text=True, timeout=200)
        assert res.returncode == 0, res.stderr[-3000:]
        lines = res.stdout.splitlines()
        head = [ln for ln in lines if ln.startswith("[train] gemma-7b")]
        assert len(head) == 1, res.stdout
        assert path in head[0] and "world=2 dist=gloo" in head[0]
        assert sum("[train] done: final loss" in ln for ln in lines) == 1


def test_tree_ops_hold_no_reference_cycles():
    """Flattening, mapping and rebuilding a tree frees its leaves as soon
    as the caller drops them, without the cyclic garbage collector: a
    recursive closure in `repro_torch.tree` used to keep every leaf of
    every call alive until a collection, which on the card left two
    parameter-sized trees (8 GiB of gemma-7b's gradients and updates)
    allocated into the next step."""
    x = torch.zeros(1000)
    ref = weakref.ref(x)
    gc.disable()
    try:
        leaves, td = T.flatten({"a": {"b": x}, "c": (None, [x])})
        T.unflatten(td, leaves)
        T.map(lambda v: v + 1, {"a": x})
        T.leaves([x, {"d": x}])
        del leaves, x
        assert ref() is None
    finally:
        gc.enable()
