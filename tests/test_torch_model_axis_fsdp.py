"""Both axes at once: the data-axis regimes (ZeRO-1 optimizer state,
ZeRO-2 lane gradients, FSDP params, span below the data ranks,
accumulation) on a (data, model) grid of ranks, held to the JAX package:

  (a) three runs on 8 gloo CPU ranks, a (data 4, model 2) grid, against
      the reference's `build_runtime` on a forced 8-device (4, 2) mesh,
      two steps in fp32 from the same params and batches:
        1. reduced qwen3-32b in its preset's regime, built by
           `TrainSession.from_config(EngineConfig.preset("qwen3-32b",
           model_mesh=2, ...))`: span 2 (hier-RVH over lane groups of 2),
           fsdp, scatter_grads, backend gspmd_tree, accum_steps 2, adam;
        2. reduced gemma-7b at vocab 256 (the tied table vocab-parallel
           and FSDP-sharded on d_model), span 4 == dp, fsdp, momentum
           (RVH keeping each rank's piece, pre-point ZeRO-1);
        3. reduced qwen3-32b at span 2 with neither fsdp nor
           scatter_grads, lamb: ZeRO-1 alone under the model axis, the
           trust ratio's norms summed over the lane group, then over the
           model group. (At span == dp LAMB's state sits at the post
           point, one whole lane a rank, where the reference shards
           nothing over data either.)
      Params and optimizer state gathered to full leaves, losses; the
      leaves whole on the data axis bitwise across each data group and
      those whole on both across each model group, after every step;
  (b) each rank holds the reference's `local_shape` over {data, model}
      of params, optimizer state and the lane gradient (the tree the
      combiner gets). Where the reference stacks the lanes ([span, ...])
      over the data axis, one lane a device, the rank holds that lane's
      part. Where it stacks them replicated (below span == dp: each
      device holds every lane's 1/dp piece), the rank holds its own
      lane's lane-group part: the reference's part of one lane with its
      data dim's 1/dp piece widened to the lane group's 1/g (the same
      elements in all, for a leaf the data axis divides; 1/span of them
      for one it does not, whose every lane the reference keeps whole
      on every device). Below span == dp without fsdp and scatter_grads
      the reference's lane gradient stays whole on the data axis, and the
      port all-reduces it whole and takes its lane-group part as a view,
      so there the gradient is not compared;
  (c) a checkpoint saved by run 1's session restores bitwise in one
      process (the lanes stacked), and that process's next checkpoint
      restores bitwise into the (4, 2) fsdp layout;
  (d) with nothing spawned, for every preset at (data, model) of (4, 2)
      and (16, 16): `param_specs` over both axes equal to the
      reference's, and the plan's shapes of params, lane gradients and
      ZeRO-1 state (both points) against the reference's specs
      (`plan_lane_specs` and `build_runtime`'s state plan).

One JAX subprocess and one 8-rank launch serve (a)-(c); the reference
runs while the ranks do.

Tolerances, with their reasons (test_torch_sharding.py's and
test_torch_model_axis.py's):
  * params 1e-5 absolute over two steps at lr 1e-3 for momentum; under
    adam and lamb at most 1% of the elements may differ by more than
    1e-6, none by more than lr a step (adam moves an element by ~lr
    whatever its gradient's size, so an element whose gradient is near
    zero can go either way); losses 1e-5 relative;
  * optimizer state: within STATE_RTOL of the leaf's largest element
    (the same fp32 sums in another order: the reduce-scatters over each
    lane group, the model group's all-reduces, the chunk-major RVH
    buckets, the dots summed over the lane group and the model group);
  * checkpoints: bitwise.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch import tree as T
from repro_torch.bridge import params_to_numpy
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data import pipeline as TP
from repro_torch.engine.build import _param_shapes
from repro_torch.models import build_model
from repro_torch.parallel import sharding as S

from torch_dist_workers import SRC, launch

SEQ, BATCH, LR, CHUNK, STEPS = 16, 8, 1e-3, 16, 2
STATE_RTOL = 1e-4
GRID = (4, 2)

CASES = [
    dict(name="qwen3_preset", arch="qwen3-32b",
         session=dict(reduced=True, model_mesh=2, span=2, accum_steps=2,
                      optimizer="adam", lr=LR, seq_len=SEQ,
                      global_batch=BATCH, attn_chunk=CHUNK,
                      async_checkpoint=False),
         policy=dict(span=2, fsdp=True, scatter_grads=True,
                     backend="gspmd_tree", accum_steps=2, optimizer="adam")),
    dict(name="gemma_fsdp_v256", arch="gemma-7b", cfg=dict(vocab_size=256),
         policy=dict(span=0, fsdp=True, backend="rvh",
                     optimizer="momentum")),
    dict(name="qwen3_lamb_zero1", arch="qwen3-32b",
         policy=dict(span=2, backend="gspmd_tree", optimizer="lamb")),
]
for _c in CASES:
    _c.update(lr=LR, steps=STEPS, attn_chunk=CHUNK, mesh=GRID)

_REF = r"""
import dataclasses, json, sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs.base import get_reduced
from repro.engine import build_runtime
from repro.engine.build import plan_lane_specs
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.parallel.policy import RunPolicy
from repro.parallel.sharding import ShardingPolicy
inputs, out_path, cases = sys.argv[1], sys.argv[2], eval(sys.argv[3])
data = np.load(inputs)
name = lambda p: "/".join(str(getattr(k, "key", k)) for k in p)
pairs = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
flat = lambda t: {name(p): np.asarray(v) for p, v in pairs(t)}
held = lambda t: [list(v.sharding.shard_shape(v.shape)) for _, v in pairs(t)]
res, shapes = {}, {}
for c in cases:
    mesh = make_mesh_compat(c["mesh"], ("data", "model"))
    cfg = dataclasses.replace(get_reduced(c["arch"]), **c.get("cfg", {}))
    model = build_model(cfg, compute_dtype=jnp.float32,
                        attn_chunk=c["attn_chunk"])
    rpol = RunPolicy(**c["policy"])
    rt = build_runtime(model, mesh, rpol, lr=c["lr"])
    state = rt.init_state(jax.random.key(0))
    state["params"] = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(state["params"]),
        [jax.device_put(data[c["name"] + "/init/" + name(p)], v.sharding)
         for p, v in pairs(state["params"])])
    dp, tp = c["mesh"]
    span = rpol.span or dp
    pshapes = jax.eval_shape(model.init, jax.random.key(0))
    spol = ShardingPolicy(fsdp_axis="data" if rpol.fsdp else None,
                          tp_size=tp, fsdp_size=dp)
    _, gspecs = plan_lane_specs(cfg, pshapes, spol, rpol, span, dp,
                                ("data",))
    shapes[c["name"]] = {
        "params": held(state["params"]),
        "state": {k: held(t) for k, t in state["opt"]["inner"].items()},
        "grads": [list(NamedSharding(mesh, s).shard_shape(
                      (span,) + tuple(x.shape)))
                  for s, x in zip(jax.tree.leaves(
                      gspecs, is_leaf=lambda s: isinstance(
                          s, jax.sharding.PartitionSpec)),
                      jax.tree.leaves(pshapes))]}
    step = jax.jit(rt.train_step)
    for s in range(c["steps"]):
        state, m = step(state, {k: data[f"{c['name']}/batch{s}/{k}"]
                                for k in ("tokens", "labels")})
        res[f"{c['name']}/loss{s}"] = np.asarray(m["loss"])
    for k, v in flat(state["params"]).items():
        res[f"{c['name']}/params/{k}"] = v
    for k, v in flat(state["opt"]["inner"]).items():
        res[f"{c['name']}/inner/{k}"] = v
np.savez(out_path, **res)
open(out_path + ".json", "w").write(json.dumps(shapes))
print("OK")
"""


def _case_cfg(case):
    return dataclasses.replace(get_reduced(case["arch"]),
                               **case.get("cfg", {}))


def _inputs(path):
    out = {}
    for c in CASES:
        cfg = _case_cfg(c)
        model = build_model(cfg, compute_dtype=torch.float32,
                            attn_chunk=CHUNK)
        for p, v in T.flatten_with_path(params_to_numpy(
                model.init(torch.Generator().manual_seed(7))))[0]:
            out[c["name"] + "/init/" + "/".join(p)] = v
        src = TP.SyntheticLM(TP.DataConfig(seq_len=SEQ, global_batch=BATCH,
                                           vocab_size=cfg.vocab_size,
                                           seed=3))
        rng = np.random.default_rng(11)
        for s in range(STEPS):
            b = src.batch(s)
            for r, n in enumerate(rng.integers(0, SEQ // 2, size=BATCH)):
                b["labels"][r, :n] = -100
            for k in ("tokens", "labels"):
                out[f"{c['name']}/batch{s}/{k}"] = b[k]
    np.savez(path, **out)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid")
    _inputs(tmp / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF, str(tmp / "inputs.npz"),
         str(tmp / "ref.npz"), repr(CASES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = launch(8, "grid", {"inputs": str(tmp / "inputs.npz"),
                                   "cases": CASES, "dir": str(tmp / "ck"),
                                   "ckpt": True}, tmp, timeout=400)
        log, _ = ref.communicate(timeout=400)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log
    shapes = json.loads((tmp / "ref.npz.json").read_text())
    return ranks, np.load(tmp / "ref.npz"), shapes


def _flat(tree, prefix=""):
    return {prefix + "/".join(p): v for p, v in T.flatten_with_path(tree)[0]}


def _params_close(got, want, adaptive, what):
    diff = np.abs(got - want)
    if adaptive:
        assert diff.max() <= STEPS * LR and (diff > 1e-6).mean() < 1e-2, \
            (what, diff.max(), (diff > 1e-6).mean())
    else:
        assert diff.max() <= 1e-5, (what, diff.max())


def _state_close(got, want, what):
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= STATE_RTOL, (what, err)


# ----------------------------------------------------------- (a) training
@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_grid_run_matches_reference_build_runtime(runs, i):
    ranks, ref, _ = runs
    case, got = CASES[i], ranks[0]["cases"][i]
    name = case["name"]
    adaptive = case["policy"]["optimizer"] in ("adam", "lamb")
    assert tuple(got["mesh"]) == GRID and got["both"] > 0
    assert got["path"] == ("rvh" if not case["policy"]["span"]
                           else "hier-rvh")
    # the session's preset resolves to the regime the reference runs
    assert got["policy"] == case["policy"]
    for s in range(STEPS):
        np.testing.assert_allclose(got["losses"][s], ref[f"{name}/loss{s}"],
                                   rtol=1e-5)
    params = _flat(got["params"])
    keys = [k[len(name) + 8:] for k in ref.files
            if k.startswith(f"{name}/params/")]
    assert sorted(keys) == sorted(params)
    for k in keys:
        want = ref[f"{name}/params/{k}"]
        assert params[k].shape == want.shape, k
        _params_close(params[k], want, adaptive, k)
    state = {}
    for sub, tree in got["state"].items():
        state.update(_flat(tree, sub + "/"))
    keys = [k[len(name) + 7:] for k in ref.files
            if k.startswith(f"{name}/inner/")]
    assert sorted(keys) == sorted(state) and keys
    for k in keys:
        want = ref[f"{name}/inner/{k}"]
        assert state[k].shape == want.shape, k
        _state_close(state[k], want, k)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_grid_ranks_agree(runs, i):
    """The leaves whole on the data axis agree bitwise across each data
    group after every step, and those whole on both axes across each
    model group."""
    for r in runs[0]:
        got = r["cases"][i]
        assert all(got["data_bitwise"]) and all(got["model_bitwise"])


# ------------------------------------------------------- (b) held shapes
def _same_held(port, ref, stacked, span, dim, what):
    """The port's shape of a leaf against the reference's local shape
    (module docstring, (b)): equal; where the reference stacks the lanes
    (`stacked`), equal to one lane's part, whose data dim `dim` (None:
    the data axis does not divide the leaf) is widened `span` times where
    the lanes are replicated."""
    port, ref = tuple(port), tuple(ref)
    if stacked:
        lanes, ref = ref[0], list(ref[1:])
        if lanes == span and dim is not None:
            ref[dim] *= span
        ref = tuple(ref)
    assert port == ref, (what, port, ref)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_each_rank_holds_the_reference_local_shape(runs, i):
    ranks, _, shapes = runs
    case = CASES[i]
    want = shapes[case["name"]]
    n = len(want["params"])
    span = case["policy"]["span"] or GRID[0]
    for r in ranks:
        got = r["cases"][i]["shapes"]
        assert [list(s) for s in got["params"]] == want["params"]
        stacked = r["cases"][i]["point"] == "post" and span > 1
        dims = r["cases"][i]["dims"]
        for sub, leaves in got["state"].items():
            assert len(leaves) == n
            for j, (p, w) in enumerate(zip(leaves, want["state"][sub])):
                _same_held(p, w, stacked, span, dims[j], f"state/{sub}/{j}")
        assert len(got["grads"]) == n
        pol = case["policy"]
        if span == GRID[0] or pol.get("fsdp") or pol.get("scatter_grads"):
            for j, (p, w) in enumerate(zip(got["grads"], want["grads"])):
                _same_held(p, w, True, span, dims[j], f"grads/{j}")
        # below the whole model a rank
        full = sum(np.prod(x.shape) for x in T.leaves(_param_shapes(
            _case_cfg(case))))
        assert sum(np.prod(s) for s in got["params"]) < full


# -------------------------------------------------------- (c) checkpoints
def test_grid_checkpoint_restores_in_one_process(runs):
    ck = runs[0][0]["ckpt"]
    assert ck["one_span"] == 2
    saved, got = T.leaves(ck["grid_saved"]), T.leaves(ck["one_restored"])
    assert len(saved) == len(got)
    assert all(np.array_equal(a, b) for a, b in zip(saved, got))


def test_one_process_checkpoint_restores_into_the_grid(runs):
    ck = runs[0][0]["ckpt"]
    saved, got = T.leaves(ck["one_saved"]), T.leaves(ck["grid_restored"])
    assert len(saved) == len(got)
    assert all(np.array_equal(a, b) for a, b in zip(saved, got))
    # the step taken in one process moved the params
    assert not all(np.array_equal(a, b) for a, b in
                   zip(T.leaves(ck["grid_saved"]), saved))


# -------------------------------------------- (d) specs, spawning nothing
GRIDS = [(4, 2), (16, 16)]


def _ref_plan(cfg, pshapes, dp, tp, span, fsdp, scatter, post):
    """The reference's local shapes of every leaf (flatten order) on a
    (dp, tp) mesh: params, lane gradients (`plan_lane_specs`' stacked
    specs) and the ZeRO-1 state (`build_runtime`'s plan: one lane's
    state, lane-stacked at the post point with span > 1)."""
    from repro.engine.build import _drop_axes, _prepend, plan_lane_specs
    from repro.parallel import sharding as JS
    from repro.parallel.policy import RunPolicy as JPol
    spol = JS.ShardingPolicy(fsdp_axis="data" if fsdp else None,
                             tp_size=tp, fsdp_size=dp)
    zpol = dataclasses.replace(spol, fsdp_axis="data")
    rpol = JPol(span=span, fsdp=fsdp, scatter_grads=scatter)
    _, gspecs = plan_lane_specs(cfg, pshapes, spol, rpol, span, dp,
                                ("data",))
    if post and span > 1:
        if span == dp:
            ospecs = jax.tree.map(lambda s: _prepend(
                _drop_axes(s, {"data"}), ("data",)),
                JS.param_specs(cfg, pshapes, spol),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        else:
            ospecs = jax.tree.map(lambda s: _prepend(s, None),
                                  JS.param_specs(cfg, pshapes, zpol),
                                  is_leaf=lambda x: isinstance(
                                      x, jax.sharding.PartitionSpec))
    else:
        ospecs = JS.param_specs(cfg, pshapes, zpol)
    leaf = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    sizes = {"data": dp, "model": tp}
    shapes = [tuple(x.shape) for x in jax.tree.leaves(pshapes)]
    held = lambda specs, lead: [
        JS.local_shape(lead + s, p, sizes)
        for s, p in zip(shapes, jax.tree.leaves(specs, is_leaf=leaf))]
    stacked = post and span > 1
    return {"params": held(JS.param_specs(cfg, pshapes, spol), ()),
            "grads": held(gspecs, (span,)),
            "state": held(ospecs, (span,) if stacked else ())}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grid_specs_and_plan_match_reference(arch):
    """Per preset, at (4, 2) and (16, 16), for span == dp and dp / 2,
    fsdp and scatter_grads on or off, at both points: the port's
    `param_specs` over both axes are the reference's, leaf for leaf; and
    a rank's plan (on stand-in comms, ZeRO-1 on) holds the reference's
    local shapes of params exactly, and of lane gradients and state by
    `_same_held`'s rule; the gradient where (b) compares it."""
    from types import SimpleNamespace
    from repro.configs.base import get_config as jget
    from repro.models import build_model as jbuild
    from repro.parallel import sharding as JS
    from repro_torch.parallel.zero import RankPlan
    cfg = get_config(arch)
    shapes = _param_shapes(cfg)
    names = [T.keystr(p) for p, _ in T.flatten_with_path(shapes)[0]]
    jcfg = jget(arch)
    jshapes = jax.eval_shape(jbuild(jcfg).init, jax.random.key(0))
    stand = lambda n, r: SimpleNamespace(world=n, rank=r)
    checked = 0
    for dp, tp in GRIDS:
        want = JS.param_specs(jcfg, jshapes, JS.ShardingPolicy(
            fsdp_axis="data", tp_size=tp, fsdp_size=dp))
        want = {jax.tree_util.keystr(p): tuple(s) for p, s in
                jax.tree_util.tree_flatten_with_path(
                    want, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0]}
        got = S.spec_leaves(S.param_specs(cfg, shapes, S.ShardingPolicy(
            fsdp_axis="data", tp_size=tp, fsdp_size=dp)))
        assert [want[n] for n in names] == got
        for span in (dp, dp // 2):
            for fsdp in (False, True):
                for scatter in (False, True):
                    for post in (False, True):
                        ref = _ref_plan(jcfg, jshapes, dp, tp, span,
                                        fsdp, scatter, post)
                        plan = RankPlan(cfg, shapes, stand(dp, dp - 1),
                                        span, fsdp=fsdp,
                                        scatter_grads=scatter, post=post,
                                        shard=True,
                                        model_comm=stand(tp, tp - 1))
                        assert plan.local_shapes("params") == \
                            ref["params"]
                        for j, (p, w) in enumerate(zip(
                                plan.local_shapes("state"), ref["state"])):
                            _same_held(p, w, post and span > 1, span,
                                       plan.dims[j], f"state {j}")
                        if span == dp or fsdp or scatter:
                            for j, (p, w) in enumerate(zip(
                                    plan.local_shapes("grads"),
                                    ref["grads"])):
                                _same_held(p, w, True, span, plan.dims[j],
                                           f"grads {j}")
                        checked += 1
    assert checked == len(GRIDS) * 16
