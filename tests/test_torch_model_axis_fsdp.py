"""Both axes at once: the data-axis regimes (ZeRO-1 optimizer state,
ZeRO-2 lane gradients, FSDP params, span below the data ranks,
accumulation) on a (data, model) grid of ranks, held to the JAX package:

  (a) nine runs on 8 gloo CPU ranks, a (data 4, model 2) grid (one on
      (8, 1)), against the reference's `build_runtime` on a forced
      8-device mesh of the same shape, two steps in fp32 from the same
      params and batches:
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
        4-9. every combiner on shards, through the session of qwen3-32b's
           preset: sum with momentum in the preset's regime at span 2,
           its CombineStats metrics held too (1e-5 relative); adascale
           at span 4 == dp with fsdp, per leaf and whole-model;
           adasum-linear with adam at the post point, scatter_grads
           without fsdp (ZeRO-1 state on the lane group's parts); mean
           with lamb at span 2 with ZeRO-1 alone; and the Adasum tree
           whole-model (per_layer=False) with fsdp + scatter_grads at
           span 4 on (8, 1), the shards' and the whole leaves' RVH
           buckets in lockstep (`use_pallas` off, the reference's
           default: its whole-model RVH under `use_pallas` marks leaf
           data as padding).
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
      (`plan_lane_specs` and `build_runtime`'s state plan); the post
      point's state plan for every combiner; whole-model RVH on a model
      axis raising the reference's ValueError.

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

_RUN = dict(reduced=True, lr=LR, seq_len=SEQ, global_batch=BATCH,
            attn_chunk=CHUNK, async_checkpoint=False)


def _preset(name, path, policy, mesh=GRID, **session):
    """A run of qwen3-32b's preset through the session: `session` over
    the preset's fields, `policy` the reference's RunPolicy it
    resolves to, `path` the combine path it takes."""
    return dict(name=name, arch="qwen3-32b", path=path, mesh=mesh,
                session=dict(_RUN, model_mesh=mesh[1], **session),
                policy=policy)


_FSDP = dict(fsdp=True, scatter_grads=True, backend="gspmd_tree")
CASES = [
    _preset("qwen3_preset", "hier-rvh",
            dict(span=2, **_FSDP, accum_steps=2, optimizer="adam"),
            span=2, accum_steps=2, optimizer="adam"),
    dict(name="gemma_fsdp_v256", arch="gemma-7b", cfg=dict(vocab_size=256),
         path="rvh", mesh=GRID,
         policy=dict(span=0, fsdp=True, backend="rvh",
                     optimizer="momentum")),
    dict(name="qwen3_lamb_zero1", arch="qwen3-32b", path="hier-rvh",
         mesh=GRID,
         policy=dict(span=2, backend="gspmd_tree", optimizer="lamb")),
    # every combiner on shards: the paper's sum baseline in the preset's
    # regime, its CombineStats held too
    _preset("sum_stats", "sum",
            dict(span=2, **_FSDP, accum_steps=1, optimizer="momentum",
                 combine_op="sum", combine_stats=True),
            span=2, accum_steps=1, optimizer="momentum", combine="sum",
            combine_stats=True),
    # adascale at span == dp on FSDP pieces (scatter_grads changes nothing
    # there), its gain per leaf and whole-model. With these seeds (init 7,
    # data 3) 3 and 8 of the 14 leaves clamp mu2 at 0 (gain 4) in steps 1
    # and 2, none closer to the clamp than 2.2e-3 of its ‖m‖², far past
    # what the sums' order moves; the whole-model gain is 3.91 and 3.99
    _preset("adascale_leaf", "adascale",
            dict(span=4, **_FSDP, accum_steps=1, optimizer="momentum",
                 combine_op="adascale", per_layer=True),
            span=4, accum_steps=1, optimizer="momentum",
            combine="adascale", per_layer=True),
    _preset("adascale_whole", "adascale",
            dict(span=4, **_FSDP, accum_steps=1, optimizer="momentum",
                 combine_op="adascale", per_layer=False),
            span=4, accum_steps=1, optimizer="momentum",
            combine="adascale", per_layer=False),
    # adasum-linear at the post point on ZeRO-2 parts, its adam state
    # ZeRO-1 on them, the params whole (the deltas gathered over the lane
    # group)
    _preset("linear_adam", "adasum-linear",
            dict(span=2, fsdp=False, scatter_grads=True, backend="linear",
                 accum_steps=1, optimizer="adam"),
            span=2, fsdp=False, backend="linear", accum_steps=1,
            optimizer="adam"),
    # mean at the pre point with ZeRO-1 alone: LAMB's norms over the
    # pieces
    _preset("mean_lamb_zero1", "mean",
            dict(span=2, fsdp=False, scatter_grads=False,
                 backend="gspmd_tree", accum_steps=1, optimizer="lamb",
                 combine_op="mean"),
            span=2, fsdp=False, scatter_grads=False, accum_steps=1,
            optimizer="lamb", combine="mean"),
    # whole-model Adasum on lane-group shards and whole leaves at once, a
    # data axis of 8 (the reference's fused whole-model tree)
    _preset("tree_whole_8x1", "hier-rvh",
            dict(span=4, **_FSDP, accum_steps=1, optimizer="momentum",
                 per_layer=False),
            mesh=(8, 1), span=4, accum_steps=1, optimizer="momentum",
            per_layer=False),
]
for _c in CASES:
    _c.update(lr=LR, steps=STEPS, attn_chunk=CHUNK)
# the CombineStats metrics (summarize_stats) held to the reference's
STATS = ("grad_dot", "grad_sq", "lane_cos", "grad_var", "grad_mu2",
         "gain_ratio", "noise_scale")

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
        for k, v in m.items():
            res[f"{c['name']}/metric{s}/{k}"] = np.asarray(v)
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
    assert tuple(got["mesh"]) == case["mesh"]
    assert (got["both"] > 0) is (case["mesh"][1] > 1)
    assert got["path"] == case["path"]
    # the session's preset resolves to the regime the reference runs
    assert got["policy"] == case["policy"]
    for s in range(STEPS):
        np.testing.assert_allclose(got["losses"][s], ref[f"{name}/loss{s}"],
                                   rtol=1e-5)
        if case["policy"].get("combine_stats"):
            for k in STATS:
                np.testing.assert_allclose(
                    got["metrics"][s][k], ref[f"{name}/metric{s}/{k}"],
                    rtol=1e-5, err_msg=k)
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
    dp = case["mesh"][0]
    span = case["policy"]["span"] or dp
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
        if span == dp or pol.get("fsdp") or pol.get("scatter_grads"):
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


@pytest.mark.parametrize("key", ["sum", "mean", "adascale", "adasum-linear",
                                 "adasum-rvh"])
def test_post_point_state_plan_for_every_combiner(key):
    """The post point's state plan does not depend on the combiner: below
    span == dp ZeRO-1 cuts each lane's state over its lane group (the
    reference scatters it over data, build.py:258-285), at span == dp
    each rank keeps its lane's whole; for reduced qwen3-32b at (4, 2),
    adam, every combiner the registry runs on shards, the regime passes
    the refusals and the plan's state is the reference's `local_shape`
    by `_same_held`'s rule."""
    from types import SimpleNamespace
    from repro.configs.base import get_reduced as jred
    from repro.models import build_model as jbuild
    from repro_torch.engine.build import _check_regime, _plan_sharding
    from repro_torch.parallel.policy import RunPolicy
    from repro_torch.parallel.zero import RankPlan
    cfg = get_reduced("qwen3-32b")
    shapes = _param_shapes(cfg)
    jshapes = jax.eval_shape(jbuild(jred("qwen3-32b")).init,
                             jax.random.key(0))
    dp, tp = GRID
    stand = lambda n, r: SimpleNamespace(world=n, rank=r)
    for span in (dp, dp // 2):
        pol = RunPolicy(span=span, optimizer="adam", backend="gspmd_tree")
        _check_regime(SimpleNamespace(cfg=cfg), pol, key, span, dp, tp)
        sharded = _plan_sharding(pol, "post", span, dp, True, True)
        assert sharded is (span < dp)
        ref = _ref_plan(jred("qwen3-32b"), jshapes, dp, tp, span, False,
                        False, True)
        plan = RankPlan(cfg, shapes, stand(dp, dp - 1), span, fsdp=False,
                        scatter_grads=False, post=True, shard=sharded,
                        model_comm=stand(tp, tp - 1))
        for j, (p, w) in enumerate(zip(plan.local_shapes("state"),
                                       ref["state"])):
            _same_held(p, w, True, span, plan.dims[j], f"state {j}")
        assert any(d is not None for d in plan.dims) is sharded


def test_whole_model_rvh_on_a_model_axis_raises():
    """Whole-model Adasum collapses every leaf into one segment with one
    replication factor; on a model axis qwen3-32b's leaves have two (the
    norms are whole on it), and the port raises the reference's
    ValueError (its assertion, rvh.py:296-299), before the first step."""
    from types import SimpleNamespace
    from repro_torch.core.rvh import (check_whole_model, replication_factors,
                                      rvh_plan)
    from repro_torch.parallel.zero import RankPlan
    cfg = get_reduced("qwen3-32b")
    stand = lambda n, r: SimpleNamespace(world=n, rank=r)
    plan = RankPlan(cfg, _param_shapes(cfg), stand(4, 0), 2, fsdp=True,
                    scatter_grads=True, post=False, shard=True,
                    model_comm=stand(2, 0))
    factors = replication_factors(plan.mspecs, 2)
    assert sorted(set(factors)) == [0.5, 1.0]
    with pytest.raises(ValueError, match="uniform TP sharding"):
        check_whole_model(factors)
    leaves = [torch.empty(s, device="meta")
              for s in plan.local_shapes("grads")]
    with pytest.raises(ValueError, match="uniform TP sharding"):
        rvh_plan(leaves, 2, 0, per_layer=False, shard_dims=plan.dims,
                 factors=factors, lane_group=2)
    # one factor for every leaf plans, its whole leaves at 1/g
    got = rvh_plan(leaves, 2, 0, per_layer=False, shard_dims=plan.dims,
                   factors=[1.0] * len(leaves), lane_group=2)
    assert [b.sharded for b in got] == [False, True]
    assert [b.scale.tolist() for b in got] == [[0.5, 1.0], [1.0, 1.0]]
