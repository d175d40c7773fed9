"""The model axis on the MoE, MLA and vision-frontend decoders, held to
the JAX package's `build_runtime` on forced CPU meshes:

  (a) four tensor-parallel runs on 4 gloo CPU ranks, two steps in fp32
      from the same params and batches:
        1. reduced mixtral-8x22b on a (2, 2) mesh (its experts split on
           d_ff, `expert_partition="hidden"`), momentum, Adasum RVH,
           built by `TrainSession.from_config`;
        2. reduced moonshot-v1-16b-a3b on (2, 2) (`expert_partition=
           "expert"`, which the reference's rule puts on the layer axis
           of the `blocks` stack: each model rank holds one of the two
           MoE layers whole; a shared expert; the first layer dense, the
           `dense_blocks` stack), adam;
        3. reduced minicpm3-4b on (2, 2) (MLA; the tied table at vocab
           256, vocab-parallel), lamb;
        4. reduced llava-next-34b padded for a (1, 4) mesh (kv 2 -> 4
           heads), momentum: the projector, the patch embeddings and
           padded heads together;
  (b) the three presets' own regimes on 8 gloo ranks, a forced (4, 2)
      mesh, each built by `TrainSession.from_config(EngineConfig.preset
      (...))`: fsdp, scatter_grads, gspmd_tree, span 2 (the presets'
      span 4 leaves no lane group at 4 data ranks) and the preset's
      accumulation (mixtral 8, llava 4, moonshot none), in fp32;
      moonshot at 2 layers, the dense one and one MoE layer: the axis
      cannot cut one MoE layer, so every model rank runs all the experts
      (cut over the data axis) beside its shard of the shared expert;
  (c) each rank holds the reference's `local_shape` over {data, model}
      of params, optimizer state and the lane gradient (the rule of
      test_torch_model_axis_fsdp.py's (b));
  (d) the router, shared-expert and q_norm / kv_norm leaves held on
      their own, params and state: a gate gradient that is one rank's
      part, not the model group's sum, fails here;
  (e) the leaves whole on the data axis agree bitwise across each data
      group after every step, and those whole on both axes across each
      model group;
  (f) run 1's (2, 2) checkpoint restores bitwise in one process, and
      that process's next checkpoint restores bitwise into the grid.

Three JAX subprocesses (forced CPU devices; a smaller mesh takes the
first devices) and the two gloo launches run at once.

Tolerances, with their reasons (test_torch_model_axis.py's):
  * params 1e-5 absolute over two steps at lr 1e-3 for momentum; under
    adam and lamb at most 1% of the elements may differ by more than
    1e-6, none by more than lr a step; losses 1e-5 relative; optimizer
    state within 1e-4 of the leaf's largest element. The two packages
    sum the same fp32 products in another order (the model group's
    all-reduces, the MoE's partial outputs summed over the group, the
    vocab-parallel cross entropy, RVH's dots summed over the grid);
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
from repro_torch.configs import get_reduced
from repro_torch.data import pipeline as TP
from repro_torch.engine.build import _param_shapes
from repro_torch.models import build_model

from torch_dist_workers import SRC, launch

SEQ, LR, CHUNK, STEPS = 16, 1e-3, 16, 2
STATE_RTOL = 1e-4
F32 = dict(param_dtype="float32", accum_dtype="float32",
           opt_state_dtype="float32")

TP_CASES = [
    dict(name="mixtral_hidden", arch="mixtral-8x22b", mesh=(2, 2), batch=8,
         session=dict(reduced=True, model_mesh=2, span=0,
                      fsdp=False, scatter_grads=False, backend="rvh",
                      accum_steps=1, optimizer="momentum", lr=LR,
                      seq_len=SEQ, global_batch=8, attn_chunk=CHUNK,
                      async_checkpoint=False, **F32),
         policy=dict(span=0, backend="rvh", optimizer="momentum")),
    dict(name="moonshot_expert", arch="moonshot-v1-16b-a3b", mesh=(2, 2),
         batch=8, policy=dict(span=0, backend="rvh", optimizer="adam")),
    dict(name="minicpm3_mla", arch="minicpm3-4b", mesh=(2, 2), batch=8,
         cfg=dict(vocab_size=256),
         policy=dict(span=0, backend="rvh", optimizer="lamb")),
    dict(name="llava_padded", arch="llava-next-34b", mesh=(1, 4), batch=8,
         cfg=dict(n_kv_heads=4, orig_heads=4),
         policy=dict(span=0, backend="rvh", optimizer="momentum")),
]
GRID = (4, 2)
_REGIME = dict(span=2, fsdp=True, scatter_grads=True, backend="gspmd_tree")


def _preset(name, arch, optimizer, accum, batch, **cfg):
    return dict(name=name, arch=arch, mesh=GRID, batch=batch, cfg=cfg,
                session=dict(reduced=True, model_mesh=GRID[1], span=2,
                             optimizer=optimizer, lr=LR, seq_len=SEQ,
                             global_batch=batch, attn_chunk=CHUNK,
                             async_checkpoint=False, **F32),
                policy=dict(_REGIME, accum_steps=accum, optimizer=optimizer))


GRID_CASES = [
    _preset("mixtral_preset", "mixtral-8x22b", "momentum", 8, 32),
    _preset("moonshot_preset", "moonshot-v1-16b-a3b", "adam", 1, 8,
            n_layers=2),
    _preset("llava_preset", "llava-next-34b", "momentum", 4, 16),
]
CASES = TP_CASES + GRID_CASES
for _c in CASES:
    _c.update(lr=LR, steps=STEPS, attn_chunk=CHUNK)
# the reference's cases in three processes at once (~25-30 s of compiles
# each)
REF_GROUPS = [("mixtral_hidden", "moonshot_expert"),
              ("minicpm3_mla", "llava_padded", "llava_preset"),
              ("mixtral_preset", "moonshot_preset")]
# the leaves (d) holds on their own, by case
OWN = {"mixtral_hidden": ("moe/router",),
       "moonshot_expert": ("moe/router", "moe/shared/"),
       "minicpm3_mla": ("attn/q_norm/", "attn/kv_norm/"),
       "mixtral_preset": ("moe/router",),
       "moonshot_preset": ("moe/router", "moe/shared/")}

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
        pre = f"{c['name']}/batch{s}/"
        state, m = step(state, {k[len(pre):]: data[k] for k in data.files
                                if k.startswith(pre)})
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
        B = c["batch"]
        src = TP.SyntheticLM(TP.DataConfig(seq_len=SEQ, global_batch=B,
                                           vocab_size=cfg.vocab_size,
                                           seed=3))
        rng = np.random.default_rng(11)
        for s in range(STEPS):
            b = src.batch(s)
            for r, n in enumerate(rng.integers(0, SEQ // 2, size=B)):
                b["labels"][r, :n] = -100
            if cfg.frontend != "none":      # unit-scale patch embeddings
                b["frontend_embeds"] = rng.standard_normal(
                    (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                        np.float32)
            for k, v in b.items():
                out[f"{c['name']}/batch{s}/{k}"] = v
    np.savez(path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    _inputs(tmp / "inputs.npz")
    refs = []
    for tag, names in enumerate(REF_GROUPS):
        cases = [c for c in CASES if c["name"] in names]
        n = max(np.prod(c["mesh"]) for c in cases)
        env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
        refs.append(subprocess.Popen(
            [sys.executable, "-c", _REF, str(tmp / "inputs.npz"),
             str(tmp / f"ref_{tag}.npz"), repr(cases)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        spec = {"inputs": str(tmp / "inputs.npz")}
        four = launch(4, "grid", dict(spec, cases=TP_CASES, ckpt=True,
                                      dir=str(tmp / "ck4")), tmp,
                      timeout=400)
        eight = launch(8, "grid", dict(spec, cases=GRID_CASES,
                                       dir=str(tmp / "ck8")), tmp,
                       timeout=400)
        logs = [r.communicate(timeout=400)[0] for r in refs]
    finally:
        for r in refs:
            if r.poll() is None:
                r.kill()
                r.wait()
    ref, shapes = {}, {}
    for tag, (r, log) in enumerate(zip(refs, logs)):
        assert r.returncode == 0, log
        got = np.load(tmp / f"ref_{tag}.npz")
        ref.update({k: got[k] for k in got.files})
        shapes.update(json.loads((tmp / f"ref_{tag}.npz.json").read_text()))
    return four, eight, ref, shapes


def _ranks(runs, i):
    """Every rank's record of case i."""
    n = len(TP_CASES)
    return [r["cases"][i if i < n else i - n]
            for r in (runs[0] if i < n else runs[1])]


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


def _trees(got):
    params = _flat(got["params"])
    state = {}
    for sub, tree in got["state"].items():
        state.update(_flat(tree, sub + "/"))
    return params, state


IDS = [c["name"] for c in CASES]


# ----------------------------------------------------------- (a), (b)
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_family_run_matches_reference_build_runtime(runs, i):
    ref = runs[2]
    case, got = CASES[i], _ranks(runs, i)[0]
    name = case["name"]
    adaptive = case["policy"]["optimizer"] in ("adam", "lamb")
    assert tuple(got["mesh"]) == case["mesh"]
    assert got["path"] == ("rvh" if not case["policy"]["span"]
                           else "hier-rvh")
    assert got["policy"] == case["policy"]
    for s in range(STEPS):
        np.testing.assert_allclose(got["losses"][s], ref[f"{name}/loss{s}"],
                                   rtol=1e-5)
    params, state = _trees(got)
    keys = [k[len(name) + 8:] for k in ref
            if k.startswith(f"{name}/params/")]
    assert sorted(keys) == sorted(params)
    for k in keys:
        want = ref[f"{name}/params/{k}"]
        assert params[k].shape == want.shape, k
        _params_close(params[k], want, adaptive, k)
    keys = [k[len(name) + 7:] for k in ref
            if k.startswith(f"{name}/inner/")]
    assert sorted(keys) == sorted(state) and keys
    for k in keys:
        want = ref[f"{name}/inner/{k}"]
        assert state[k].shape == want.shape, k
        _state_close(state[k], want, k)


# ------------------------------------------------------------------- (c)
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_each_rank_holds_the_reference_local_shape(runs, i):
    case = CASES[i]
    want = runs[3][case["name"]]
    n = len(want["params"])
    dp = case["mesh"][0]
    span = case["policy"]["span"] or dp
    for got in _ranks(runs, i):
        held = got["shapes"]
        assert [list(s) for s in held["params"]] == want["params"]
        stacked = got["point"] == "post" and span > 1
        for sub, leaves in held["state"].items():
            assert len(leaves) == n
            for j, (p, w) in enumerate(zip(leaves, want["state"][sub])):
                _same_held(p, w, stacked, span, got["dims"][j],
                           f"state/{sub}/{j}")
        assert len(held["grads"]) == n
        for j, (p, w) in enumerate(zip(held["grads"], want["grads"])):
            _same_held(p, w, True, span, got["dims"][j], f"grads/{j}")
        full = sum(np.prod(x.shape) for x in T.leaves(_param_shapes(
            _case_cfg(case))))
        assert sum(np.prod(s) for s in held["params"]) < full


def _same_held(port, ref, stacked, span, dim, what):
    """test_torch_model_axis_fsdp.py's rule: equal; where the reference
    stacks the lanes, equal to one lane's part, its data dim widened
    `span` times where the lanes are replicated."""
    port, ref = tuple(port), tuple(ref)
    if stacked:
        lanes, ref = ref[0], list(ref[1:])
        if lanes == span and dim is not None:
            ref[dim] *= span
        ref = tuple(ref)
    assert port == ref, (what, port, ref)


# ------------------------------------------------------------------- (d)
OWN_IDS = [n for n in IDS if n in OWN]


@pytest.mark.parametrize("name", OWN_IDS)
def test_router_shared_and_latent_norms_on_their_own(runs, name):
    """The leaves a model group computes whole from its sharded work:
    the router (its gradient through gates that weight each rank's part
    of the expert output), the shared experts' shards, MLA's q_norm and
    kv_norm (over the gathered latents): params and every state leaf,
    each to its case's tolerance."""
    ref = runs[2]
    i = IDS.index(name)
    case, got = CASES[i], _ranks(runs, i)[0]
    adaptive = case["policy"]["optimizer"] in ("adam", "lamb")
    params, state = _trees(got)
    own = lambda k: any(m in k for m in OWN[name])
    keys = [k for k in params if own(k)]
    assert keys
    for k in keys:
        _params_close(params[k], ref[f"{name}/params/{k}"], adaptive, k)
    skeys = [k for k in state if own(k)]
    assert skeys
    for k in skeys:
        _state_close(state[k], ref[f"{name}/inner/{k}"], k)


# ------------------------------------------------------------------- (e)
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_family_ranks_agree(runs, i):
    for got in _ranks(runs, i):
        assert all(got["data_bitwise"]) and all(got["model_bitwise"])


# ------------------------------------------------------------------- (f)
def test_mixtral_grid_checkpoint_restores_in_one_process(runs):
    ck = runs[0][0]["ckpt"]
    saved, got = T.leaves(ck["grid_saved"]), T.leaves(ck["one_restored"])
    assert len(saved) == len(got)
    assert all(np.array_equal(a, b) for a, b in zip(saved, got))


def test_one_process_mixtral_checkpoint_restores_into_the_grid(runs):
    ck = runs[0][0]["ckpt"]
    saved, got = T.leaves(ck["one_saved"]), T.leaves(ck["grid_restored"])
    assert len(saved) == len(got)
    assert all(np.array_equal(a, b) for a, b in zip(saved, got))
    assert not all(np.array_equal(a, b) for a, b in
                   zip(T.leaves(ck["grid_saved"]), saved))


# ------------------------------------------------------- (g) the bridge
BRIDGE = [("mixtral-8x22b", 2), ("moonshot-v1-16b-a3b", 2),
          ("minicpm3-4b", 4), ("llava-next-34b", 4)]


@pytest.mark.parametrize("arch,tp", BRIDGE, ids=[a for a, _ in BRIDGE])
def test_bridge_pads_and_shards_the_family_leaves(arch, tp):
    """`pad_params` gives the head-padded config's exact params (the
    padded model's logits, patch embeddings included, are the
    unpadded one's), and `tp_shard`'s pieces of every leaf (the expert
    stacks, MLA's projections, the projector) have the reference's
    `local_shape` under its model-axis specs and put back the leaf."""
    from repro.configs.base import get_reduced as jred
    from repro.configs.base import pad_heads_for_tp as jpad
    from repro.models import build_model as jbuild
    from repro.parallel import sharding as JS
    from repro_torch.bridge import pad_params, tp_shard
    from repro_torch.configs import pad_heads_for_tp
    cfg = get_reduced(arch)
    pcfg = pad_heads_for_tp(cfg, tp)
    model = build_model(cfg, compute_dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(4), device="cpu")
    padded = pad_params(params, cfg, pcfg)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 12)))
    embeds = None
    if cfg.frontend != "none":
        embeds = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32))
    np.testing.assert_allclose(
        build_model(pcfg, compute_dtype=torch.float32).forward(
            padded, tokens, embeds).numpy(),
        model.forward(params, tokens, embeds).numpy(), atol=1e-5)
    jcfg = jpad(jred(arch), tp)
    jshapes = jax.eval_shape(jbuild(jcfg).init, jax.random.key(0))
    specs = jax.tree.leaves(JS.param_specs(
        jcfg, jshapes, JS.ShardingPolicy(tp_size=tp)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jshapes)[0]]
    want = {n: JS.local_shape(x.shape, s, {"model": tp}) for n, x, s in
            zip(names, jax.tree.leaves(jshapes), specs)}
    whole = T.flatten_with_path(padded)[0]
    shards = [T.leaves(tp_shard(padded, pcfg, tp, m)) for m in range(tp)]
    for j, (path, x) in enumerate(whole):
        assert tuple(shards[0][j].shape) == want[T.keystr(path)], path
        parts = [s[j] for s in shards]
        if parts[0].shape == x.shape:
            assert all(torch.equal(p, x) for p in parts), path
        else:
            d = next(i for i, (a, b) in enumerate(zip(parts[0].shape,
                                                      x.shape)) if a != b)
            assert torch.equal(torch.cat(parts, d), x), path
