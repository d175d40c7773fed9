"""The data axis sharded across ranks (ZeRO-1 optimizer state, ZeRO-2
lane gradients, FSDP params; `repro_torch.parallel.sharding` and
`parallel.zero`), held to the JAX package:

  (a) the port's own copy of `param_specs` gives the reference's spec,
      leaf by leaf, for every preset at full width, at tp in {1, 2} x
      fsdp in {2, 4, 8} (shapes only: `jax.eval_shape` there, meta
      tensors here);
  (b) four sharded runs on 4 gloo CPU ranks against the reference's
      `build_runtime` on a forced 4-device (data 4, model 1) mesh, two
      steps from the same params and batches: reduced qwen3-32b with
      adam at span 2 under fsdp + scatter_grads (ZeRO-2, post-point
      ZeRO-1 in each lane group, FSDP), momentum at span == dp under
      fsdp (RVH without its allgather, pre-point ZeRO-1), lamb at span 2
      under scatter_grads (the trust ratio's norms summed over the lane
      group), and reduced mixtral-8x22b with adam at span 2 under fsdp +
      scatter_grads with accum_steps 2 and capacity_factor 8.0 (the MoE
      layer's capacity, slot order and aux loss taken over each whole
      microbatch its lane group's ranks split); params and optimizer
      state gathered to full leaves;
  (c) each rank's bytes of params and state are those the plan's
      `local_shape` gives;
  (d) the sharded run equals the port's own run with the lanes stacked
      on one process;
a checkpoint saved by a sharded world-4 run restored into a sharded
world-2 run and into one process, unsharded.

One JAX subprocess and one gloo launch serve every case; the reference
runs while the ranks do.

Tolerances, with their reasons (test_torch_dist_train.py's):
  * params 1e-5 absolute over two steps at lr 1e-3 for momentum; under
    adam and lamb at most 1% of the elements may differ by more than
    1e-6, none by more than lr a step (adam moves an element by ~lr
    whatever its gradient's size, so an element whose gradient is near
    zero can go either way);
  * optimizer state: within STATE_RTOL of the leaf's largest element
    (the same fp32 sums in another order: the reduce-scatter, the
    chunk-major RVH buckets, the dots summed over the lane group);
  * the port against itself (stacked lanes on one process): the same
    rules;
  * checkpoints: restored state bitwise equal to what was saved; the
    next step within the rules above of the uninterrupted run's.
"""
import dataclasses
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

CASES = [
    dict(name="adam_fsdp_scatter", arch="qwen3-32b",
         policy=dict(span=2, fsdp=True, scatter_grads=True,
                     backend="gspmd_tree", optimizer="adam")),
    dict(name="momentum_fsdp_rvh", arch="qwen3-32b",
         policy=dict(span=0, fsdp=True, backend="rvh",
                     optimizer="momentum")),
    dict(name="lamb_scatter", arch="qwen3-32b",
         policy=dict(span=2, scatter_grads=True, backend="gspmd_tree",
                     optimizer="lamb")),
    dict(name="mixtral_accum", arch="mixtral-8x22b",
         cfg=dict(capacity_factor=8.0),
         policy=dict(span=2, fsdp=True, scatter_grads=True,
                     backend="gspmd_tree", optimizer="adam",
                     accum_steps=2)),
]
for _c in CASES:
    _c.update(lr=LR, steps=STEPS, attn_chunk=CHUNK)
CKPT = dict(arch="qwen3-32b", attn_chunk=CHUNK, seed=5,
            config=dict(arch="qwen3-32b", reduced=True, optimizer="adam",
                        lr=LR, span=2, fsdp=True, scatter_grads=True,
                        backend="gspmd_tree", seq_len=SEQ,
                        global_batch=BATCH))

_REF = r"""
import dataclasses, sys, numpy as np, jax, jax.numpy as jnp
from repro.configs.base import get_reduced
from repro.engine import build_runtime
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.parallel.policy import RunPolicy
inputs, out_path, cases = sys.argv[1], sys.argv[2], eval(sys.argv[3])
data = np.load(inputs)
mesh = make_mesh_compat((4, 1), ("data", "model"))
name = lambda p: "/".join(str(getattr(k, "key", k)) for k in p)
flat = lambda t: {name(p): np.asarray(v) for p, v in
                  jax.tree_util.tree_flatten_with_path(t)[0]}
res = {}
for c in cases:
    cfg = dataclasses.replace(get_reduced(c["arch"]), **c.get("cfg", {}))
    model = build_model(cfg, compute_dtype=jnp.float32,
                        attn_chunk=c["attn_chunk"])
    rt = build_runtime(model, mesh, RunPolicy(**c["policy"]), lr=c["lr"])
    state = rt.init_state(jax.random.key(0))
    paths = jax.tree_util.tree_flatten_with_path(state["params"])[0]
    state["params"] = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(state["params"]),
        [jax.device_put(data[c["name"] + "/init/" + name(p)], v.sharding)
         for p, v in paths])
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
print("OK")
"""


# ------------------------------------------------------------ (a) the specs
def _ref_specs(arch, tp, fsdp):
    from repro.configs.base import get_config as jget
    from repro.models import build_model as jbuild
    from repro.parallel import sharding as JS
    cfg = jget(arch)
    shapes = jax.eval_shape(jbuild(cfg).init, jax.random.key(0))
    specs = JS.param_specs(cfg, shapes, JS.ShardingPolicy(
        fsdp_axis="data", tp_size=tp, fsdp_size=fsdp))
    pairs = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in pairs}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch):
    cfg = get_config(arch)
    shapes = _param_shapes(cfg)
    names = [T.keystr(p) for p, _ in T.flatten_with_path(shapes)[0]]
    sharded = 0
    for tp in (1, 2):
        for fsdp in (2, 4, 8):
            want = _ref_specs(arch, tp, fsdp)
            got = S.spec_leaves(S.param_specs(cfg, shapes, S.ShardingPolicy(
                fsdp_axis="data", tp_size=tp, fsdp_size=fsdp)))
            assert sorted(want) == sorted(names)
            for n, spec in zip(names, got):
                assert spec == want[n], (tp, fsdp, n, spec, want[n])
            sharded += sum(any(e is not None for e in s) for s in got)
            assert not S.spec_violations(
                dict(zip(names, got)), dict(zip(names, T.leaves(shapes))),
                {"data": fsdp, "model": tp})
    assert sharded


def test_shard_and_unshard_are_inverse():
    """`shard` takes a device's piece of a full tensor by the spec's axes
    (major to minor); `unshard` puts every device's piece back; the
    piece has `local_shape`."""
    x = torch.arange(4 * 6 * 8).reshape(4, 6, 8)
    sizes = {"lane": 2, "member": 2, "model": 2}
    spec = (("member", "lane"), None, "model")
    pieces = {}
    for lane in range(2):
        for member in range(2):
            for model in range(2):
                c = {"lane": lane, "member": member, "model": model}
                p = S.shard(x, spec, c, sizes)
                assert tuple(p.shape) == S.local_shape(x.shape, spec, sizes)
                assert torch.equal(p, x[member * 2 + lane:member * 2 + lane
                                        + 1, :, model * 4:model * 4 + 4])
                pieces[(lane, member, model)] = p
    back = S.unshard(lambda c: pieces[(c["lane"], c["member"], c["model"])],
                     spec, sizes)
    assert torch.equal(back, x)
    assert S.rename(spec, {"member": None}) == ("lane", None, "model")
    assert S.spec_axes(spec) == ("lane", "member", "model")


@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16)],
                         ids=["bf16+bf16", "bf16+fp32", "fp32+bf16"])
def test_fp32_accumulate_in_slices_is_bitwise(monkeypatch, dtypes):
    """FSDP's and ZeRO-2's `_add` (out += x in fp32, rounded once to
    out's dtype) gives the same bits a slice of ADD_PIECE elements at a
    time as on the whole tensor, a ragged last slice included."""
    from repro_torch.parallel import zero as Z
    g = torch.Generator().manual_seed(0)
    out0 = torch.randn(37, 29, generator=g).to(dtypes[0])
    x = torch.randn(37, 29, generator=g).to(dtypes[1])
    want = out0.clone().float().add_(x.float()).to(dtypes[0])
    monkeypatch.setattr(Z, "ADD_PIECE", 100)
    got = out0.clone()
    Z._add(got, x)
    assert torch.equal(got, want)
    got = out0.clone()
    Z._add(got, x.t().contiguous().t())      # a strided x
    assert torch.equal(got, want)


# The regimes of the ranked runtime's plan at world 4 (the reference's
# lane plan and ZeRO-1 state plan, build.py:146-177 and 261-284):
# (optimizer, span, policy fields, combiner key, whether it shards).
REGIMES = [
    ("momentum", 4, {}, "adasum-rvh", True),       # pre point: ZeRO-1
    ("momentum", 4, {}, "sum", True),              # pre point, any combiner
    ("sgd", 4, {}, "adasum-rvh", False),           # no state to shard
    ("sgd", 4, {"fsdp": True}, "adasum-rvh", True),
    ("adam", 4, {}, "adasum-rvh", False),          # post, span == dp
    ("adam", 4, {"scatter_grads": True}, "adasum-rvh", False),  # no-op there
    ("adam", 2, {}, "adasum-rvh", True),           # post, span < dp
    ("adam", 2, {}, "sum", True),                  # post, any combiner
    ("adam", 4, {"fsdp": True}, "adasum-rvh", True),
    ("adam", 2, {"fsdp": True}, "sum", True),      # fsdp, any combiner
]


@pytest.mark.parametrize("opt,span,fields,key,want", REGIMES,
                         ids=[f"{o}-span{s}-{'+'.join(f) or 'none'}-{k}"
                              for o, s, f, k, _ in REGIMES])
def test_plan_sharding_regimes(opt, span, fields, key, want):
    """Which regimes shard the data axis, whatever the combiner (each
    passes the refusals); a plan that shards nothing holds every leaf
    whole, and the synchronous step runs on it all the same."""
    from types import SimpleNamespace
    from repro_torch.engine.build import _check_regime, _plan_sharding
    from repro_torch.parallel.policy import RunPolicy
    from repro_torch.parallel.zero import RankPlan
    cfg = get_reduced("qwen3-32b")
    rpol = RunPolicy(optimizer=opt, span=span, **fields)
    point = "pre" if opt in ("sgd", "momentum") else "post"
    stateful = opt != "sgd"
    _check_regime(SimpleNamespace(cfg=cfg), rpol, key, span, 4, 1)
    got = _plan_sharding(rpol, point, span, 4, True, stateful)
    assert got is want
    plan = RankPlan(cfg, _param_shapes(cfg), SimpleNamespace(world=4, rank=1),
                    span, fsdp=rpol.fsdp, scatter_grads=rpol.scatter_grads,
                    post=point == "post", shard=got)
    assert any(d is not None for d in plan.dims) is want
    whole = [tuple(x.shape) for x in T.leaves(_param_shapes(cfg))]
    for which in ("params", "state", "grads"):
        held = plan.local_shapes(which)
        if not want:
            assert held == whole
        elif which == "state" and point == "pre" and stateful:
            assert held != whole        # ZeRO-1: 1/4 of each sharded leaf


# arch, span, policy fields: what a sharded data axis still refuses
SHARD_REFUSED = [("qwen3-32b", 4, {"fsdp": True, "combine_delay": 1}),
                 ("qwen3-32b", 2, {"scatter_grads": True, "local_steps": 2}),
                 ("seamless-m4t-large-v2", 4, {"fsdp": True})]


@pytest.mark.parametrize("arch,span,fields", SHARD_REFUSED,
                         ids=["delay", "local-steps", "encdec"])
def test_sharded_data_axis_refusals_name_item_7(arch, span, fields):
    """fsdp (or scatter_grads below span == dp) with the delayed combine,
    local steps or the encoder-decoder's own loop raises naming ROADMAP
    item 7, before any collective; without the sharding field it
    builds."""
    from types import SimpleNamespace
    from repro_torch.engine.build import _check_regime
    from repro_torch.parallel.policy import RunPolicy
    model = SimpleNamespace(cfg=get_reduced(arch))
    rpol = RunPolicy(optimizer="momentum", span=span, **fields)
    with pytest.raises(NotImplementedError, match=r"item 7\b"):
        _check_regime(model, rpol, "adasum-rvh", span, 4, 1)
    plain = {k: v for k, v in fields.items()
             if k not in ("fsdp", "scatter_grads")}
    _check_regime(model, RunPolicy(optimizer="momentum", span=span, **plain),
                  "adasum-rvh", span, 4, 1)


# ------------------------------------------------- (b)-(d) and checkpoints
def _inputs(path):
    out = {}
    for c in CASES:
        cfg = dataclasses.replace(get_reduced(c["arch"]), **c.get("cfg", {}))
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
    tmp = tmp_path_factory.mktemp("shard")
    inputs = _inputs(tmp / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF, str(tmp / "inputs.npz"),
         str(tmp / "ref.npz"), repr(CASES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = launch(4, "shard", {
            "inputs": str(tmp / "inputs.npz"), "cases": CASES,
            "ckpt": dict(CKPT, dir=str(tmp / "ck"))}, tmp, timeout=400)
        log, _ = ref.communicate(timeout=400)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log
    return ranks, np.load(tmp / "ref.npz"), inputs


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


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_sharded_run_matches_reference_build_runtime(runs, i):
    ranks, ref, _ = runs
    case, got = CASES[i], ranks[0][i]
    name = case["name"]
    adaptive = case["policy"]["optimizer"] in ("adam", "lamb")
    assert got["sharded_leaves"] > 0
    assert got["path"] == ("rvh" if not case["policy"]["span"]
                           else "hier-rvh")
    # the whole leaves, bitwise across the ranks after every step
    assert all(all(r[i]["bitwise"]) for r in ranks)
    for s in range(STEPS):
        np.testing.assert_allclose(got["losses"][s], ref[f"{name}/loss{s}"],
                                   atol=1e-4)
    params = _flat(got["params"])
    keys = [k[len(name) + 8:] for k in ref.files
            if k.startswith(f"{name}/params/")]
    assert sorted(keys) == sorted(params)
    for k in keys:
        _params_close(params[k], ref[f"{name}/params/{k}"], adaptive, k)
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
def test_each_rank_holds_its_shard(runs, i):
    """Every rank's bytes of params and of each optimizer state tree are
    the plan's `local_shape`s, and below the whole tree's."""
    ranks, _, _ = runs
    case = CASES[i]
    cfg = dataclasses.replace(get_reduced(case["arch"]), **case.get("cfg",
                                                                   {}))
    full = [int(np.prod(x.shape)) * 4
            for x in T.leaves(_param_shapes(cfg))]
    for r in ranks:
        held, plan = r[i]["params_bytes"]
        assert held == plan
        assert (sum(held) < sum(full)) == case["policy"].get("fsdp", False)
        held_s, plan_s = r[i]["state_bytes"]
        assert held_s == plan_s and held_s
        for tree in held_s:   # below one lane's whole state
            assert sum(tree) < sum(full)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_sharded_run_matches_stacked_lanes(runs, i):
    ranks, _, _ = runs
    case, got = CASES[i], ranks[0][i]
    adaptive = case["policy"]["optimizer"] in ("adam", "lamb")
    one = _flat(got["single_params"])
    for k, v in _flat(got["params"]).items():
        _params_close(v, one[k], adaptive, k)
    for sub, tree in got["state"].items():
        one = _flat(got["single_state"][sub])
        for k, v in _flat(tree).items():
            _state_close(v, one[k], sub + "/" + k)


def test_checkpoint_restores_across_worlds(runs):
    """A sharded world-4 run (adam, span 2, fsdp + scatter_grads) saves
    step 1 as the reference's full leaves; restored into a sharded
    world-2 run and into one process (lanes stacked, unsharded) it is
    bitwise what was saved, and the next step is the uninterrupted
    run's step 2."""
    ranks, _, _ = runs
    got = ranks[0][-1]
    assert got["world4_sharded"] > 0 and got["world2_plan"] == (1, 2)
    cfg = get_reduced(CKPT["arch"])
    shapes = {"['params']" + T.keystr(p): tuple(x.shape)
              for p, x in T.flatten_with_path(_param_shapes(cfg))[0]}
    for path, shape in shapes.items():
        assert tuple(got["manifest"][path]) == shape
        for sub in ("m", "v"):
            inner = path.replace("['params']", f"['opt']['inner']['{sub}']")
            assert tuple(got["manifest"][inner]) == (2,) + shape
    saved = T.leaves(got["saved"])
    for restored in (got["w2_restored"], got["one_restored"]):
        leaves = T.leaves(restored)
        assert len(leaves) == len(saved)
        assert all(np.array_equal(a, b) for a, b in zip(leaves, saved))
    after = T.leaves(got["after"])
    n_params = len(shapes)
    for nxt in (got["w2_next"], got["one_next"]):
        leaves = T.leaves(nxt)
        for j, (a, b) in enumerate(zip(leaves, after)):
            if j < n_params:
                _params_close(a, b, True, j)
            else:
                _state_close(a, b, j)
