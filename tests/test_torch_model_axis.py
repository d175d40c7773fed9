"""The model axis (tensor parallelism) of the port against the JAX
package:

  (a) four tensor-parallel training runs on 4 gloo CPU ranks against
      the reference's `build_runtime` on forced 4-device meshes, two
      steps in fp32 from the same params and batches: reduced qwen3-32b
      on a (2, 2) mesh with momentum and Adasum RVH (its kv heads split
      over the model axis); reduced gemma-7b at vocab 256 with adam (the
      tied table vocab-parallel, the cross entropy vocab-parallel);
      reduced gemma-7b at vocab 257 with lamb (the table d-split, the
      head a contraction, LAMB's norms summed over the model group); and
      reduced minitron-4b padded for a (1, 4) mesh (6/2 -> 8/4 heads: the
      contraction fallbacks and padded heads in training, nothing to
      combine at dp 1);
  (b) the port's RVH with TP leaf specs on a (2, 2) grid against
      `repro.core.rvh.adasum_rvh_pytree` with `leaf_specs`;
  (c) a checkpoint saved at (2, 2) restored bitwise at (4, 1) and in
      one process, and the reverse;
  (d) `param_specs` and `cache_specs` equal to the reference's at model
      sizes 2, 4 and 16 for every preset, and `pad_heads_for_tp`;
  (e) padded params (`convert_gqa_params`) give the unpadded model's
      logits, and the padded serve engines the JAX engines' tokens on a
      (1, 2) mesh (reduced hymba-1.5b, 5/1 -> 6/2 heads) and a (1, 4)
      mesh (reduced minitron-4b);
  (f) the combinations still refused, each naming ROADMAP item 7, and
      the data-axis regimes a model axis now takes (fsdp, span below
      the data ranks), with the shapes the plan gives each rank.

One JAX subprocess and one gloo launch serve (a)-(c); the reference runs
while the ranks do.

Tolerances, with their reasons (test_torch_sharding.py's):
  * params 1e-5 absolute over two steps at lr 1e-3 for momentum; under
    adam and lamb at most 1% of the elements may differ by more than
    1e-6, none by more than lr a step (adam moves an element by ~lr
    whatever its gradient's size); losses 1e-5 relative; optimizer state
    within 1e-4 of the leaf's largest element. The two packages sum the
    same fp32 products in another order (the model group's all-reduces,
    the vocab-parallel cross entropy, RVH's dots summed over the grid);
  * RVH: 1e-6 of each leaf's largest element;
  * checkpoints: bitwise;
  * padded logits: 1e-5 absolute (the same sums over more, zero,
    heads); engines: tokens equal.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch import tree as T
from repro_torch.bridge import pad_params, params_from_numpy, \
    params_to_numpy, tp_shard
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.configs import pad_heads_for_tp
from repro_torch.data import pipeline as TP
from repro_torch.engine.build import _param_shapes
from repro_torch.launch.mesh import Mesh, make_local_mesh, \
    make_production_mesh
from repro_torch.models import build_model
from repro_torch.parallel import sharding as S

from torch_dist_workers import SRC, launch

SEQ, BATCH, LR, CHUNK, STEPS = 16, 8, 1e-3, 16, 2
STATE_RTOL = 1e-4
PAD4 = dict(n_heads=8, n_kv_heads=4, orig_heads=6)   # minitron at tp 4

CASES = [
    dict(name="qwen3_momentum", arch="qwen3-32b", mesh=(2, 2),
         policy=dict(span=0, backend="rvh", optimizer="momentum")),
    dict(name="gemma_adam_v256", arch="gemma-7b", mesh=(2, 2),
         cfg=dict(vocab_size=256),
         policy=dict(span=0, backend="rvh", optimizer="adam")),
    dict(name="gemma_lamb_v257", arch="gemma-7b", mesh=(2, 2),
         policy=dict(span=0, backend="rvh", optimizer="lamb")),
    dict(name="minitron_padded", arch="minitron-4b", mesh=(1, 4),
         cfg=PAD4, policy=dict(span=0, backend="rvh",
                               optimizer="momentum")),
]
for _c in CASES:
    _c.update(lr=LR, steps=STEPS, attn_chunk=CHUNK)

RVH_SHAPES = {"a": ((64, 96), (None, "model")), "b": ((300,), ()),
              "c": ((40, 16), ("model", None)), "d": ((3, 50), (None, None)),
              "e": ((2, 8, 24), (None, None, "model"))}
RVH_BUCKET = 24 << 10

CKPT = dict(arch="qwen3-32b", attn_chunk=CHUNK, seed=5,
            config=dict(arch="qwen3-32b", reduced=True, optimizer="momentum",
                        lr=LR, backend="rvh", seq_len=SEQ,
                        global_batch=BATCH, async_checkpoint=False))

_REF = r"""
import dataclasses, sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import get_reduced
from repro.core import rvh
from repro.engine import build_runtime
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.parallel.policy import RunPolicy
inputs, out_path, cases, rvh_case = (sys.argv[1], sys.argv[2],
                                     eval(sys.argv[3]), eval(sys.argv[4]))
data = np.load(inputs)
name = lambda p: "/".join(str(getattr(k, "key", k)) for k in p)
flat = lambda t: {name(p): np.asarray(v) for p, v in
                  jax.tree_util.tree_flatten_with_path(t)[0]}
res = {}
for c in cases:
    mesh = make_mesh_compat(c["mesh"], ("data", "model"))
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
mesh = make_mesh_compat((2, 2), ("data", "model"))
shapes, bucket = rvh_case
specs = {k: P(*s) for k, (_, s) in shapes.items()}
tree = {k: jax.device_put(data["rvh/" + k],
                          NamedSharding(mesh, P("data", *specs[k])))
        for k in shapes}
out = jax.jit(lambda t: rvh.adasum_rvh_pytree(
    t, mesh, ("data",), leaf_specs=specs, bucket_bytes=bucket))(tree)
for k in shapes:
    res["rvh_out/" + k] = np.asarray(out[k])
np.savez(out_path, **res)
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
    rng = np.random.default_rng(5)
    for k, (shape, _) in RVH_SHAPES.items():
        out["rvh/" + k] = rng.standard_normal((2,) + shape).astype(
            np.float32)
    np.savez(path, **out)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    inputs = _inputs(tmp / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF, str(tmp / "inputs.npz"),
         str(tmp / "ref.npz"), repr(CASES), repr((RVH_SHAPES, RVH_BUCKET))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    np.savez(tmp / "rvh.npz", **{k: inputs["rvh/" + k] for k in RVH_SHAPES})
    try:
        ranks = launch(4, "tp", {
            "inputs": str(tmp / "inputs.npz"), "cases": CASES,
            "rvh": {"lanes": str(tmp / "rvh.npz"), "bucket": RVH_BUCKET,
                    "specs": {k: list(s) for k, (_, s) in
                              RVH_SHAPES.items()}},
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


# ---------------------------------------------------------- (a) training
@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_tp_run_matches_reference_build_runtime(runs, i):
    ranks, ref, _ = runs
    case, got = CASES[i], ranks[0]["cases"][i]
    name = case["name"]
    adaptive = case["policy"]["optimizer"] in ("adam", "lamb")
    assert (got["dp"], got["model"]) == case["mesh"]
    assert got["path"] == "rvh" and got["sharded"] > 0
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
        _state_close(state[k], ref[f"{name}/inner/{k}"], k)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_tp_ranks_agree_and_hold_their_shards(runs, i):
    """Every leaf is bitwise equal across each data group after every
    step, and each leaf the model axis does not shard across each model
    group; every rank holds the plan's shapes, below the whole leaves."""
    ranks, _, _ = runs
    case = CASES[i]
    full = [tuple(x.shape) for x in T.leaves(_param_shapes(_case_cfg(case)))]
    for r in ranks:
        got = r["cases"][i]
        assert all(got["data_bitwise"]) and all(got["model_bitwise"])
        assert [tuple(s) for s in got["plan_shapes"]] == got["shapes"]
        assert sum(map(np.prod, got["shapes"])) < sum(map(np.prod, full))


# ----------------------------------------------------------------- (b) RVH
def test_rvh_with_tp_leaf_specs_matches_reference(runs):
    """Each rank's result is its model shard of the reference's combined
    leaf; the data groups agree bitwise."""
    ranks, ref, _ = runs
    for rank, r in enumerate(ranks):
        m = rank % 2
        assert r["rvh"]["data_bitwise"]
        for k, (shape, spec) in RVH_SHAPES.items():
            want = ref["rvh_out/" + k]
            d = next((j for j, e in enumerate(spec) if e == "model"), None)
            if d is not None:
                n = shape[d] // 2
                want = np.take(want, range(m * n, (m + 1) * n), axis=d)
            got = r["rvh"]["tree"][k]
            assert got.shape == want.shape, k
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), k


def test_rvh_tp_stats_are_the_whole_leaves(runs):
    """The level-0 CombineStats of the sharded leaves: the replicated
    leaves counted once, the model shards summed — the triple of the
    whole leaves, the same on every rank."""
    ranks, _, inputs = runs
    a = np.concatenate([inputs["rvh/" + k][0].reshape(-1)
                        for k in RVH_SHAPES]).astype(np.float64)
    b = np.concatenate([inputs["rvh/" + k][1].reshape(-1)
                        for k in RVH_SHAPES]).astype(np.float64)
    want = np.array([a @ b, a @ a, b @ b])
    for r in ranks:
        np.testing.assert_allclose(r["rvh"]["levels"], want, rtol=1e-5)
        np.testing.assert_array_equal(r["rvh"]["levels"],
                                      ranks[0]["rvh"]["levels"])


# ---------------------------------------------------------- (c) checkpoints
@pytest.mark.parametrize("tag", ["b_restored", "c_restored"])
def test_tp_checkpoint_restores_at_other_grids(runs, tag):
    """A (2, 2) save, restored at (4, 1) and in one process: bitwise."""
    ck = runs[0][0]["ckpt"]
    assert ck["a_mesh"] == (2, 2)
    saved, got = T.leaves(ck["a_saved"]), T.leaves(ck[tag])
    assert len(saved) == len(got)
    assert all(np.array_equal(x, y) for x, y in zip(saved, got))


@pytest.mark.parametrize("tag", ["b", "c"])
def test_tp_restores_other_grids_checkpoints(runs, tag):
    """A (4, 1) save and a one-process save, restored at (2, 2): bitwise."""
    ck = runs[0][0]["ckpt"]
    saved, got = T.leaves(ck[tag + "_saved"]), T.leaves(ck[tag + "_back"])
    assert len(saved) == len(got)
    assert all(np.array_equal(x, y) for x, y in zip(saved, got))


# ---------------------------------------------------- (d) specs, padding
def _ref_tree_specs(tree):
    pairs = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in pairs}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_axis_specs_match_reference(arch):
    """`param_specs` (TP only, as the port trains), `tp.model_specs` and
    `cache_specs` equal the reference's leaf for leaf at model sizes 2, 4
    and 16, on full-width shapes."""
    from repro.configs.base import get_config as jget
    from repro.models import build_model as jbuild
    from repro.parallel import sharding as JS
    from repro_torch.parallel.tp import model_specs
    cfg, jcfg = get_config(arch), jget(arch)
    jm = jbuild(jcfg)
    pshapes = jax.eval_shape(jm.init, jax.random.key(0))
    shapes = _param_shapes(cfg)
    names = [T.keystr(p) for p, _ in T.flatten_with_path(shapes)[0]]
    if cfg.is_encoder_decoder:     # its cache holds the encoder's K/V
        enc = jax.ShapeDtypeStruct((4, 16, cfg.d_model), jnp.float32)
        cshapes = jax.tree.leaves(jax.eval_shape(
            lambda p, e: jm.init_cache(p, 4, 64, enc_out=e), pshapes, enc))
    else:
        cshapes = jax.tree.leaves(jax.eval_shape(
            lambda: jm.init_cache(None, 4, 64)))
    for tp in (2, 4, 16):
        pol = S.ShardingPolicy(tp_size=tp)
        want = _ref_tree_specs(JS.param_specs(
            jcfg, pshapes, JS.ShardingPolicy(tp_size=tp)))
        got = S.spec_leaves(model_specs(cfg, shapes, tp))
        assert [want[n] for n in names] == got
        for dp in (1, 2):
            jspecs = JS.cache_specs(cshapes, jcfg, JS.ShardingPolicy(
                tp_size=tp), ("data",), 4, dp)
            assert S.cache_specs(cshapes, cfg, pol, ("data",), 4, dp) \
                == [tuple(s) for s in jspecs]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pad_heads_for_tp_matches_reference(arch):
    from repro.configs.base import get_config as jget
    from repro.configs.base import pad_heads_for_tp as jpad
    for tp in (1, 2, 4, 16):
        want = dataclasses.asdict(jpad(jget(arch), tp))
        assert dataclasses.asdict(pad_heads_for_tp(get_config(arch), tp)) \
            == want


def test_port_cache_leaves_are_the_reference_s():
    """The port's decode caches have the reference's leaves, in its
    order, so `cache_specs` gives the reference's specs on them."""
    from repro.configs.base import get_reduced as jred
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT
    for arch in ARCH_IDS:
        cfg = get_reduced(arch)
        if cfg.is_encoder_decoder:
            continue
        want = [tuple(x.shape) for x in jax.tree.leaves(jax.eval_shape(
            lambda: JT.init_decode_cache(jred(arch), 4, 32)))]
        got = [tuple(x.shape) for x in T.leaves(TT.init_decode_cache(
            cfg, 4, 32, torch.float32, torch.device("meta"), False, None))]
        assert got == want, arch


def test_meshes():
    """Rank r = d·M + m (the model index innermost); the groups; the
    fallback to (n, 1) and the production sizes."""
    m = Mesh(("data", "model"), (2, 4))
    assert [m.coords(r) for r in (0, 5)] == [{"data": 0, "model": 0},
                                            {"data": 1, "model": 1}]
    assert m.groups("model") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert m.groups("data") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert make_local_mesh(2, 2, 4).shape == (2, 2)
    assert make_local_mesh(2, 2, 1).shape == (1, 1)
    assert make_local_mesh(4, 2, 4).shape == (4, 1)
    assert make_production_mesh().sizes == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == (2, 16, 16)


# ------------------------------------------------------- (e) padded models
def test_convert_gqa_params_matches_reference_and_is_exact():
    """The port's conversion equals the reference's on the same weights,
    and the padded model's logits are the unpadded model's (1e-5)."""
    from repro.configs.base import get_reduced as jred
    from repro.models import attention as JA
    from repro_torch.models import attention as TA
    cfg = get_reduced("minitron-4b")
    pcfg = pad_heads_for_tp(cfg, 4)
    assert (pcfg.n_heads, pcfg.n_kv_heads, pcfg.orig_heads) == (8, 4, 6)
    model = build_model(cfg, compute_dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    layer = {k: v[0] for k, v in params["blocks"]["attn"].items()}
    want = JA.convert_gqa_params(
        jax.tree.map(lambda x: jnp.asarray(x.numpy()), layer), jred(
            "minitron-4b"), dataclasses.replace(jred("minitron-4b"),
                                                **PAD4))
    got = TA.convert_gqa_params(layer, cfg, pcfg)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    padded = pad_params(params, cfg, pcfg)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 12)))
    np.testing.assert_allclose(
        build_model(pcfg, compute_dtype=torch.float32).forward(
            padded, tokens).numpy(),
        model.forward(params, tokens).numpy(), atol=1e-5)
    # the ranks' shards of the padded params put back are the params:
    # at tp 4 the q heads split 2 a rank, wo's rows with them
    shards = [tp_shard(padded, pcfg, 4, m) for m in range(4)]
    attn = [s["blocks"]["attn"] for s in shards]
    assert attn[0]["wq"].shape[-1] == 2 * pcfg.resolved_head_dim
    assert torch.equal(torch.cat([a["wq"] for a in attn], -1),
                       padded["blocks"]["attn"]["wq"])
    assert torch.equal(torch.cat([a["wo"] for a in attn], 1),
                       padded["blocks"]["attn"]["wo"])


def test_padded_init_zeroes_padded_wo_rows():
    pcfg = pad_heads_for_tp(get_reduced("minitron-4b"), 4)
    p = build_model(pcfg).init(torch.Generator().manual_seed(0),
                               device="cpu")
    wo = p["blocks"]["attn"]["wo"]
    dh = pcfg.resolved_head_dim
    assert not wo[:, 6 * dh:].any() and wo[:, :6 * dh].abs().sum() > 0


SERVE = [("hymba-1.5b", 2, (6, 2)), ("minitron-4b", 4, (8, 4))]


@pytest.mark.parametrize("arch,tp,heads", SERVE,
                         ids=[a for a, _, _ in SERVE])
def test_padded_serve_engine_matches_reference(arch, tp, heads):
    """On a (1, tp) mesh the engines pad heads for the model axis: the
    port's, from its config and mesh, pads as the reference's does, and
    with the same (padded, JAX-initialised) weights both give the same
    greedy tokens and stats."""
    from repro.configs.base import get_reduced as jred
    from repro.configs.base import pad_heads_for_tp as jpad
    from repro.engine import EngineConfig as JEC
    from repro.engine import GenerationRequest as JReq
    from repro.engine import ServeEngine as JEngine
    from repro.models import build_model as jbuild
    from repro_torch.engine import (EngineConfig, GenerationRequest,
                                    ServeEngine)
    from repro_torch.engine.serving.engine import resolve_serve_parts
    jcfg = jpad(jred(arch), tp)
    assert (jcfg.n_heads, jcfg.n_kv_heads) == heads
    conf = dict(arch=arch, reduced=True, max_slots=2, max_len=48,
                model_mesh=tp, pad_heads=True)
    mesh = Mesh(("data", "model"), (1, tp))
    tm, _, _, _ = resolve_serve_parts(EngineConfig(**conf), mesh=mesh,
                                      params={}, device="cpu")
    assert tm.cfg == pad_heads_for_tp(get_reduced(arch), tp)
    jm = jbuild(jcfg, compute_dtype=jnp.float32, attn_chunk=16)
    jp = jm.init(jax.random.key(0))
    tp_params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tmodel = build_model(tm.cfg, compute_dtype=torch.float32)
    rng = np.random.RandomState(3)
    reqs = [dict(prompt=rng.randint(0, jcfg.vocab_size, n),
                 max_new_tokens=g) for n, g in [(9, 6), (5, 8), (12, 4)]]
    je = JEngine(JEC(**conf), jm, None, jp)
    te = ServeEngine.from_config(EngineConfig(**conf), model=tmodel,
                                 params=tp_params, device="cpu", mesh=mesh)
    got = []
    for eng, Req in ((je, JReq), (te, GenerationRequest)):
        hs = []
        for r in reqs:
            hs.append(eng.submit(Req(**r)))
            eng.step()
        eng.drain()
        got.append(([h.tokens for h in hs], eng.stats["generated_tokens"]))
    assert got[0] == got[1]
    assert sum(len(t) for t in got[1][0]) == 18


# ------------------------------------------------------ (f) still refused
REFUSED = [
    ("rwkv6-7b", {}), ("hymba-1.5b", {}), ("seamless-m4t-large-v2", {}),
    ("qwen3-32b", {"combine_delay": 1}),
    ("qwen3-32b", {"local_steps": 2}),
]


@pytest.mark.parametrize("arch,over", REFUSED,
                         ids=[f"{a}-{'+'.join(o) or 'family'}"
                              for a, o in REFUSED])
def test_model_axis_refusals_name_item_7(arch, over):
    """The model axis on the SSM, the hybrid or the encoder-decoder, or
    with a regime the port does not reach there, raises naming ROADMAP
    item 7 (checked before any collective)."""
    from types import SimpleNamespace
    from repro_torch.engine.build import _check_regime
    from repro_torch.engine.registry import registry_key
    from repro_torch.parallel.policy import RunPolicy
    model = SimpleNamespace(cfg=get_reduced(arch))
    pol = RunPolicy(**dict(dict(backend="rvh", optimizer="momentum"),
                           **over))
    with pytest.raises(NotImplementedError, match=r"item 7\b"):
        _check_regime(model, pol, registry_key("adasum", pol.backend), 4,
                      4, 2)


# name, arch, span, policy fields: data-axis regimes, now under a model
# axis of 2 (a (4, 2) grid): fsdp at span == dp (pre-point ZeRO-1
# under FSDP), and span below dp with the preset's fsdp + scatter_grads;
# the families the model axis first refused (the MoE decoders, MLA, the
# vision frontend), alone on the model axis and with fsdp; and the
# combiners it first refused, adasum-linear and adascale, under fsdp
ACCEPTED = [("fsdp", "qwen3-32b", 4, {"fsdp": True}),
            ("span", "qwen3-32b", 1, {"fsdp": True, "scatter_grads": True}),
            ("mixtral", "mixtral-8x22b", 4, {}),
            ("minicpm3", "minicpm3-4b", 4, {}),
            ("llava", "llava-next-34b", 4, {}),
            ("mixtral-fsdp", "mixtral-8x22b", 4, {"fsdp": True}),
            ("linear", "qwen3-32b", 2, {"fsdp": True, "scatter_grads": True,
                                        "backend": "linear"}),
            ("adascale", "qwen3-32b", 4, {"fsdp": True,
                                          "combine_op": "adascale"})]


@pytest.mark.parametrize("name,arch,span,over", ACCEPTED,
                         ids=[a for a, _, _, _ in ACCEPTED])
def test_model_axis_accepts_data_axis_regimes(name, arch, span, over):
    """The model axis's check passes, and the data axis's
    (`_plan_sharding`) shards; and on stand-in comms of a (4, 2) grid
    the plan (fsdp on) cuts every leaf over both axes: params, state and
    gradients are the reference's `local_shape` over {data, model}
    (params; the pre point's state: 1/4 of each data-sharded dim of the
    model shard; gradients: the lane group's part)."""
    from types import SimpleNamespace
    from repro_torch.engine.build import _check_regime, _plan_sharding
    from repro_torch.engine.registry import registry_key
    from repro_torch.parallel.policy import RunPolicy
    from repro_torch.parallel.zero import RankPlan
    from repro.configs.base import get_reduced as jred
    from repro.models import build_model as jbuild
    from repro.parallel import sharding as JS
    cfg = get_reduced(arch)
    pol = RunPolicy(**dict(dict(backend="gspmd_tree", optimizer="momentum",
                                span=span), **over))
    key = registry_key(pol.combine_op, pol.backend)
    _check_regime(SimpleNamespace(cfg=cfg), pol, key, span, 4, 2)
    assert _plan_sharding(pol, "pre", span, 4, True, True)
    shapes = _param_shapes(cfg)
    both = S.spec_leaves(S.param_specs(cfg, shapes, S.ShardingPolicy(
        fsdp_axis="data", tp_size=2, fsdp_size=4)))
    full = [tuple(x.shape) for x in T.leaves(shapes)]
    # the specs over both axes are the reference's
    jshapes = jax.eval_shape(jbuild(jred(arch)).init, jax.random.key(0))
    want = _ref_tree_specs(JS.param_specs(jred(arch), jshapes,
                                          JS.ShardingPolicy(
                                              fsdp_axis="data", tp_size=2,
                                              fsdp_size=4)))
    names = [T.keystr(p) for p, _ in T.flatten_with_path(shapes)[0]]
    assert [want[n] for n in names] == both
    g = 4 // span
    stand = lambda n, r: SimpleNamespace(world=n, rank=r)
    for d in range(4):
        for m in range(2):
            plan = RankPlan(cfg, shapes, stand(4, d), span, fsdp=True,
                            scatter_grads=pol.scatter_grads, post=False,
                            shard=True, model_comm=stand(2, m))
            sizes = {"data": 4, "model": 2}
            want = [S.local_shape(s, sp, sizes) for s, sp in zip(full, both)]
            assert plan.local_shapes("params") == want
            assert plan.local_shapes("state") == want
            grads = [S.local_shape(s, S.rename(sp, {"data": None}),
                                   {"model": 2}) for s, sp in zip(full, both)]
            grads = [tuple(n // g if i == plan.dims[j] else n
                           for i, n in enumerate(sh))
                     for j, sh in enumerate(grads)]
            assert plan.local_shapes("grads") == grads
            assert any(d is not None for d in plan.dims)
            assert any(d is not None for d in plan.mdims)
            assert any(a is not None and b is not None
                       for a, b in zip(plan.dims, plan.mdims))


@pytest.mark.parametrize("driver", ["fit_elastic", "fit_adaptive"])
def test_model_axis_drivers_refused(driver, tmp_path):
    from repro_torch.control import fit_adaptive
    from repro_torch.engine import EngineConfig, fit_elastic
    fn = {"fit_elastic": fit_elastic, "fit_adaptive": fit_adaptive}[driver]
    cfg = EngineConfig(arch="gemma-7b", reduced=True, model_mesh=2,
                       ckpt_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match=r"item 7\b"):
        fn(cfg, device="cpu")


def test_grid_short_of_the_ranks_refused():
    from repro_torch.engine import EngineConfig
    assert EngineConfig(model_mesh=2).rank_mesh(4).shape == (2, 2)
    assert EngineConfig(model_mesh=2).rank_mesh(1).shape == (1, 1)
    assert EngineConfig(data_mesh=2, model_mesh=2).rank_mesh(2).shape == \
        (2, 1)
    with pytest.raises(NotImplementedError, match=r"item 7\b"):
        EngineConfig(data_mesh=2).rank_mesh(4)
