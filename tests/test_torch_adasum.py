"""The port's Adasum combine against the JAX package: the Adasum math
(`core/adasum`), fusion layouts and leaf order (`core/fusion`, `tree`),
the plain versions of the two block kernels against the Pallas kernels
(interpret mode) and `kernels/ref.py`, and the fused bucketed combine
(`core/combine`) over the case matrix of `tests/test_combine_fused.py`,
CombineStats included. Inputs come from numpy seeds and cross as numpy.

Tolerances, with their reasons:
  * fp32 combine outputs: rtol = atol = 1e-5 — the dots are summed in
    another order (torch's blocked sums vs XLA's), which moves the
    Adasum scalars by ~1e-7 relative;
  * fp32 dot triples and CombineStats: rtol 2e-5 (the same reordering,
    over sums of up to ~1e4 products);
  * bf16 buffers: the oracle rule (`use_pallas=False`) computes in bf16
    on both sides and agrees exactly; the kernel rule (fp32 math, one
    cast) turns the ~1e-7 scalar difference into at most one bf16 ulp
    (2^-7 relative, rtol 8e-3); stats of levels fed by those bf16 rows
    rtol 1e-4;
  * layouts, buckets, block choices and segment ids: exact (host ints).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_config as jax_config
from repro.configs.base import get_reduced as jax_reduced
from repro.core import adasum as JA
from repro.core import combine as JC
from repro.core import fusion as JF
from repro.engine import registry as JR
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels.adasum_combine import block_combine as jax_block_combine
from repro.kernels.adasum_dots import auto_block_elems as jax_auto_block
from repro.kernels.adasum_dots import block_dots as jax_block_dots
from repro.models import build_model as jax_build
from repro_torch import tree as T
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import adasum as TA
from repro_torch.core import combine as TC
from repro_torch.core import fusion as TF
from repro_torch.engine import registry as TR
from repro_torch.kernels import adasum as K
from repro_torch.kernels import build as KB
from repro_torch.models.transformer import param_spec

DENSE = ("gemma-7b", "minitron-4b", "qwen3-32b")
RAGGED = [3, 700, 1025, 8192, 64, 2, 5000, 300, 12_000, 9]
TOL = dict(rtol=1e-5, atol=1e-5)


def rnd(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def both(a, dtype="float32"):
    """numpy fp32 -> (jnp, torch) of `dtype` (bf16 rounds alike)."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(np.array(a)).to(getattr(torch, dtype)))


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, **kw):
    np.testing.assert_allclose(to_np(got), to_np(want), **(kw or TOL))


# ----------------------------------------------------------- Adasum math
PAIRS = {
    "orthogonal": (np.array([1.0, 0, 0], np.float32),
                   np.array([0, 2.0, 0], np.float32)),
    "parallel_equal": (rnd(32, 1), rnd(32, 1)),
    "parallel_scaled": (rnd(16, 2), 3 * rnd(16, 2)),
    "random": (rnd(64, 3), rnd(64, 4)),
    "zero_lane": (np.zeros(16, np.float32), rnd(16, 5)),
    "both_zero": (np.zeros(8, np.float32), np.zeros(8, np.float32)),
}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_adasum_pair_matches_reference(case):
    g1, g2 = PAIRS[case]
    (j1, t1), (j2, t2) = both(g1), both(g2)
    out = TA.adasum_pair(t1, t2)
    close(out, JA.adasum_pair(j1, j2))
    if case == "orthogonal":
        close(out, g1 + g2)
    elif case == "parallel_equal":
        close(out, g1)
    elif case == "parallel_scaled":                 # (1-3/2)g + (1-1/6)3g
        close(out, 2 * g1, rtol=1e-4, atol=1e-5)
    elif case == "zero_lane":                       # the EPS plain-sum limit
        close(out, g2)
    elif case == "both_zero":
        assert torch.equal(out, torch.zeros(8))


def test_adasum_scalars_zero_limit():
    z = torch.zeros(3)
    s1, s2 = TA.adasum_segment_scalars(torch.zeros(4, 3))
    assert torch.equal(s1, torch.ones(4)) and torch.equal(s2, torch.ones(4))
    assert TA.EPS == JA.EPS
    s1, s2 = TA.adasum_scalars(z, z, z)
    assert torch.equal(s1, torch.ones(3))


def _lanes(n, seed=0):
    return [{"a": rnd(8, seed + i), "b": rnd((4, 3), 10 + seed + i)}
            for i in range(n)]


@pytest.mark.parametrize("per_layer", [True, False])
@pytest.mark.parametrize("order", ["tree", "linear", "stacked_tree"])
def test_reduce_orders_match_reference(order, per_layer):
    lanes = _lanes(8)
    jl = [{k: jnp.asarray(v) for k, v in g.items()} for g in lanes]
    tl = [{k: torch.from_numpy(v) for k, v in g.items()} for g in lanes]
    if order == "tree":
        want = JA.adasum_tree_reduce(jl, per_layer=per_layer)
        got = TA.adasum_tree_reduce(tl, per_layer=per_layer)
    elif order == "linear":
        want = JA.adasum_linear_reduce(jl, per_layer=per_layer)
        got = TA.adasum_linear_reduce(tl, per_layer=per_layer)
    else:
        want = JA.adasum_tree_reduce(
            {k: jnp.stack([g[k] for g in jl]) for k in "ab"},
            per_layer=per_layer)
        got = TA.adasum_tree_reduce(
            {k: torch.stack([g[k] for g in tl]) for k in "ab"},
            per_layer=per_layer)
    for k in "ab":
        close(got[k], want[k])


def test_tree_differs_from_linear_and_rejects_non_pow2():
    tl = [{"w": torch.from_numpy(rnd(16, i))} for i in range(4)]
    t = TA.adasum_tree_reduce(tl)["w"]
    l = TA.adasum_linear_reduce(tl)["w"]
    assert not torch.allclose(t, l)
    with pytest.raises(ValueError, match="power-of-two"):
        TA.adasum_tree_reduce(tl[:3])


@pytest.mark.parametrize("mean", [False, True])
def test_sum_reduce_matches_reference(mean):
    lanes = _lanes(4, seed=3)
    stacked = {k: np.stack([g[k] for g in lanes]) for k in "ab"}
    want = JA.sum_reduce({k: jnp.asarray(v) for k, v in stacked.items()},
                         mean=mean)
    got = TA.sum_reduce({k: torch.from_numpy(v) for k, v in stacked.items()},
                        mean=mean)
    got_list = TA.sum_reduce([{k: torch.from_numpy(v) for k, v in g.items()}
                              for g in lanes], mean=mean)
    for k in "ab":
        close(got[k], want[k])
        close(got_list[k], want[k])


# ------------------------------------------------- leaf order and layouts
def _jax_shapes(arch, reduced):
    cfg = (jax_reduced if reduced else jax_config)(arch)
    return jax.eval_shape(jax_build(cfg).init, jax.random.key(0))


def _port_specs(arch, reduced, lead=(), cfg=None):
    cfg = cfg or (get_reduced if reduced else get_config)(arch)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return TF.Spec(tuple(lead) + tuple(node[0]), torch.float32)
    return walk(param_spec(cfg))


def _port_paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _port_paths(tree[k], prefix + (k,))
        return out
    return [prefix]


@pytest.mark.parametrize("arch", DENSE)
def test_leaf_order_pinned_to_jax(arch):
    jshapes = _jax_shapes(arch, reduced=False)
    jpaths = [tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]]
    tspecs = _port_specs(arch, reduced=False)
    leaves = T.leaves(tspecs)
    assert _port_paths(tspecs) == jpaths
    assert [tuple(l.shape) for l in leaves] == \
        [tuple(l.shape) for l in jax.tree.leaves(jshapes)]
    if arch == "gemma-7b":
        assert [".".join(p) for p in jpaths] == [
            "blocks.attn.wk", "blocks.attn.wo", "blocks.attn.wq",
            "blocks.attn.wv", "blocks.mlp.w_down", "blocks.mlp.w_gate",
            "blocks.mlp.w_up", "blocks.norm1.scale", "blocks.norm2.scale",
            "embed.table", "final_norm.scale"]


def test_tree_helper_round_trip_and_none():
    tree = {"b": (torch.ones(1), None, [torch.zeros(2)]), "a": torch.ones(3)}
    leaves, td = T.flatten(tree)
    assert [tuple(x.shape) for x in leaves] == [(3,), (1,), (2,)]
    back = T.unflatten(td, leaves)
    assert back["b"][1] is None and isinstance(back["b"][2], list)
    with pytest.raises(ValueError):
        T.map(lambda x, y: x, tree, {"a": torch.ones(3)})


def _assert_layout_equal(tl, jl, full_ids: bool):
    assert tl.shapes == jl.shapes and tl.offsets == jl.offsets
    assert tl.sizes == jl.sizes and tl.padded_len == jl.padded_len
    assert tl.num_segments == jl.num_segments
    assert [TC._dtype_name(d) for d in tl.dtypes] == \
        [jnp.dtype(d).name for d in jl.dtypes]
    if full_ids:
        np.testing.assert_array_equal(tl.segment_ids(), jl.segment_ids())


@pytest.mark.parametrize("threshold", [64, 1])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", DENSE)
def test_fused_plan_equals_reference(arch, reduced, use_pallas, threshold):
    span = 4
    jshapes = _jax_shapes(arch, reduced)
    jleaves = [jax.ShapeDtypeStruct((span,) + l.shape, l.dtype)
               for l in jax.tree.leaves(jshapes)]
    tleaves = T.leaves(_port_specs(arch, reduced, lead=(span,)))
    jcfg = JC.CombineConfig(use_pallas=use_pallas,
                            fusion_threshold_mb=threshold)
    tcfg = TC.CombineConfig(use_pallas=use_pallas,
                            fusion_threshold_mb=threshold)
    jplan = JC.fused_plan(jleaves, [JC.P()] * len(jleaves), jcfg, False)
    tplan = TC.fused_plan(tleaves, tcfg)
    assert len(tplan) == len(jplan)
    for (ti, tl, tb, ta), (ji, jl, jb, ja) in zip(tplan, jplan):
        assert ti == ji and tb == jb and ta == tuple(ja)
        _assert_layout_equal(tl, jl, full_ids=reduced)
        if reduced:
            np.testing.assert_array_equal(TC._block_segments(tl, tb),
                                          jl.segment_ids()[::jb])
    assert TC.plan_summary(tplan) == JC.plan_summary(jplan)


def test_smoke_plan_gemma_two_layers():
    """A plan of the kind `chip_smoke.py` drives (its train phase takes
    gemma-7b at full width, one layer): gemma-7b at full width, 2 layers,
    64 MB buckets — 11 leaves in 10 buckets, blocks {1024, 2048, 8192}."""
    cfg = dataclasses.replace(get_config("gemma-7b"), n_layers=2)
    leaves = T.leaves(_port_specs("gemma-7b", False, lead=(4,), cfg=cfg))
    plan = TC.fused_plan(leaves, TC.CombineConfig())
    assert sum(len(i) for i, *_ in plan) == 11 and len(plan) == 10
    assert {b for _, _, b, _ in plan} == {1024, 2048, 8192}


@pytest.mark.parametrize("leaf_align", [1, 256, 1024])
def test_make_layout_pack_unpack_match_reference(leaf_align):
    sizes = [5, 300, 1025]
    tree = {f"l{i}": rnd((s,), i) for i, s in enumerate(sizes)}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    jl = JF.make_layout(jt, leaf_align=leaf_align, align=2)
    tl = TF.make_layout(tt, leaf_align=leaf_align, align=2)
    _assert_layout_equal(tl, jl, full_ids=True)
    assert TF.layout_bytes(tl) == JF.layout_bytes(jl)
    assert TF.bucketize(tl, 2000) == JF.bucketize(jl, 2000)
    buf = TF.pack(tt, tl)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(JF.pack(jt, jl)))
    back = TF.unpack(buf, tl)
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), tree[k])
    stacked = [torch.from_numpy(np.stack([tree[k], 2 * tree[k]]))
               for k in sorted(tree)]
    np.testing.assert_array_equal(
        TF.pack_stacked(stacked, tl).numpy(),
        np.asarray(JF.pack_stacked([jnp.asarray(s.numpy()) for s in stacked],
                                   jl)))


@pytest.mark.parametrize("sizes,budget", [
    ([10, 2000, 5, 8000, 8000, 1], 8000), ([7, 9, 31], 10),
    ([65536, 16384], 1 << 20), ([100] * 50, 1000)])
def test_bucketize_and_block_choice_match_reference(sizes, budget):
    assert TF.bucketize_sizes(sizes, budget) == JF.bucketize_sizes(sizes,
                                                                   budget)
    for unit in (256, 1024):
        assert TF.select_block_elems(sizes, unit=unit) == \
            JF.select_block_elems(sizes, unit=unit)


@pytest.mark.parametrize("n", [1024, 3 * 1024, 5 * 1024, 8192, 1 << 20,
                               1000, 0])
def test_auto_block_elems_matches_reference(n):
    if n % 1024 or n == 0:
        with pytest.raises(ValueError, match="multiple"):
            K.auto_block_elems(n)
        return
    assert K.auto_block_elems(n) == jax_auto_block(n)


# ----------------------------------------------------- block kernel arms
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [1024, 2048, 8192])
def test_block_dots_plain_matches_pallas_and_ref(block, dtype):
    n = 4 * 8192
    (ja, ta), (jb, tb) = both(rnd(n, 1), dtype), both(rnd(n, 2), dtype)
    got = K.block_dots(ta, tb, block_elems=block)
    assert got.dtype == torch.float32 and got.shape == (n // block, 3)
    close(got, jax_block_dots(ja, jb, block_elems=block, interpret=True),
          rtol=2e-5, atol=1e-3)
    close(got, JREF.block_dots_ref(ja, jb, block), rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("fp32_math", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_combine_plain_matches_pallas_and_ref(dtype, fp32_math):
    n, block = 4 * 2048, 2048
    (ja, ta), (jb, tb) = both(rnd(n, 3), dtype), both(rnd(n, 4), dtype)
    (js1, ts1), (js2, ts2) = both(rnd(4, 5)), both(rnd(4, 6))
    got = K.block_combine(ta, tb, ts1, ts2, block_elems=block,
                          fp32_math=fp32_math)
    assert got.dtype == ta.dtype and got.shape == (n,)
    if fp32_math:     # the TPU kernel's rule: fp32 math, one cast
        want = jax_block_combine(ja, jb, js1, js2, block_elems=block,
                                 interpret=True)
    else:             # the oracle's rule: buffer-dtype math
        want = JREF.combine_ref(ja, jb, js1, js2, block)
    if dtype == "float32":
        close(got, want)
    elif fp32_math:   # XLA may contract s1*a + s2*b into an FMA, torch
        # rounds the product first: a tie can land one bf16 ulp apart
        close(got, want, rtol=2 ** -7, atol=0)
    else:
        np.testing.assert_array_equal(to_np(got), to_np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_row_operands_equal_flat_operands(dtype):
    """[p, L] strided pair views (a tree level's in-place read) give what
    the reference's gathered flat halves give."""
    p, L, block = 3, 4096, 1024
    _, buf = both(rnd((2 * p, L), 7), dtype)
    y = buf.view(p, 2, L)
    a, b = y[:, 0], y[:, 1]
    fa, fb = a.reshape(-1).contiguous(), b.reshape(-1).contiguous()
    assert torch.equal(K.block_dots(a, b, block_elems=block),
                       K.block_dots(fa, fb, block_elems=block))
    s1, s2 = torch.rand(p * L // block), torch.rand(p * L // block)
    out = K.block_combine(a, b, s1, s2, block_elems=block)
    assert out.shape == (p, L) and out.is_contiguous()
    assert torch.equal(out.reshape(-1),
                       K.block_combine(fa, fb, s1, s2, block_elems=block))


def test_segment_wrappers_match_reference_ops():
    sizes = [100, 3000, 2048, 7]
    tree = {f"l{i}": rnd((s,), 10 + i) for i, s in enumerate(sizes)}
    other = {k: rnd(v.shape, 20 + i) for i, (k, v) in enumerate(tree.items())}
    jl = JF.make_layout({k: jnp.asarray(v) for k, v in tree.items()},
                        leaf_align=1024)
    tl = TF.make_layout({k: torch.from_numpy(v) for k, v in tree.items()},
                        leaf_align=1024)
    ja, ta = both(np.asarray(JF.pack({k: jnp.asarray(v) for k, v in
                                      tree.items()}, jl)))
    jb, tb = both(np.asarray(JF.pack({k: jnp.asarray(v) for k, v in
                                      other.items()}, jl)))
    seg_np = tl.segment_ids()
    jseg, tseg = jnp.asarray(seg_np), torch.from_numpy(seg_np)
    nseg = tl.num_segments + 1
    got = K.adasum_segment_dots(ta, tb, tseg, nseg, block_elems=1024)
    close(got, JOPS.adasum_segment_dots(ja, jb, jseg, nseg,
                                        block_elems=1024), rtol=2e-5,
          atol=1e-4)
    close(got, K.segment_dots_ref(ta, tb, tseg, nseg), rtol=2e-5, atol=1e-4)
    close(K.block_segment_dots_ref(ta, tb, tseg[::1024], nseg, 1024),
          JREF.block_segment_dots_ref(ja, jb, jseg[::1024], nseg, 1024),
          rtol=2e-5, atol=1e-4)
    (js1, ts1), (js2, ts2) = both(rnd(nseg, 1)), both(rnd(nseg, 2))
    close(K.adasum_combine(ta, tb, ts1, ts2, tseg, block_elems=1024),
          JOPS.adasum_combine(ja, jb, js1, js2, jseg, block_elems=1024))


def test_segment_sum_is_index_add():
    """Sorted ids, reversed ones and a chunk-major bucket's (every layer
    once a chunk, as core/rvh.py's ShardLayout lays them) all sum as
    index_add does."""
    rng = np.random.default_rng(0)
    seg = np.sort(rng.integers(0, 6, 40))
    x = torch.from_numpy(rng.standard_normal((2, 40, 3)).astype(np.float32))
    for ids in (seg, seg[::-1].copy(), np.tile(np.arange(5), 8)):
        got = K.SegmentSum(ids, 7, "cpu")(x)
        for r in range(2):
            want = torch.zeros(7, 3).index_add_(0, torch.from_numpy(ids),
                                                x[r])
            close(got[r], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", ["not_multiple", "granule", "dtype_mix",
                                 "float16", "shape", "stride", "scalars"])
def test_wrappers_reject(bad):
    a, b = torch.zeros(4096), torch.zeros(4096)
    s = torch.ones(4)
    kw = {"block_elems": 1024}
    if bad == "not_multiple":
        a, b = torch.zeros(4000), torch.zeros(4000)
    elif bad == "granule":
        kw["block_elems"] = 1000
    elif bad == "dtype_mix":
        b = b.to(torch.bfloat16)
    elif bad == "float16":
        a, b = a.half(), b.half()
    elif bad == "shape":
        b = torch.zeros(2048)
    elif bad == "stride":
        a, b = torch.zeros(4096, 2)[:, 0], torch.zeros(4096, 2)[:, 0]
    else:
        s = torch.ones(3)
    with pytest.raises(ValueError):
        if bad == "scalars":
            K.block_combine(a, b, s, s, **kw)
        else:
            K.block_dots(a, b, **kw)


def test_cpu_arm_counts_no_launch():
    KB.reset_launches()
    a = torch.ones(2048)
    K.block_dots(a, a, block_elems=1024)
    K.block_combine(a, a, torch.ones(2), torch.ones(2), block_elems=1024)
    assert KB.LAUNCHES["block_dots"] == 0 == KB.LAUNCHES["block_combine"]


@pytest.mark.parametrize("fp32_math", [False, True])
def test_plain_flag_takes_the_named_plain_arm(fp32_math):
    """plain=True runs the plain versions (on any device; here the CPU),
    with the combine rule `fp32_math` names, on [p, L] pair rows."""
    p, L, block = 2, 2048, 1024
    buf = torch.from_numpy(rnd((2 * p, L), 9)).to(torch.bfloat16)
    y = buf.view(p, 2, L)
    a, b = y[:, 0], y[:, 1]
    s1, s2 = torch.rand(p * L // block), torch.rand(p * L // block)
    KB.reset_launches()
    dots = K.block_dots(a, b, block_elems=block, plain=True)
    out = K.block_combine(a, b, s1, s2, block_elems=block, plain=True,
                          fp32_math=fp32_math)
    assert KB.LAUNCHES["block_dots"] == 0 == KB.LAUNCHES["block_combine"]
    ref = K.combine_fp32_ref if fp32_math else K.combine_ref
    for r in range(p):
        rows = slice(r * L // block, (r + 1) * L // block)
        assert torch.equal(dots[rows], K.block_dots_ref(a[r], b[r], block))
        assert torch.equal(out[r], ref(a[r], b[r], s1[rows], s2[rows],
                                       block))


# ---------------------------------------------------------- fused combine
def ragged_tree(span, sizes=RAGGED, dtype="float32", seed=0):
    rng = np.random.default_rng(seed + span)
    host = {f"l{i}": rng.standard_normal((span, s)).astype(np.float32)
            for i, s in enumerate(sizes)}
    return ({k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in host.items()},
            {k: torch.from_numpy(v).to(getattr(torch, dtype))
             for k, v in host.items()})


def _fused_pair(jt, tt, stats_tol, **cfg):
    jo, js = jax.jit(JC.build_fused_combiner(JC.CombineConfig(**cfg),
                                             with_stats=True))(jt)
    to, ts = TC.build_fused_combiner(TC.CombineConfig(**cfg),
                                     with_stats=True)(tt)
    close(ts["levels"], js["levels"], rtol=stats_tol, atol=1e-6)
    return jo, to


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("per_layer", [True, False])
@pytest.mark.parametrize("span", [2, 4, 8])
def test_fused_matches_reference_fp32(span, per_layer, use_pallas):
    jt, tt = ragged_tree(span)
    jo, to = _fused_pair(jt, tt, 2e-5, per_layer=per_layer,
                         use_pallas=use_pallas)
    ref_fn = TC.tree_combine_per_layer if per_layer else TC.tree_combine_whole
    ref = ref_fn(tt, torch.float32)
    for k in tt:
        close(to[k], jo[k])
        close(to[k], ref[k])               # fused == per-leaf in the port


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("span", [2, 4])
def test_fused_matches_reference_bf16_lanes(span, use_pallas):
    jt, tt = ragged_tree(span, dtype="bfloat16")
    jo, to = _fused_pair(jt, tt, 1e-4, use_pallas=use_pallas)
    for k in tt:
        assert to[k].dtype == torch.bfloat16
        if use_pallas:
            close(to[k], jo[k], rtol=8e-3, atol=1e-6)
        else:
            np.testing.assert_array_equal(to_np(to[k]), to_np(jo[k]))


def test_fused_mixed_dtype_groups_by_dtype():
    span = 4
    jt, tt = ragged_tree(span)
    jb, tb = ragged_tree(span, sizes=[257, 4000], dtype="bfloat16", seed=5)
    jt.update({f"b{k}": v for k, v in jb.items()})
    tt.update({f"b{k}": v for k, v in tb.items()})
    jo, to = _fused_pair(jt, tt, 1e-4)
    for k in tt:
        assert to[k].dtype == tt[k].dtype
        close(to[k], jo[k])


def test_fused_multi_bucket_matches_reference():
    span = 2
    host = {f"m{i}": rnd((span, 400_000), i) for i in range(4)}
    jt = {k: jnp.asarray(v) for k, v in host.items()}
    tt = {k: torch.from_numpy(v) for k, v in host.items()}
    plan = TC.fused_plan(T.leaves(tt), TC.CombineConfig(fusion_threshold_mb=1))
    assert len(plan) == 4
    jo, to = _fused_pair(jt, tt, 2e-5, fusion_threshold_mb=1)
    single = TC.fused_combine_tree(tt, TC.CombineConfig())
    for k in tt:
        close(to[k], jo[k])
        close(to[k], single[k])


def test_fused_zero_lanes_degrade_to_sum():
    live = rnd(5000, 0)
    stacked = np.stack([live, np.zeros_like(live)])
    jo, to = _fused_pair({"w": jnp.asarray(stacked)},
                         {"w": torch.from_numpy(stacked)}, 2e-5)
    close(to["w"], live, rtol=1e-6, atol=1e-6)
    close(to["w"], jo["w"])


def test_fused_plain_impl_equals_kernel_arm_on_cpu():
    _, tt = ragged_tree(4)
    cfg = TC.CombineConfig(use_pallas=True)
    a = TC.fused_combine_tree(tt, cfg)
    b = TC.fused_combine_tree(tt, cfg, impl="plain")
    for k in tt:
        assert torch.equal(a[k], b[k])


@pytest.mark.parametrize("with_stats", [False, True])
def test_fused_combiner_builds_its_plan_once(monkeypatch, with_stats):
    """The combiner keeps its static plan and bucket maps: a second call
    on leaves of the same shapes rebuilds neither, and gives what a
    fresh combine gives."""
    calls = []
    inner = TC.fused_plan
    monkeypatch.setattr(TC, "fused_plan",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    cfg = TC.CombineConfig(fusion_threshold_mb=1)
    fn = TC.build_fused_combiner(cfg, with_stats=with_stats)
    outs = []
    for seed in (0, 1):
        tt = ragged_tree(4, seed=seed)[1]
        out = fn(tt)
        outs.append((out, TC.fused_combine_tree(tt, cfg)))
    assert len(calls) == 3        # the combiner's first call, two fresh
    for got, want in outs:
        got = got[0] if with_stats else got
        for k in want:
            assert torch.equal(got[k], want[k])


def test_fused_donate_releases_inputs():
    _, host = ragged_tree(2)
    # torch-allocated storage (a numpy-backed tensor cannot be resized)
    tt = {k: v.clone() for k, v in host.items()}
    keep = {k: v.clone() for k, v in tt.items()}
    out = TC.fused_combine_tree(tt, TC.CombineConfig(), donate=True)
    assert all(v.untyped_storage().nbytes() == 0 for v in tt.values())
    ref = TC.fused_combine_tree(keep, TC.CombineConfig())
    for k in keep:
        assert torch.equal(out[k], ref[k])


@pytest.mark.parametrize("cfg", [
    dict(op="adasum", backend="gspmd_tree"),
    dict(op="adasum", backend="gspmd_tree", fused=False),
    dict(op="adasum", backend="fused"),
    dict(op="adasum", backend="linear"),
    dict(op="sum"), dict(op="mean")])
def test_registry_entries_match_reference(cfg):
    jt, tt = ragged_tree(4, sizes=[64, 1025, 300])
    jc = JR.make_combiner(JC.CombineConfig(**cfg))
    tc = TR.make_combiner(TC.CombineConfig(**cfg))
    assert tc.combine_path == jc.combine_path
    jo, to = jc(jt), tc(tt)
    for k in tt:
        close(to[k], jo[k])
    js, ts = (JR.make_combiner(JC.CombineConfig(**cfg), with_stats=True),
              TR.make_combiner(TC.CombineConfig(**cfg), with_stats=True))
    close(ts(tt)[1]["levels"], js(jt)[1]["levels"], rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["dasgd"])
def test_later_combiners_raise(name):
    """'dasgd' is no combiner of the reference (its registry names it only
    in a docstring example): both registries raise their KeyError."""
    from types import SimpleNamespace
    for reg, cc in ((TR, TC), (JR, JC)):
        with pytest.raises(KeyError, match=f"unknown combiner '{name}'"):
            reg.make_combiner(cc.CombineConfig(op=name))
    with pytest.raises(KeyError, match=f"unknown combiner '{name}'"):
        TR.make_combiner(TC.CombineConfig(op=name),
                         comm=SimpleNamespace(world=2))


def test_combine_config_fields_match_reference():
    assert [f.name for f in dataclasses.fields(TC.CombineConfig)] == \
        [f.name for f in dataclasses.fields(JC.CombineConfig)]
    assert dataclasses.asdict(TC.CombineConfig()) == \
        dataclasses.asdict(JC.CombineConfig())
    assert TC.CombineConfig(fusion_threshold_mb=3).fusion_bytes == \
        JC.CombineConfig(fusion_threshold_mb=3).fusion_bytes
