"""The port's ADASUMRVH (paper Algorithm 1) across CPU ranks over gloo,
against the JAX package's `repro.core.rvh.adasum_rvh_pytree` under
shard_map on 4 fake devices (world 2, world 4 and a (pod, data) 2x2
mesh; per-layer and whole-model; several buckets and one; int8 and not;
`use_pallas` off and on, the Pallas kernels in interpret mode) and
against the port's single-process `adasum_tree_reduce` on the same lanes;
plus RVH without its allgather phase (ZeRO-1) against the reference's
`adasum_rvh_local(..., allgather_result=False)`, RVH on tensor-parallel
shards (a (data 2, model 2) grid, `leaf_specs` / `seg_scale` and the
model group's dot sum) against the reference's `adasum_rvh_pytree` with
`leaf_specs`, the comm's collectives and the refusals.

The ranks run in one launch per world (`torch_dist_workers.launch`) and
the reference in one JAX subprocess, started first so the two overlap.

Tolerances, with their reasons:
  * rtol = atol = 2e-5 on every element: the reference's own
    (tests/test_multidevice.py); both sides sum the same fp32 dot
    products in another order;
  * CombineStats level 0 (round 0's dots) against the reference's
    `probe_stats`: rtol 2e-5, atol 1e-6 (test_torch_adasum.py's);
  * int8, same layout as the reference (use_pallas on: both align leaves
    to 8192): 2e-5 everywhere except on elements within an fp32 ulp of a
    quantization rounding boundary, which the two libraries' last-bit
    differences can send one step (the element's 128-block absmax / 127)
    apart. At most INT8_FLIP_FRACTION of the elements may do so, none by
    more than one step of the leaf's largest block; the fraction found is
    printed. The reference's owner keeps its own chunk exact (its
    replicas differ); the port holds every rank at the value every other
    rank holds there, so that is the value compared (the view of the
    owner's distance-1 partner);
  * int8 with use_pallas off: the reference packs leaves back to back,
    so its 128-element quantization blocks differ from the port's and
    every element may differ by quantization noise: held to two steps
    of the leaf's largest value / 127, as is int8 against the exact tree;
  * int8 CombineStats: round 0 dots the partner's dequantized half
    where the reference's probe dots the exact lanes. Quantization noise
    moves a·b, a·a and b·b by amounts that scale with ‖a‖·‖b‖ (not with
    a·b, which is small for nearly orthogonal lanes), so each entry is
    held within INT8_STATS_RTOL of sqrt(a·a · b·b); measured ~7e-5.
"""
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.core import adasum as TA
from repro_torch.core import rvh as R
from repro_torch.core.combine import CombineConfig
from repro_torch.engine import registry as TR
from repro_torch.engine.build import EngineWarning, _resolve_combine_cfg
from repro_torch.parallel.comm import Comm
from repro_torch.parallel.policy import RunPolicy

from torch_dist_workers import SRC, launch

TOL = dict(rtol=2e-5, atol=2e-5)
INT8_FLIP_FRACTION = 1e-3
INT8_STATS_RTOL = 5e-4
BUCKET = 24 << 10                  # several buckets over the leaves below
SHAPES = {"a": (3, 700), "b": (5000,), "c": (64, 33), "d": (10,),
          "e": (2, 4096)}
KEYS = sorted(SHAPES)

# name: (world, mesh, per_layer, bucket_bytes, compress, use_pallas)
CASES = {
    "w2": (2, "flat", True, BUCKET, "none", False),
    "w2_whole": (2, "flat", False, None, "none", False),
    "w2_int8_pallas": (2, "flat", True, BUCKET, "int8", True),
    "w4": (4, "flat", True, BUCKET, "none", False),
    "w4_one_bucket": (4, "flat", True, None, "none", False),
    "w4_whole": (4, "flat", False, None, "none", False),
    "w4_pallas": (4, "flat", True, BUCKET, "none", True),
    "w4_whole_pallas": (4, "flat", False, None, "none", True),
    "w4_int8_pallas": (4, "flat", True, BUCKET, "int8", True),
    "w4_int8": (4, "flat", True, BUCKET, "int8", False),
    "pod2x2": (4, "pod", True, BUCKET, "none", False),
    "pod2x2_int8_pallas": (4, "pod", True, BUCKET, "int8", True),
}
# the (2, 2) tensor-parallel case: the model-axis spec of each leaf (lanes
# 0 and 1 of the world-4 file, one a data index)
TP_SPECS = {"a": (None, "model"), "b": (None,), "c": ("model", None),
            "d": (None,), "e": (None, "model")}


def _port_cases(world):
    """The distinct port runs of a world (the mesh shape is the
    reference's business: the port's schedule is flat)."""
    seen = []
    for w, _mesh, *rest in CASES.values():
        if w == world and tuple(rest) not in seen:
            seen.append(tuple(rest))
    return seen


_REF = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.core import fusion, rvh
from repro.engine.registry import probe_stats
from repro.launch.mesh import make_mesh_compat
lanes_path, out_path, cases = sys.argv[1], sys.argv[2], eval(sys.argv[3])
keys = sorted(eval(sys.argv[4]))
tp_specs, tp_bucket = eval(sys.argv[5])
res = {}
# tensor-parallel shards: a (data 2, model 2) mesh, the leaves' specs
data = np.load(lanes_path.format(4))
mesh = make_mesh_compat((2, 2), ("data", "model"))
specs = {k: P(*tp_specs[k]) for k in keys}
tree = {k: jax.device_put(data[k][:2],
                          NamedSharding(mesh, P("data", *specs[k])))
        for k in keys}
out = jax.jit(lambda t: rvh.adasum_rvh_pytree(
    t, mesh, ("data",), leaf_specs=specs, bucket_bytes=tp_bucket))(tree)
for k in keys:
    res[f"tp/{k}"] = np.asarray(out[k])
for name, (world, mesh_kind, per_layer, bucket, compress, pallas) in cases.items():
    data = np.load(lanes_path.format(world))
    tree = {k: data[k] for k in keys}
    if mesh_kind == "pod":
        mesh = make_mesh_compat((2, 2), ("pod", "data"))
        axes, spec = ("data", "pod"), P(("pod", "data"))
    else:
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:world]), ("data",))
        axes, spec = ("data",), P("data")
    sh = {k: jax.device_put(v, NamedSharding(mesh, spec)) for k, v in tree.items()}
    out = jax.jit(lambda t: rvh.adasum_rvh_pytree(
        t, mesh, axes, per_layer=per_layer, use_pallas=pallas,
        compress=compress, bucket_bytes=bucket))(sh)
    # each device's own result, by lane (pod-major lane index)
    lane_of = {}
    for idx in np.ndindex(mesh.devices.shape):
        c = dict(zip(mesh.axis_names, idx))
        lane_of[mesh.devices[idx]] = (c.get("pod", 0) * 2 + c["data"]
                                      if mesh_kind == "pod" else c["data"])
    views = {k: [None] * world for k in keys}
    for k in keys:
        for s in out[k].addressable_shards:
            views[k][lane_of[s.device]] = np.asarray(s.data)
    # owner of every element: chunk c of each bucket buffer ends on lane
    # bitreverse(c); the owner's distance-1 partner holds it dequantized
    # exactly once
    bits = world.bit_length() - 1
    rev = lambda c: int(format(c, f"0{bits}b")[::-1], 2) if bits else 0
    leaves = [jnp.zeros(tree[k].shape[1:], jnp.float32) for k in keys]
    if per_layer and bucket and len(leaves) > 1:
        ranges = fusion.bucketize_sizes([l.size * 4 for l in leaves], bucket)
    else:
        ranges = [(0, len(leaves))]
    owner = [None] * len(keys)
    for lo, hi in ranges:
        lay = fusion.make_layout(tuple(leaves[lo:hi]), align=world,
                                 leaf_align=8192 if pallas else 1)
        chunk = lay.padded_len // world
        buf = np.asarray([rev(c) for c in range(world)], np.float32)[
            np.arange(lay.padded_len) // chunk]
        owner[lo:hi] = [np.asarray(x).astype(np.int64)
                        for x in fusion.unpack(jnp.asarray(buf), lay)]
    for i, k in enumerate(keys):
        stack = np.stack(views[k])
        res[f"{name}/{k}"] = np.take_along_axis(
            stack, (owner[i] ^ 1)[None], axis=0)[0]
        res[f"{name}/replicated/{k}"] = np.asarray(
            all(np.array_equal(v, views[k][0]) for v in views[k]))
    res[f"{name}/probe"] = np.asarray(probe_stats(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.float32)["levels"])
# ZeRO-1: one bucket through adasum_rvh_local without its allgather;
# each device's owned chunk, by lane
for world in (2, 4):
    data = np.load(lanes_path.format(world))
    buf, seg = data["local_buf"], data["local_seg"]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:world]), ("data",))
    fn = rvh._shard_map_compat(
        lambda b: rvh.adasum_rvh_local(
            b[0], jnp.asarray(seg), [("data", world)], int(seg.max()),
            allgather_result=False)[None],
        mesh, (P("data"),), P("data"))
    res[f"local{world}"] = np.asarray(jax.jit(fn)(buf))
np.savez(out_path, **res)
print("OK")
"""


def _lanes(world):
    rng = np.random.default_rng(100 + world)
    return {k: (rng.standard_normal((world,) + s) * (1 + i)
                + 0.3 * rng.standard_normal(s)).astype(np.float32)
            for i, (k, s) in enumerate(sorted(SHAPES.items()))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rvh")
    for w in (2, 4):
        np.savez(tmp / f"lanes{w}.npz", **_lanes(w), **_local_bucket(w))
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF, str(tmp / "lanes{}.npz"),
         str(tmp / "ref.npz"), repr(CASES), repr(SHAPES),
         repr((TP_SPECS, BUCKET))], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = {}
        for w in (2, 4):
            cases = _port_cases(w)
            ranks = launch(w, "rvh", {
                "lanes": str(tmp / f"lanes{w}.npz"), "keys": KEYS,
                "local": True, "tp": ({"specs": {
                    k: list(s) for k, s in TP_SPECS.items()},
                    "bucket": BUCKET} if w == 4 else None),
                "cases": [dict(per_layer=p, bucket_bytes=b, compress=c,
                               use_pallas=u) for p, b, c, u in cases]},
                tmp, timeout=300)
            for i, case in enumerate(cases):
                port[(w,) + case] = [r[i] for r in ranks]
            port[(w, "local")] = [r[-2 if w == 4 else -1] for r in ranks]
            if w == 4:
                port["tp"] = [r[-1] for r in ranks]
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log
    return port, np.load(tmp / "ref.npz")


def _local_bucket(world):
    """One bucket for `adasum_rvh_local`: [world, n] lanes with three
    block-aligned layers and a zero padding block (segment 3)."""
    rng = np.random.default_rng(200 + world)
    blocks = [0] * 5 + [1] * 3 + [2] * (8 * world - 9) + [3]
    seg = np.repeat(np.asarray(blocks, np.int32), 8192)
    buf = (rng.standard_normal((world, seg.size))
           + 0.5 * rng.standard_normal(seg.size)).astype(np.float32)
    buf[:, seg == 3] = 0.0
    return {"local_buf": buf, "local_seg": seg}


def _tree_reduce(world, per_layer):
    lanes = _lanes(world)
    out = TA.adasum_tree_reduce(
        {k: torch.from_numpy(v) for k, v in lanes.items()},
        per_layer=per_layer)
    return {k: v.numpy() for k, v in out.items()}


def _flips(got, want):
    """Elements beyond 2e-5, as a fraction, and their largest error in
    quantization steps of the leaf's largest value."""
    bad = np.abs(got - want) > TOL["atol"] + TOL["rtol"] * np.abs(want)
    step = np.abs(want).max() / 127
    worst = (np.abs(got - want)[bad].max() / step) if bad.any() else 0.0
    return bad.mean(), worst


@pytest.mark.parametrize("name", list(CASES))
def test_rvh_matches_reference(runs, name):
    port, ref = runs
    world, mesh, per_layer, bucket, compress, pallas = CASES[name]
    ranks = port[(world, per_layer, bucket, compress, pallas)]
    got = ranks[0]["tree"]
    # every rank holds the same bits
    assert all(r["bitwise"] for r in ranks)
    for r in ranks[1:]:
        assert all(np.array_equal(r["tree"][k], got[k]) for k in KEYS)
    exact = _tree_reduce(world, per_layer)
    if compress == "none":
        for k in KEYS:
            want = ref[f"{name}/{k}"]
            if name == "w4_whole_pallas":
                # the reference marks the last padded_len - sum(sizes)
                # elements as padding (rvh.py:303-306), leaf data too once
                # leaves are 8192-aligned; its use_pallas=False run is the
                # whole-model function (ROADMAP queue 3)
                want = ref[f"w4_whole/{k}"]
            assert bool(ref[f"{name}/replicated/{k}"])
            np.testing.assert_allclose(got[k], want, err_msg=k, **TOL)
            np.testing.assert_allclose(got[k], exact[k], err_msg=k, **TOL)
        np.testing.assert_allclose(ranks[0]["levels"], ref[f"{name}/probe"],
                                   rtol=2e-5, atol=1e-6)
        return
    for k in KEYS:
        want = ref[f"{name}/{k}"]
        two_steps = 2 * np.abs(want).max() / 127
        assert np.abs(got[k] - exact[k]).max() <= two_steps, k
        if pallas:
            frac, worst = _flips(got[k], want)
            print(f"{name}/{k}: {frac:.2e} of elements one quantization "
                  f"step apart (largest {worst:.3f} steps)")
            assert frac <= INT8_FLIP_FRACTION and worst <= 1.01, (k, frac,
                                                                  worst)
        else:
            assert np.abs(got[k] - want).max() <= two_steps, k
    got_l, want_l = ranks[0]["levels"][0], ref[f"{name}/probe"][0]
    scale = np.sqrt(want_l[1] * want_l[2])
    err = np.abs(got_l - want_l).max() / scale
    print(f"{name}: CombineStats level 0 off by {err:.2e} of sqrt(aa*bb)")
    assert err <= INT8_STATS_RTOL, (got_l, want_l)


@pytest.mark.parametrize("world", [2, 4])
def test_rvh_stages_nothing_on_cpu(runs, world):
    port, _ = runs
    for key, ranks in port.items():
        if key[0] == world:
            assert all(r["staged"] == 0 for r in ranks)


# ----------------------------------------------------------- pure pieces
@pytest.mark.parametrize("n", [128, 1 << 12, (1 << 24) + 256])
def test_quantize_round_half_even_matches_reference(n):
    """Both sides round half to even with the same scales (rvh.py:84-96);
    the last case crosses a QCHUNK piece."""
    import jax.numpy as jnp
    from repro.core import rvh as JR
    rng = np.random.default_rng(n % 997)
    x = rng.standard_normal(n).astype(np.float32)
    x[:128] = np.arange(128, dtype=np.float32) - 63.5   # exact .5 quotients
    q, s = R.quantize(torch.from_numpy(x))
    jq, js = JR._quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        R.dequantize(q, s, torch.float32).numpy(),
        np.asarray(JR._dequantize(jq, js, jnp.float32)))


@pytest.mark.parametrize("world,ranks", [
    (2, [1]), (4, [1, 2]), (8, [1, 2, 4]), (1, [])])
def test_round_distances(world, ranks):
    assert R.round_distances(world) == ranks


def test_round_distances_refuse_non_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        R.round_distances(6)


def test_plan_halves_stay_whole_blocks_and_slice_segments():
    """Every round's kept half is whole 8192-blocks and its segment map
    is the matching slice of the bucket's (rvh.py:157-161)."""
    leaves = [torch.zeros(s) for s in [(3, 700), (5000,), (10,)]]
    for world in (2, 4, 8):
        for rank in range(world):
            (b,) = R.rvh_plan(leaves, world, rank, device="cpu")
            nblk = b.layout.padded_len // 8192
            assert b.layout.padded_len % (world * 8192) == 0
            seen = nblk
            for meta in b.metas:
                seen //= 2
                assert meta.block_seg.shape == (seen,)
                assert bool((meta.block_seg[1:] >= meta.block_seg[:-1]).all())


def _fake_comm(world, rank=0):
    return types.SimpleNamespace(world=world, rank=rank, timed=None)


@pytest.mark.parametrize("world", [2, 4])
def test_allgather_false_is_zero_1_and_refused(runs, world):
    """ZeRO-1 (the name is from when it was refused): without its
    allgather phase RVH returns on each rank the chunk it owns — the
    chunk the reference's `adasum_rvh_local(..., allgather_result=False)`
    leaves on that device under shard_map (TOL), and bitwise the same
    chunk of the full result."""
    port, ref = runs
    want = ref[f"local{world}"].reshape(world, -1)
    for rank, got in enumerate(port[(world, "local")]):
        chunk = got["full"].size // world
        off = R.owned_chunk(rank, world) * chunk
        assert got["owned"].shape == (chunk,)
        np.testing.assert_allclose(got["owned"], want[rank], **TOL)
        assert np.array_equal(got["owned"], got["full"][off:off + chunk])


def _tp_want(ref, rank, k):
    """Rank (d, m) = (rank // 2, rank % 2)'s model shard of the
    reference's combined leaf k."""
    want = ref[f"tp/{k}"]
    d = next((j for j, e in enumerate(TP_SPECS[k]) if e == "model"), None)
    if d is None:
        return want
    n = want.shape[d] // 2
    return np.take(want, range((rank % 2) * n, (rank % 2 + 1) * n), axis=d)


@pytest.mark.parametrize("tp", [dict(model_axes=("model",)),
                                dict(seg_scale=torch.ones(2))])
def test_tp_dots_refused(runs, tp):
    """Refused until the model axis came (the name is from then). RVH on
    tensor-parallel shards of a (data 2, model 2) grid: with the model
    group's dot sum (the reference's `model_axes`), each rank's result is
    its shard of the reference's `adasum_rvh_pytree(leaf_specs=...)`
    (TOL); with `seg_scale`, the level-0 CombineStats count a leaf the
    model axis does not shard once: the whole leaves' triple, the same
    bits on every rank."""
    port, ref = runs
    if "model_axes" in tp:
        for rank, got in enumerate(port["tp"]):
            for k in KEYS:
                want = _tp_want(ref, rank, k)
                assert got["tree"][k].shape == want.shape, k
                np.testing.assert_allclose(got["tree"][k], want, **TOL)
        return
    lanes = _lanes(4)
    a = np.concatenate([lanes[k][0].reshape(-1) for k in KEYS])
    b = np.concatenate([lanes[k][1].reshape(-1) for k in KEYS])
    want = np.array([a @ b, a @ a, b @ b], np.float64)
    for got in port["tp"]:
        np.testing.assert_allclose(got["levels"], want, rtol=2e-5, atol=1e-6)
        np.testing.assert_array_equal(got["levels"], port["tp"][0]["levels"])


def test_tp_leaf_specs_refused(runs):
    """Refused until the model axis came (the name is from then). TP leaf
    specs: the leaves the model axis does not shard come back bitwise
    equal across each model group and every leaf across each data
    group; specs naming no model axis change nothing; whole-model Adasum
    with mixed replication factors raises, as the reference asserts."""
    port, _ = runs
    for got in port["tp"]:
        assert got["model_bitwise"] and got["data_bitwise"]
    x = {"w": torch.arange(8.0), "v": torch.ones(3)}
    same = R.adasum_rvh_pytree(x, _fake_comm(1),
                               leaf_specs={"w": (None,), "v": (None,)})
    assert all(torch.equal(same[k], x[k]) for k in x)
    with pytest.raises(ValueError, match="uniform TP sharding"):
        R.rvh_plan([torch.zeros(4), torch.zeros(4)], 2, 0, per_layer=False,
                   factors=[1.0, 0.5])


def test_make_combiner_rvh_needs_a_comm():
    cfg = CombineConfig(op="adasum", backend="rvh")
    with pytest.raises(ValueError, match="comm="):
        TR.make_combiner(cfg)
    with pytest.raises(ValueError, match="comm="):
        TR.make_combiner(cfg, with_stats=True)


def test_make_combiner_rvh_with_a_comm(tmp_path, monkeypatch):
    """A one-rank gloo group in this process: the registry returns the
    RVH combiner (combine_path 'rvh'), which is the identity at world 1;
    across ranks sum builds its cross-rank sum, gspmd_tree warns and runs
    RVH, and the explicitly fused combine refuses, as the reference's
    does with the lane axis sharded (their runs are
    tests/test_torch_dist_train.py's)."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    comm = Comm.init("gloo", torch.device("cpu"),
                     init_method=f"file://{tmp_path}/store", timeout_s=60)
    try:
        cfg = CombineConfig(op="adasum", backend="rvh")
        c = TR.make_combiner(cfg, comm=comm)
        assert c.combine_path == "rvh"
        x = {"w": torch.arange(6.0).reshape(2, 3)}
        assert torch.equal(c(x)["w"], torch.arange(6.0).reshape(2, 3))
        s = TR.make_combiner(cfg, comm=comm, with_stats=True)
        assert s.combine_path == "rvh"
        assert s(x)[1]["levels"].shape == (0, 3)
        assert comm.group_sum(torch.ones(3), 1).tolist() == [1, 1, 1]
    finally:
        comm.close()
    two = _fake_comm(2)
    assert TR.make_combiner(CombineConfig(op="sum"),
                            comm=two).combine_path == "sum"
    with pytest.warns(EngineWarning, match="runs as RVH"):
        c = TR.make_combiner(CombineConfig(op="adasum",
                                           backend="gspmd_tree"), comm=two)
    assert c.combine_path == "rvh"
    with pytest.raises(ValueError, match="one per rank"):
        TR.make_combiner(CombineConfig(op="adasum", backend="fused"),
                         comm=two)


# -------------------------------------------------------------- refusals
def test_nccl_refused_on_a_host_without_cards(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="one card per rank: 2 ranks"):
        Comm.init("nccl", torch.device("cpu"))
    with pytest.raises(ValueError, match="dist backend"):
        Comm.init("mpi", torch.device("cpu"))


def test_nccl_refused_on_the_cpu(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="nccl carries CUDA tensors"):
        Comm.init("nccl", torch.device("cpu"))


def test_nccl_refused_for_ranks_sharing_a_card(monkeypatch):
    """Two ranks on a two-card host, the second naming card 0."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="one card per rank.*gloo"):
        Comm.init("nccl", torch.device("cuda", 0))


def test_explicit_rvh_below_dp_warns_or_raises_under_strict():
    rpol = RunPolicy(span=2, backend="rvh")
    with pytest.warns(EngineWarning, match="falling back"):
        ccfg = _resolve_combine_cfg(rpol, 2, None, False, dp_total=4)
    assert ccfg.backend == "gspmd_tree"
    with pytest.raises(ValueError, match="rvh"):
        _resolve_combine_cfg(rpol, 2, None, True, dp_total=4)
    auto = RunPolicy(span=0, backend="")
    assert _resolve_combine_cfg(auto, 4, None, True, dp_total=4).backend \
        == "rvh"
    assert _resolve_combine_cfg(dataclasses.replace(auto, span=2), 2, None,
                                True, dp_total=4).backend == "gspmd_tree"
