"""acc_dtype="float64" (the paper's fp64 dot accumulation, §4.4.1) in the
port against the JAX package run with x64 enabled, and against numpy.

Nothing in the JAX package turns on `jax_enable_x64`, and without it the
reference's "float64" silently runs in fp32; so its side runs here in a
subprocess with JAX_ENABLE_X64=1, on the same numpy inputs. The port's
two arms follow the reference's two (combine.py:233-240):

  * the plain arm (impl="plain", reference use_pallas=False) accumulates
    in fp64 throughout: its dot triples match the reference's, and
    numpy's fp64 sums, to 1e-12 relative (fp64 summation order only);
  * the kernel arm (impl="kernel", on the CPU the kernel's plain fp32
    version; reference use_pallas=True, the Pallas kernel in interpret
    mode) casts fp32 block partials to fp64: its triples match the
    reference's within KERNEL_RTOL = 1e-5 of the scale sqrt(a·a b·b)
    (two fp32 sums of 8192 products in different orders).

The combined outputs are fp32 buffers either way (the scalars are fp64,
the combine runs in the buffer dtype or fp32): within 1e-6 of each
leaf's largest element. adascale's fp64 moments likewise.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.core import combine as C
from repro_torch.core import rvh as R
from repro_torch.engine import make_combiner
from repro_torch.kernels import adasum as K

from torch_dist_workers import SRC

F64 = torch.float64
BLOCK = 1024
KERNEL_RTOL = 1e-5
ARMS = {"plain": False, "kernel": True}      # impl -> reference use_pallas


def _inputs():
    rng = np.random.default_rng(3)
    n = 4 * K.BLOCK_ELEMS       # four segments of one 8192-element block
    # a and b share a component, so the dots do not cancel to ~0
    a = rng.standard_normal(n).astype(np.float32)
    b = (0.5 * a + rng.standard_normal(n)).astype(np.float32)
    seg = np.repeat(np.arange(4), n // 4).astype(np.int32)
    lanes = {"w": rng.standard_normal((4, 2000)).astype(np.float32),
             "v": (5 * rng.standard_normal((4, 33, 40))).astype(np.float32),
             "u": rng.standard_normal((4, 7)).astype(np.float32)}
    return a, b, seg, lanes


_REF = r"""
import sys, numpy as np, jax, jax.numpy as jnp
assert jax.config.jax_enable_x64
from repro.core import combine as JC, rvh as JR
from repro.engine import make_combiner
from repro.kernels.adasum_dots import block_dots
from repro.kernels.ref import block_dots_ref
d = np.load(sys.argv[1])
a, b, seg = jnp.asarray(d["a"]), jnp.asarray(d["b"]), jnp.asarray(d["seg"])
lanes = {k[6:]: jnp.asarray(d[k]) for k in d.files if k.startswith("lanes/")}
out = {"blocks_plain": block_dots_ref(a, b, 1024, jnp.float64),
       "blocks_kernel": block_dots(a, b, block_elems=1024).astype(
           jnp.float64)}
for arm, pallas in (("plain", False), ("kernel", True)):
    out["seg_" + arm] = JR.segment_dots(a, b, seg, 4, jnp.float64, pallas)
    for pl in (True, False):
        cfg = JC.CombineConfig(acc_dtype="float64", use_pallas=pallas,
                               per_layer=pl, fusion_threshold_mb=0.01)
        collect = []
        comb = JC.fused_combine_tree(lanes, cfg, collect=collect)
        tag = f"{arm}_{pl}"
        out["levels_" + tag] = jnp.stack(collect)
        for k, v in comb.items():
            out[f"comb_{tag}/{k}"] = v
for pl in (True, False):
    cfg = JC.CombineConfig(op="adascale", acc_dtype="float64", per_layer=pl)
    for k, v in make_combiner(cfg)(lanes).items():
        out[f"adascale_{pl}/{k}"] = v
assert out["seg_plain"].dtype == jnp.float64
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fp64")
    a, b, seg, lanes = _inputs()
    np.savez(tmp / "in.npz", a=a, b=b, seg=seg,
             **{f"lanes/{k}": v for k, v in lanes.items()})
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="1")
    res = subprocess.run([sys.executable, "-c", _REF, str(tmp / "in.npz"),
                          str(tmp / "out.npz")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    return np.load(tmp / "out.npz")


def _triples_close(got, want, rtol):
    """Each triple within rtol of its own scale sqrt(a·a b·b)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.sqrt(np.abs(want[..., 1] * want[..., 2]))[..., None]
    assert (np.abs(got - want) <= rtol * np.maximum(scale, 1e-300)).all(), \
        np.abs(got - want).max()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_plain_block_dots_fp64_match_reference_and_numpy(ref):
    a, b, _, _ = _inputs()
    got = K.block_dots(_t(a), _t(b), block_elems=BLOCK, plain=True,
                       acc_dtype=F64)
    assert got.dtype == F64
    _triples_close(got, ref["blocks_plain"], 1e-12)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    np_blocks = np.stack([(a64 * b64).reshape(-1, BLOCK).sum(1),
                          (a64 * a64).reshape(-1, BLOCK).sum(1),
                          (b64 * b64).reshape(-1, BLOCK).sum(1)], -1)
    _triples_close(got, np_blocks, 1e-12)


def test_kernel_arm_casts_fp32_partials(ref):
    a, b, _, _ = _inputs()
    got = C.block_partials(_t(a), _t(b), BLOCK, F64, "kernel")
    assert got.dtype == F64
    _triples_close(got, ref["blocks_kernel"], KERNEL_RTOL)
    # the partials themselves are fp32 values
    assert torch.equal(got, got.float().double())
    with pytest.raises(ValueError, match="accumulates in fp32"):
        K.block_dots(_t(a), _t(b), block_elems=BLOCK, acc_dtype=F64)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_rvh_segment_dots_fp64(ref, arm):
    a, b, seg, _ = _inputs()
    block = K.BLOCK_ELEMS       # the reference's ops.adasum_segment_dots
    block_seg = seg[::block].astype(np.int64)
    meta = R.RoundMeta(block, torch.from_numpy(block_seg),
                       K.SegmentSum(block_seg, 5, "cpu"))
    got = R.segment_dots(_t(a), _t(b), meta, F64, impl=arm)
    assert got.dtype == F64
    _triples_close(got[:4], ref["seg_" + arm],
                   1e-12 if arm == "plain" else KERNEL_RTOL)
    if arm == "plain":
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        want = np.stack([np.bincount(seg, w) for w in
                         (a64 * b64, a64 * a64, b64 * b64)], -1)
        _triples_close(got[:4], want, 1e-12)


@pytest.mark.parametrize("per_layer", [True, False])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_fused_combine_fp64_matches_reference(ref, arm, per_layer):
    """Every tree level's dot triple (1e-12 plain, KERNEL_RTOL kernel,
    each relative to its level's scale), and the combined leaves."""
    _, _, _, lanes = _inputs()
    cfg = C.CombineConfig(acc_dtype="float64", use_pallas=ARMS[arm],
                          per_layer=per_layer, fusion_threshold_mb=0.01)
    collect = []
    out = C.fused_combine_tree({k: _t(v) for k, v in lanes.items()}, cfg,
                               collect, impl=arm)
    tag = f"{arm}_{per_layer}"
    levels = torch.stack(collect)
    assert levels.dtype == F64 and levels.shape == (2, 3)
    _triples_close(levels, ref["levels_" + tag],
                   1e-12 if arm == "plain" else KERNEL_RTOL)
    for k in lanes:
        want = ref[f"comb_{tag}/{k}"]
        assert out[k].dtype == torch.float32
        err = np.abs(out[k].numpy() - want).max()
        assert err <= 1e-6 * np.abs(want).max(), (k, err)


@pytest.mark.parametrize("per_layer", [True, False])
def test_adascale_fp64_moments_match_reference(ref, per_layer):
    _, _, _, lanes = _inputs()
    comb = make_combiner(C.CombineConfig(op="adascale", acc_dtype="float64",
                                         per_layer=per_layer))
    got = comb({k: _t(v) for k, v in lanes.items()})
    for k in lanes:
        want = ref[f"adascale_{per_layer}/{k}"]
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
