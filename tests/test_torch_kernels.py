"""The serving kernels' plain versions against the JAX package.

`flash_attention_ref` is held to `_chunked_attention` (the reference's
own oracle for the flash kernel; the Pallas flash kernel itself cannot
run on this container's jax). `paged_decode_attention_ref` is held to
the Pallas paged-decode kernel in interpret mode and to the gather path.
The CUDA kernels are held to these plain versions on the card by
`chip_smoke.py`. Inputs come from numpy seeds.

Tolerances: fp32 — both sides compute fp32 scores and softmax, so they
differ only by summation order (2e-5 on outputs of unit scale). bf16 —
both sides round the probabilities and the output to bf16, and may
accumulate P.V in different orders: one bf16 ulp at |x| <= 4 is 0.016,
so 2e-2.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.flash_attention import paged_decode_attention as \
    jax_paged_decode
from repro.models.attention import _chunked_attention as jax_chunked
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as TATT

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, T, S, H, KV, Dh, dtype):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, T, H, Dh), rng.randn(B, S, KV, Dh),
            rng.randn(B, S, KV, Dh)]
    j = [jnp.asarray(a, jnp.float32).astype(_JDT[dtype]) for a in arrs]
    t = [torch.from_numpy(a.astype(np.float32)).to(_TDT[dtype])
         for a in arrs]
    return j, t


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


# case -> (B, T, S, H, KV, Dh, causal, window, q_offset)
FLASH_CASES = {
    "causal": (2, 128, 128, 4, 2, 16, True, 0, 0),
    "causal_gqa4": (1, 64, 64, 8, 2, 32, True, 0, 0),
    "window32": (1, 128, 128, 4, 2, 16, True, 32, 0),
    "window96": (1, 128, 128, 4, 1, 16, True, 96, 0),
    "noncausal": (2, 64, 96, 4, 2, 16, False, 0, 0),
    "q_offset": (2, 96, 128, 4, 2, 16, True, 0, 32),
    "ragged": (1, 70, 70, 4, 2, 16, True, 0, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_ref_matches_chunked_attention(case, dtype):
    B, T, S, H, KV, Dh, causal, window, off = FLASH_CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _inputs(7, B, T, S, H, KV, Dh, dtype)
    want = jax_chunked(jq, jk, jv, jnp.arange(off, off + T, dtype=jnp.float32),
                       jnp.arange(S, dtype=jnp.float32), causal=causal,
                       window=window, chunk=32)
    got = FA.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                 q_offset=off)
    assert got.dtype == _TDT[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=0)
    # the wrapper on CPU tensors is the plain version, bit for bit
    assert torch.equal(FA.flash_attention(tq, tk, tv, causal=causal,
                                          window=window, q_offset=off), got)


def test_port_chunked_attention_is_chunk_invariant():
    (_, (tq, tk, tv)) = _inputs(3, 1, 100, 100, 4, 2, 16, "float32")
    pos = torch.arange(100, dtype=torch.float32)
    a = TATT._chunked_attention(tq, tk, tv, pos, pos, causal=True,
                                window=0, chunk=7)
    b = TATT._chunked_attention(tq, tk, tv, pos, pos, causal=True,
                                window=0, chunk=100)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def _gather_ref(q, kp, vp, pt, pos, rolling):
    """The numpy gather oracle of tests/test_paged_kv.py."""
    B, H, Dh = q.shape
    _, ps, KV, _ = kp.shape
    cap = pt.shape[1] * ps
    kf = kp[pt].reshape(B, cap, KV, Dh)
    vf = vp[pt].reshape(B, cap, KV, Dh)
    idx = np.arange(cap)
    posb = pos[:, None]
    slot_pos = ((posb - ((posb - idx[None, :]) % cap)) if rolling
                else np.broadcast_to(idx[None], (B, cap)))
    valid = (slot_pos >= 0) & (slot_pos <= posb)
    qg = q.reshape(B, KV, H // KV, Dh)
    s = np.einsum("bkgd,bskd->bkgs", qg, kf) / math.sqrt(Dh)
    s = np.where(valid[:, None, None, :], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bkgs,bskd->bkgd", p, vf).reshape(B, H, Dh)


def _paged_inputs(case):
    if case == "gqa":          # tests/test_paged_kv.py:596-613
        rng = np.random.RandomState(0)
        B, H, KV, Dh, ps, P, NP = 3, 8, 2, 16, 4, 3, 12
        q = rng.randn(B, H, Dh).astype(np.float32)
        kp = rng.randn(NP, ps, KV, Dh).astype(np.float32)
        vp = rng.randn(NP, ps, KV, Dh).astype(np.float32)
        pt = np.stack([rng.permutation(np.arange(1, NP))[:P]
                       for _ in range(B)]).astype(np.int32)
        pos = np.asarray([0, 7, 25], np.int32)   # fresh, mid, wrapped
    else:                      # tests/test_paged_kv.py:615-628 (MQA-ish)
        rng = np.random.RandomState(1)
        B, H, KV, Dh, ps, P, NP = 2, 4, 4, 8, 4, 2, 9
        q = rng.randn(B, H, Dh).astype(np.float32)
        kp = rng.randn(NP, ps, KV, Dh).astype(np.float32)
        vp = rng.randn(NP, ps, KV, Dh).astype(np.float32)
        pt = np.asarray([[1, 2], [3, 4]], np.int32)
        pos = np.asarray([3, 6], np.int32)
    return q, kp, vp, pt, pos


@pytest.mark.parametrize("rolling", [False, True])
@pytest.mark.parametrize("case", ["gqa", "single_group"])
def test_paged_ref_matches_pallas_interpret_and_gather(case, rolling):
    q, kp, vp, pt, pos = _paged_inputs(case)
    want = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(pos), rolling=rolling, interpret=True))
    got = FA.paged_decode_attention_ref(
        *(torch.from_numpy(a) for a in (q, kp, vp, pt, pos)),
        rolling=rolling).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, _gather_ref(q, kp, vp, pt, pos,
                                                rolling), atol=1e-5)


@pytest.mark.parametrize("rolling", [False, True])
def test_paged_ref_bf16_matches_pallas_interpret(rolling):
    q, kp, vp, pt, pos = _paged_inputs("gqa")
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, kp, vp)]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)]
    want = jax_paged_decode(*jb, jnp.asarray(pt), jnp.asarray(pos),
                            rolling=rolling, interpret=True)
    got = FA.paged_decode_attention(*tb, torch.from_numpy(pt),
                                    torch.from_numpy(pos), rolling=rolling)
    # the Pallas kernel keeps P in fp32, the plain version rounds P to
    # bf16 before P.V: the bf16 tolerance covers that rounding
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["bfloat16"])
