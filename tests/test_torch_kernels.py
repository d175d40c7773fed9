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


# ------------------------------------------------ split-K paged decode plan
# (B, KV, P, SMs): the serve tick, one slot with every page, a batch that
# fills the card, a single page, more splits wanted than pages, gemma G=1
PLAN_CASES = [(4, 8, 128, 132), (1, 8, 128, 132), (32, 8, 16, 132),
              (2, 2, 1, 132), (1, 1, 3, 132), (4, 16, 128, 132),
              (3, 2, 7, 16), (16, 8, 64, 132)]


@pytest.mark.parametrize("B,KV,P,sms", PLAN_CASES)
def test_decode_plan_covers_every_page_once(B, KV, P, sms):
    nsplit, pps = FA.decode_plan(B, KV, P, sms)
    assert nsplit >= 1 and pps >= 1
    covered = []
    for s in range(nsplit):
        pages = range(s * pps, min((s + 1) * pps, P))
        assert len(pages) > 0, "a split past the last page"
        covered += list(pages)
    assert covered == list(range(P))
    if B * KV >= sms:
        assert (nsplit, pps) == (1, P)
    else:   # enough blocks for the card where the pages allow it
        assert B * KV * nsplit >= min(sms, B * KV * P)
    G, Dh = 8, 128
    acc, ml = FA.decode_workspace_shapes(B, KV, G, Dh, nsplit)
    assert acc == (B, KV, nsplit, G, Dh) and ml == (B, KV, nsplit, G, 2)


def test_decode_plan_one_split_at_large_batch():
    assert FA.decode_plan(32, 8, 16, 132) == (1, 16)
    assert FA.decode_plan(132, 1, 512, 132) == (1, 512)
    nsplit, pps = FA.decode_plan(4, 8, 128, 132)   # the serve tick
    assert nsplit > 1 and 4 * 8 * nsplit >= 2 * 132


# ------------------------------------- split-K paged decode, modelled on CPU
def _split_k_model(q, kp, vp, pt, pos, rolling, nsplit, pps):
    """Pass 1 and pass 2 of the CUDA split-K decode in float64 numpy:
    per (slot, KV head, split) a partial (m, l, acc) over the split's
    pages, NEG_INF/0 for a split wholly past pos; then the fixed-order
    log-sum-exp merge that gives empty splits weight 0."""
    B, H, Dh = q.shape
    _, ps, KV, _ = kp.shape
    P = pt.shape[1]
    G, cap = H // KV, P * ps
    out = np.zeros((B, H, Dh))
    for b in range(B):
        p = int(pos[b])
        n_pages = p // ps + 1 if p < cap else P
        for kv in range(KV):
            qg = q[b, kv * G:(kv + 1) * G].astype(np.float64) / math.sqrt(Dh)
            parts = []
            for s in range(nsplit):
                pg0, pg1 = s * pps, min((s + 1) * pps, n_pages)
                if pg1 <= pg0:
                    parts.append((np.full(G, -1e30), np.zeros(G), None))
                    continue
                rows = np.arange(pg0 * ps, pg1 * ps)
                k = kp[pt[b, rows // ps], rows % ps, kv].astype(np.float64)
                v = vp[pt[b, rows // ps], rows % ps, kv].astype(np.float64)
                spos = p - (p - rows) % cap if rolling else rows
                sc = np.where((spos >= 0) & (spos <= p), qg @ k.T, -np.inf)
                m = sc.max(axis=1)
                e = np.exp(sc - m[:, None])
                parts.append((m, e.sum(axis=1), e @ v))
            M = np.max([m for m, l, _ in parts if l[0] > 0], axis=0)
            L, A = np.zeros(G), np.zeros((G, Dh))
            for m, l, acc in parts:            # split order, no atomics
                if l[0] > 0:
                    f = np.exp(m - M)
                    L += f * l
                    A += f[:, None] * acc
            out[b, kv * G:(kv + 1) * G] = A / L[:, None]
    return out


def _edge_inputs():
    """Split-K's edge cases on one arena: pos 0, pos on the last row of a
    two-page split and on the first row of the next, every page live,
    and a free slot whose table points at trash page 0."""
    rng = np.random.RandomState(5)
    B, H, KV, Dh, ps, P = 5, 4, 2, 16, 4, 4
    NP = 1 + B * P
    q = rng.randn(B, H, Dh).astype(np.float32)
    kp = rng.randn(NP, ps, KV, Dh).astype(np.float32)
    vp = rng.randn(NP, ps, KV, Dh).astype(np.float32)
    pt = (1 + rng.permutation(B * P)).reshape(B, P).astype(np.int32)
    pt[4] = 0                                   # a free slot
    pos = np.asarray([0, 7, 8, 15, 5], np.int32)
    return q, kp, vp, pt, pos


def _model_inputs(case):
    return _edge_inputs() if case == "edges" else _paged_inputs(case)


@pytest.mark.parametrize("nsplit_of", ["one", "two_pages", "per_page"])
@pytest.mark.parametrize("rolling", [False, True])
@pytest.mark.parametrize("case", ["gqa", "single_group", "edges"])
def test_split_k_model_matches_ref_and_pallas(case, rolling, nsplit_of):
    q, kp, vp, pt, pos = _model_inputs(case)
    P = pt.shape[1]
    pps = {"one": P, "two_pages": 2, "per_page": 1}[nsplit_of]
    nsplit = -(-P // pps)
    got = _split_k_model(q, kp, vp, pt, pos, rolling, nsplit, pps)
    ref = FA.paged_decode_attention_ref(
        *(torch.from_numpy(a) for a in (q, kp, vp, pt, pos)),
        rolling=rolling).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    want = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(pos), rolling=rolling, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_split_k_model_empty_splits_get_no_weight():
    """A slot at pos 0 with one page per split: every split but the
    first is empty and the output is row 0's value exactly."""
    q, kp, vp, pt, pos = _edge_inputs()
    got = _split_k_model(q, kp, vp, pt, pos, False, pt.shape[1], 1)
    G = q.shape[1] // kp.shape[2]
    for h in range(q.shape[1]):
        np.testing.assert_allclose(got[0, h], vp[pt[0, 0], 0, h // G],
                                   rtol=1e-12)
    assert np.isfinite(got).all()


# --------------------------------------------------------- wrapper refusals
def _flash_args(dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 4, 16, generator=g).to(dtype)
    k = torch.randn(1, 8, 2, 16, generator=g).to(dtype)
    return q, k, k.clone()


def _decode_args(dtype=torch.bfloat16):
    q, kp, vp, pt, pos = _paged_inputs("gqa")
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
            torch.from_numpy(vp).to(dtype), torch.from_numpy(pt),
            torch.from_numpy(pos))


REFUSALS = [(k, f) for k in ("flash", "decode")
            for f in ("float16", "mixed_dtype", "noncontig", "requires_grad")
            ] + [("decode", "int64_table")]


@pytest.mark.parametrize("kernel,fault", REFUSALS)
def test_wrappers_refuse_what_the_kernels_do_not_take(kernel, fault):
    args = list(_flash_args() if kernel == "flash" else _decode_args())
    fn = FA.flash_attention if kernel == "flash" else \
        FA.paged_decode_attention
    err = ValueError
    if fault == "float16":
        args[:3] = [a.to(torch.float16) for a in args[:3]]
    elif fault == "mixed_dtype":
        args[1] = args[1].float()
    elif fault == "noncontig":
        args[0] = args[0].transpose(-1, -2).contiguous().transpose(-1, -2)
    elif fault == "requires_grad":
        args[0] = args[0].float().requires_grad_()
        args[1:3] = [a.float() for a in args[1:3]]
        err = RuntimeError
    else:
        args[3] = args[3].long()
    with pytest.raises(err):
        fn(*args)


@pytest.mark.parametrize("Dh", [8, 48, 96, 512])
def test_kernel_inputs_refuse_uncompiled_head_dims(Dh):
    t = torch.zeros(2, 4, Dh, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        FA._check_kernel_inputs("paged_decode_attention", (t,), Dh)


def test_kernel_inputs_refuse_unaligned_storage():
    base = torch.zeros(2 * 4 * 16 + 8, dtype=torch.bfloat16)
    t = base[1:129].view(2, 4, 16)               # 2 bytes past 16-aligned
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        FA._check_kernel_inputs("flash_attention", (t,), 16)
    FA._check_kernel_inputs("flash_attention",
                            (base[8:].view(2, 4, 16),), 16)
