"""The port's MLA attention (multi-head latent attention, minicpm3)
against the JAX package's `repro.models.attention`: the two latent
caches and their inits, the prefill forward (materialised k/v, with
`return_kv` and the shared-prefix extend), the absorbed-latent decode
over the dense cache (per-slot and shared position) and over the page
arena, the multi-token verify over both, and the model's fused prefill
and decode through the dense rows and the paged arena (with a prefix
gathered back out of the arena). Params are the reduced minicpm3's,
carried across through numpy; caches and inputs come from numpy
seeds; compute is fp32 on both sides.

Tolerance: 1e-5 absolute on the building blocks and 1e-4 on logits
after two layers (test_torch_model.py's) — the same fp32 arithmetic
through different matmul kernels, summation order only.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_reduced as jax_reduced
from repro.engine.serving import slots as JS
from repro.models import attention as JA
from repro.models import build_model as jax_build
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.engine.serving import slots as TS
from repro_torch.models import attention as TA
from repro_torch.models import build_model

ARCH = "minicpm3-4b"
ATOL, LOGIT_ATOL = 1e-5, 1e-4
B, CAP, PS = 3, 16, 4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread in this process: the reduced models' ops gain
    nothing from more, and in a run of several test workers the extra
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models():
    jm = jax_build(jax_reduced(ARCH), compute_dtype=jnp.float32,
                   attn_chunk=8)
    tm = build_model(get_reduced(ARCH), compute_dtype=torch.float32,
                     attn_chunk=8)
    jp = jax.jit(jm.init)(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                           cfg=tm.cfg)
    return jm, tm, jp, tp


def _jit(fn, *static):
    """A reference function jitted with its config (and dtype) static:
    eager JAX compiles each op on its own, which takes longer here."""
    return jax.jit(fn, static_argnums=static)


def _attn():
    """Layer 0's MLA params on both sides."""
    jm, tm, jp, tp = _models()
    ja = jax.tree.map(lambda x: x[0], jp["blocks"]["attn"])
    ta = params_from_numpy(jax.tree.map(np.asarray, ja), device="cpu")
    return jm.cfg, tm.cfg, ja, ta


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


def _latents(rng, n, cfg):
    return (rng.randn(n, CAP if n == B else PS, cfg.kv_lora_rank)
            .astype(np.float32),
            rng.randn(n, CAP if n == B else PS, cfg.qk_rope_head_dim)
            .astype(np.float32))


def _caches(kind, rng, cfg, pos):
    """(JAX cache, port cache) of one layer holding the same random rows:
    dense [B, CAP, ·] or a shuffled page arena with the trash page."""
    if kind == "dense":
        c, r = _latents(rng, B, cfg)
        return (JA.MLACache(jnp.asarray(c), jnp.asarray(r), jnp.asarray(pos)),
                TA.MLACache(torch.tensor(c), torch.tensor(r),
                            torch.tensor(pos)))
    NP = B * CAP // PS + 1
    c, r = _latents(rng, NP, cfg)
    table = (rng.permutation(NP - 1) + 1).reshape(B, CAP // PS).astype(
        np.int32)
    return (JA.PagedMLACache(jnp.asarray(c), jnp.asarray(r),
                             jnp.asarray(table), jnp.asarray(pos)),
            TA.PagedMLACache(torch.tensor(c), torch.tensor(r),
                             torch.tensor(table), torch.tensor(pos)))


# ----------------------------------------------------------------- caches
@pytest.mark.parametrize("per_slot", [False, True])
def test_cache_inits_match_reference(per_slot):
    jcfg, tcfg, _, _ = _attn()
    j = JA.init_mla_cache(jcfg, B, CAP, jnp.float32, per_slot)
    t = TA.init_mla_cache(tcfg, B, CAP, torch.float32, "cpu", per_slot)
    jp = JA.init_paged_mla_cache(jcfg, B, CAP, PS, 9, jnp.float32)
    tp = TA.init_paged_mla_cache(tcfg, B, CAP, PS, 9, torch.float32, "cpu")
    for tc, jc in ((t, j), (tp, jp)):
        assert type(tc).__name__ == type(jc).__name__
        assert tc._fields == jc._fields
        for a, b in zip(tc, jc):
            assert tuple(a.shape) == b.shape and not a.any()


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("case", ["plain", "return_kv", "prefix"])
def test_mla_forward_matches_reference(case):
    jcfg, tcfg, ja, ta = _attn()
    rng = np.random.RandomState(1)
    T, S0 = 12, 8
    x = rng.randn(2, T, jcfg.d_model).astype(np.float32)
    kw_j, kw_t = {}, {}
    start = S0 if case == "prefix" else 0
    pos = np.arange(start, start + T, dtype=np.float32)
    if case == "prefix":                 # one shared prefix for the group
        c, r = (rng.randn(1, S0, n).astype(np.float32)
                for n in (jcfg.kv_lora_rank, jcfg.qk_rope_head_dim))
        kw_j["prefix_kv"] = (jnp.asarray(c), jnp.asarray(r))
        kw_t["prefix_kv"] = (torch.tensor(c), torch.tensor(r))
    rk = case == "return_kv"
    jo = jax.jit(JA.mla_forward, static_argnums=(1, 4, 5),
                 static_argnames=("return_kv",))(
        ja, jcfg, jnp.asarray(x), jnp.asarray(pos), jnp.float32, 8,
        return_kv=rk, **kw_j)
    to = TA.mla_forward(ta, tcfg, torch.tensor(x), torch.tensor(pos),
                        torch.float32, return_kv=rk, attn_chunk=5, **kw_t)
    if rk:
        (jo, (jc, jr)), (to, (tc, tr)) = jo, to
        _close(tc, jc)
        _close(tr, jr)
    _close(to, jo)


# ----------------------------------------------------------------- decode
@pytest.mark.parametrize("case", ["shared_pos", "per_slot", "paged"])
def test_mla_decode_step_matches_reference(case):
    jcfg, tcfg, ja, ta = _attn()
    rng = np.random.RandomState(2)
    x = rng.randn(B, 1, jcfg.d_model).astype(np.float32)
    pos = (np.int32(6) if case == "shared_pos"
           else np.asarray([0, 9, CAP - 1], np.int32))
    jc, tc = _caches("paged" if case == "paged" else "dense", rng, jcfg, pos)
    if case == "paged":
        jo, jc = _jit(JA.mla_paged_decode_step, 1, 4)(
            ja, jcfg, jnp.asarray(x), jc, jnp.float32)
        to, tc = TA.mla_paged_decode_step(ta, tcfg, torch.tensor(x), tc,
                                          torch.float32)
        np.testing.assert_array_equal(tc.page_table.numpy(),
                                      np.asarray(jc.page_table))
    else:
        jo, jc = _jit(JA.mla_decode_step, 1, 4)(
            ja, jcfg, jnp.asarray(x), jc, jnp.float32)
        to, tc = TA.mla_decode_step(ta, tcfg, torch.tensor(x), tc,
                                    torch.float32)
    _close(to, jo)
    _close(tc.c_kv, jc.c_kv)
    _close(tc.k_rope, jc.k_rope)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_mla_verify_step_matches_reference(layout):
    jcfg, tcfg, ja, ta = _attn()
    rng = np.random.RandomState(3)
    T = 4
    x = rng.randn(B, T, jcfg.d_model).astype(np.float32)
    pos = np.asarray([0, 5, CAP - T], np.int32)      # pos + T - 1 < CAP
    jc, tc = _caches(layout, rng, jcfg, pos)
    jfn, tfn = ((JA.mla_paged_verify_step, TA.mla_paged_verify_step)
                if layout == "paged" else
                (JA.mla_verify_step, TA.mla_verify_step))
    jo, jc = _jit(jfn, 1, 4)(ja, jcfg, jnp.asarray(x), jc, jnp.float32)
    to, tc = tfn(ta, tcfg, torch.tensor(x), tc, torch.float32)
    _close(to, jo)
    _close(tc.c_kv, jc.c_kv)
    _close(tc.k_rope, jc.k_rope)
    np.testing.assert_array_equal(tc.pos.numpy(), pos)      # unchanged


# ------------------------------------------- the model through both layouts
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_extend_and_decode_match_reference(layout):
    """The fused prefill of a prefix, its rows admitted into the cache
    (a dense row scatter, or pages), then — paged — the prefix gathered
    back out of the arena and a group's tails prefilled on it (extend),
    and three decode steps over the cache; logits, latent rows and
    positions on both sides."""
    jm, tm, jp, tp = _models()
    max_len, V = CAP * 2, jm.cfg.vocab_size
    jprefill = jax.jit(jm.prefill_cache, static_argnums=(3,),
                       static_argnames=("prefix_len",))
    jdecode = jax.jit(jm.decode_step)
    rng = np.random.RandomState(4)
    n = 2
    pfx = rng.randint(0, V, (1, 8)).astype(np.int32)
    tails = rng.randint(0, V, (n, 8)).astype(np.int32)
    lens = np.asarray([8, 5], np.int32)
    paged = layout == "paged"
    if paged:
        pps = max_len // PS
        NP = (n + 1) * pps + 1
        jc = jm.init_cache(jp, n + 1, max_len, per_slot=True,
                           paged=(PS, NP))
        tc = tm.init_cache(tp, n + 1, max_len, paged=(PS, NP))
        tables = np.arange((n + 1) * pps, dtype=np.int32).reshape(
            n + 1, pps) + 1
        # slot 0 holds the prefix; slots 1.. share its two pages
        _, jr = jprefill(jp, jnp.asarray(pfx), jnp.asarray([8]),
                                 max_len)
        _, tr = tm.prefill_cache(tp, torch.tensor(pfx), torch.tensor([8]),
                                 max_len)
        jc = JS.paged_insert_rows(jc, jr, jnp.asarray([0]),
                                  jnp.asarray(tables[:1]),
                                  jnp.asarray(tables[:1]))
        tc = TS.paged_insert_rows(tc, tr, torch.tensor([0]),
                                  torch.tensor(tables[:1]),
                                  torch.tensor(tables[:1]))
        pages = tables[0, :2]
        jpk = JS.gather_prefix(jc, jnp.asarray(pages))
        tpk = TS.gather_prefix(tc, torch.tensor(pages))
        _close(tpk.layers["attn"][0], jpk.layers["attn"][0])
        jl, jr = jprefill(jp, jnp.asarray(tails), jnp.asarray(lens),
                                  max_len, prefix_kv=jpk, prefix_len=8)
        tl, tr = tm.prefill_cache(tp, torch.tensor(tails), torch.tensor(lens),
                                  max_len, prefix_kv=tpk, prefix_len=8)
        new = tables[1:].copy()
        new[:, :2] = pages
        write = np.where(np.arange(pps) < 2, 0, new).astype(np.int32)
        slots = np.arange(1, n + 1)
        jc = JS.paged_insert_rows(jc, jr, jnp.asarray(slots),
                                  jnp.asarray(write), jnp.asarray(new))
        tc = TS.paged_insert_rows(tc, tr, torch.tensor(slots),
                                  torch.tensor(write), torch.tensor(new))
    else:
        full = np.concatenate([np.repeat(pfx, n, 0), tails], 1)
        jl, jr = jprefill(jp, jnp.asarray(full),
                                  jnp.asarray(lens + 8), max_len)
        tl, tr = tm.prefill_cache(tp, torch.tensor(full),
                                  torch.tensor(lens + 8), max_len)
        jc = jm.init_cache(jp, n, max_len, per_slot=True)
        tc = tm.init_cache(tp, n, max_len, per_slot=True)
        jc = JS.insert_rows_at(jc, jr, jnp.arange(n))
        tc = TS.insert_rows_at(tc, tr, torch.arange(n))
    _close(tl, jl, LOGIT_ATOL)
    for tf, jf in zip(tr.layers["attn"], jr.layers["attn"]):
        _close(tf, jf)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)
    if paged:                                    # slot 0 decodes garbage
        nxt = np.concatenate([[0], nxt])
    for _ in range(3):
        jlog, jc = jdecode(jp, jnp.asarray(nxt[:, None]), jc)
        tlog, tc = tm.decode_step(tp, torch.tensor(nxt[:, None]), tc)
        _close(tlog, jlog, LOGIT_ATOL)
        nxt = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)
    for tf, jf in zip(tc.layers["attn"], jc.layers["attn"]):
        _close(tf, jf)
    assert type(tc.layers["attn"]).__name__ == (
        "PagedMLACache" if paged else "MLACache")
