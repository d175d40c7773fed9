"""The port's dense model against the JAX package on the reduced dense
presets: forward logits, the fused serving prefill (logits and cache
rows, plain and shared-prefix extend), and paged decode (logits and the
arena rows it writes). Params are the JAX package's, carried across by
`repro_torch.bridge` through numpy; compute is fp32 on both sides.

Tolerance: both sides run the same fp32 arithmetic through different
matmul libraries (XLA's and PyTorch's CPU kernels), which differ by
summation order only — 1e-4 absolute on logits of unit scale after two
layers, 1e-5 on the building blocks.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_reduced as jax_reduced
from repro.engine.serving.slots import gather_prefix as jax_gather_prefix
from repro.engine.serving.slots import paged_insert_rows as jax_insert
from repro.models import build_model as jax_build
from repro.models import layers as JL
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_reduced
from repro_torch.engine.serving.slots import gather_prefix, \
    paged_insert_rows
from repro_torch.models import build_model
from repro_torch.models import layers as TL

ATOL = 1e-4
CASES = {
    "qwen3": ("qwen3-32b", {}),
    "minitron": ("minitron-4b", {}),
    "gemma": ("gemma-7b", {}),
    "qwen3_swa": ("qwen3-32b", {"sliding_window": 16}),
}


@functools.lru_cache(maxsize=None)   # one init per case; params are read-only
def _models(case):
    arch, over = CASES[case]
    jcfg = dataclasses.replace(jax_reduced(arch), **over)
    tcfg = dataclasses.replace(get_reduced(arch), **over)
    jm = jax_build(jcfg, compute_dtype=jnp.float32, attn_chunk=16)
    tm = build_model(tcfg, compute_dtype=torch.float32)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                           cfg=tcfg)
    return jm, tm, jp, tp


def _batch(seed, B, P, V, lengths):
    rng = np.random.RandomState(seed)
    toks = np.zeros((B, P), np.int32)
    for b, n in enumerate(lengths):
        toks[b, :n] = rng.randint(0, V, n)
    return toks, np.asarray(lengths, np.int32)


def _close(got, want, atol=ATOL):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(g, np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=atol, rtol=0)


def test_bridge_round_trip():
    _, tm, jp, tp = _models("qwen3")
    back = params_to_numpy(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(jax.tree.leaves(back))
    for path, leaf in flat_j:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_logits(case):
    jm, tm, jp, tp = _models(case)
    toks, _ = _batch(0, 2, 24, jm.cfg.vocab_size, [24, 24])
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, torch.from_numpy(toks))
    _close(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_cache_logits_and_rows(case):
    jm, tm, jp, tp = _models(case)
    max_len = 32
    toks, lens = _batch(1, 3, 24, jm.cfg.vocab_size, [24, 17, 9])
    jl, jrows = jm.prefill_cache(jp, jnp.asarray(toks), jnp.asarray(lens),
                                 max_len)
    tl, trows = tm.prefill_cache(tp, torch.from_numpy(toks),
                                 torch.from_numpy(lens), max_len)
    _close(tl, jl)
    ja, ta = jrows.layers["attn"], trows.layers["attn"]
    assert tuple(ta.k.shape) == ja.k.shape
    _close(ta.k, ja.k)
    _close(ta.v, ja.v)
    np.testing.assert_array_equal(ta.pos.numpy(), np.asarray(ja.pos))


def _paged_pair(jm, tm, jp, tp, B, max_len, ps):
    pps = (min(max_len, jm.cfg.sliding_window) if jm.cfg.sliding_window
           else max_len) // ps
    NP = B * pps + 1
    jc = jm.init_cache(jp, B, max_len, per_slot=True, paged=(ps, NP))
    tc = tm.init_cache(tp, B, max_len, paged=(ps, NP))
    tables = (np.arange(B * pps, dtype=np.int32).reshape(B, pps) + 1)
    return jc, tc, tables


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_step_logits_and_arena(case):
    """Prefill -> paged insert -> three decode steps, both packages."""
    jm, tm, jp, tp = _models(case)
    max_len, ps, B = 32, 4, 3
    # prompts past the window exercise the rolling rows on the SWA case
    toks, lens = _batch(2, B, 24, jm.cfg.vocab_size, [24, 20, 5])
    jl, jrows = jm.prefill_cache(jp, jnp.asarray(toks), jnp.asarray(lens),
                                 max_len)
    tl, trows = tm.prefill_cache(tp, torch.from_numpy(toks),
                                 torch.from_numpy(lens), max_len)
    jc, tc, tables = _paged_pair(jm, tm, jp, tp, B, max_len, ps)
    slots = np.arange(B)
    jc = jax_insert(jc, jrows, jnp.asarray(slots), jnp.asarray(tables),
                    jnp.asarray(tables))
    tc = paged_insert_rows(tc, trows, torch.from_numpy(slots),
                           torch.from_numpy(tables),
                           torch.from_numpy(tables))
    _close(tc.layers["attn"].k, jc.layers["attn"].k)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(3):
        jlog, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        tlog, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
        _close(tlog, jlog)
        np.testing.assert_array_equal(tc.layers["attn"].pos.numpy(),
                                      np.asarray(jc.layers["attn"].pos))
        nxt = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)[:, None]
    _close(tc.layers["attn"].k, jc.layers["attn"].k)
    _close(tc.layers["attn"].v, jc.layers["attn"].v)


@pytest.mark.parametrize("case", ["qwen3", "minitron", "gemma"])
def test_prefix_extend_prefill(case):
    """Shared-prefix extend: the tail attends to a prefix gathered from
    the arena (the port's flash path with q_offset, the reference's
    `_chunked_attention`)."""
    jm, tm, jp, tp = _models(case)
    max_len, ps = 32, 4
    V = jm.cfg.vocab_size
    prefix, _ = _batch(3, 1, 8, V, [8])
    jc, tc, tables = _paged_pair(jm, tm, jp, tp, 1, max_len, ps)
    _, jrows = jm.prefill_cache(jp, jnp.asarray(prefix), jnp.asarray([8]),
                                max_len)
    _, trows = tm.prefill_cache(tp, torch.from_numpy(prefix),
                                torch.tensor([8]), max_len)
    jc = jax_insert(jc, jrows, jnp.asarray([0]), jnp.asarray(tables),
                    jnp.asarray(tables))
    tc = paged_insert_rows(tc, trows, torch.tensor([0]),
                           torch.from_numpy(tables), torch.from_numpy(tables))
    pages = tables[0, :2]                       # the 8-token prefix
    jp_kv = jax_gather_prefix(jc, jnp.asarray(pages))
    tp_kv = gather_prefix(tc, torch.from_numpy(pages))
    tail, tail_lens = _batch(5, 2, 16, V, [16, 11])
    jl, jr = jm.prefill_cache(jp, jnp.asarray(tail), jnp.asarray(tail_lens),
                              max_len, prefix_kv=jp_kv, prefix_len=8)
    tl, tr = tm.prefill_cache(tp, torch.from_numpy(tail),
                              torch.from_numpy(tail_lens), max_len,
                              prefix_kv=tp_kv, prefix_len=8)
    _close(tl, jl)
    _close(tr.layers["attn"].k, jr.layers["attn"].k)
    np.testing.assert_array_equal(tr.layers["attn"].pos.numpy(),
                                  np.asarray(jr.layers["attn"].pos))


# --------------------------------------------------------- building blocks
@pytest.mark.parametrize("fn", ["rmsnorm", "headwise_rmsnorm", "rope",
                                "swiglu", "geglu"])
def test_layers_match_reference(fn):
    rng = np.random.RandomState(9)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    s = rng.randn(16).astype(np.float32)
    tx, ts = torch.from_numpy(x), torch.from_numpy(s)
    if fn == "rmsnorm":
        _close(TL.rmsnorm({"scale": ts}, tx, 1e-5),
               JL.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), 1e-5),
               1e-5)
    elif fn == "headwise_rmsnorm":
        _close(TL.headwise_rmsnorm(ts, tx),
               JL.headwise_rmsnorm(jnp.asarray(s), jnp.asarray(x)), 1e-5)
    elif fn == "rope":
        pos = np.arange(100, 105, dtype=np.float32)
        _close(TL.apply_rope(tx, torch.from_numpy(pos)[None], 1e6),
               JL.apply_rope(jnp.asarray(x), jnp.asarray(pos)[None], 1e6),
               1e-5)
    else:
        w = {k: rng.randn(*sh).astype(np.float32) * 0.2 for k, sh in
             (("w_gate", (16, 24)), ("w_up", (16, 24)),
              ("w_down", (24, 16)))}
        _close(TL.mlp_apply({k: torch.from_numpy(v) for k, v in w.items()},
                            tx, fn, torch.float32),
               JL.mlp_apply({k: jnp.asarray(v) for k, v in w.items()},
                            jnp.asarray(x), fn, jnp.float32), 1e-5)
