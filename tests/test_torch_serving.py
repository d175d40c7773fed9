"""The port's ServeEngine against the JAX package's, and its host-side
pieces.

Greedy tokens are held to equality with the JAX engine on an fp32
reduced qwen3 (params carried across by `repro_torch.bridge`), with
staggered arrivals and a shared system prompt so prefix-extend prefills
run. Sampled tokens cannot match JAX (its Gumbel noise comes from
`jax.random`); they are held to determinism inside the port and to
greedy at temperature 0. `PagePool` and `PrefixIndex` are copies of the
reference's and are driven through the same operation sequences as the
reference's classes.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced
from repro_torch.engine import (EngineConfig, GenerationRequest, ServeEngine,
                                sample_logits)
from repro_torch.engine.serving import PagePool, PrefixIndex
from repro_torch.engine.serving import slots as TS
from repro_torch import tree as T
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]


def _workload(V, n=5, system=16, seed=0):
    rng = np.random.RandomState(seed)
    sys_prompt = rng.randint(0, V, system)
    return [np.concatenate([sys_prompt, rng.randint(0, V, rng.randint(5, 20))])
            for _ in range(n)]


def _drive(engine, prompts, arrivals, **req):
    """Submit prompts in arrival groups, one tick between groups."""
    handles, i = [], 0
    for size in arrivals:
        for _ in range(size):
            handles.append(engine.submit(GenerationRequest(
                prompts[i], max_new_tokens=6, **req)))
            i += 1
        engine.step()
    engine.drain()
    return handles


def _port_engine(params=None, **kw):
    cfg = get_reduced("qwen3-32b")
    model = build_model(cfg, compute_dtype=torch.float32)
    if params is None:
        params = model.init(device="cpu")
    ecfg = EngineConfig(max_slots=kw.pop("max_slots", 3), max_len=48,
                        page_size=4, **kw)
    return ServeEngine(ecfg, model, params)


# ------------------------------------------------------ engine vs JAX
@pytest.mark.parametrize("prefix_sharing", [True, False])
def test_greedy_tokens_match_jax_engine(prefix_sharing):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs.base import get_reduced as jax_reduced
    from repro.engine import EngineConfig as JEC
    from repro.engine import GenerationRequest as JReq
    from repro.engine import ServeEngine as JEngine
    from repro.models import build_model as jax_build
    from repro_torch.bridge import params_from_numpy

    jm = jax_build(jax_reduced("qwen3-32b"), compute_dtype=jnp.float32,
                   attn_chunk=16)
    jp = jm.init(jax.random.key(0))
    jeng = JEngine(JEC(max_slots=3, max_len=48, page_size=4,
                       prefix_sharing=prefix_sharing), jm, None, jp)
    teng = _port_engine(params_from_numpy(jax.tree.map(np.asarray, jp),
                                          device="cpu"),
                        prefix_sharing=prefix_sharing)
    prompts = _workload(jm.cfg.vocab_size)
    arrivals = [1, 2, 1, 1]
    jh = []
    i = 0
    for size in arrivals:
        for _ in range(size):
            jh.append(jeng.submit(JReq(prompts[i], max_new_tokens=6)))
            i += 1
        jeng.step()
    jeng.drain()
    th = _drive(teng, prompts, arrivals)
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    jk, tk = jeng.kv_stats(), teng.kv_stats()
    for key in ("prefix_hits", "prefix_tokens_reused", "peak_kv_bytes_in_use",
                "kv_pages_used"):
        assert tk[key] == jk[key], key
    assert (tk["prefix_hits"] > 0) == prefix_sharing
    assert teng.throughput()["completed"] == len(prompts)
    assert teng.leaked_pages() == 0


def test_sampled_decode_is_deterministic_and_t0_is_greedy():
    eng = _port_engine()
    prompts = _workload(eng.model.cfg.vocab_size, n=3)
    greedy = [h.tokens for h in _drive(eng, prompts, [1, 1, 1])]
    runs = []
    for _ in range(2):
        e = _port_engine(eng.params)
        runs.append([h.tokens for h in _drive(
            e, prompts, [1, 1, 1], temperature=0.9, top_k=20, top_p=0.95,
            seed=11)])
    assert runs[0] == runs[1]
    assert runs[0] != greedy        # sampling did something
    e0 = _port_engine(eng.params)
    t0 = [h.tokens for h in _drive(e0, prompts, [1, 1, 1], temperature=0.0,
                                   seed=11)]
    assert t0 == greedy


@pytest.mark.parametrize("case", ["greedy_rows", "top_k1", "ties"])
def test_sample_logits(case):
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 50, generator=g)
    temp = [0.0, 0.7, 0.0, 1.3]
    if case == "greedy_rows":
        out = sample_logits(logits, [1, 2, 3, 4], [0] * 4, temp, [0] * 4,
                            [1.0] * 4)
        assert out[0] == logits[0].argmax() and out[2] == logits[2].argmax()
        again = sample_logits(logits, [1, 2, 3, 4], [0] * 4, temp, [0] * 4,
                              [1.0] * 4)
        assert torch.equal(out, again)
    elif case == "top_k1":
        out = sample_logits(logits, [5] * 4, [3] * 4, [1.0] * 4, [1] * 4,
                            [1.0] * 4)
        assert torch.equal(out, logits.argmax(-1).to(torch.int32))
    else:                           # first index on ties, as jnp.argmax
        flat = torch.zeros(1, 10)
        flat[0, 3] = flat[0, 7] = 1.0
        assert sample_logits(flat, [0], [0], [0.0], [0], [1.0]).item() == 3


def test_cli_serve_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "qwen3-32b", "--reduced", "--requests", "3",
         "--prompt-len", "12", "--gen", "4", "--max-slots", "2",
         "--stagger", "1", "--system-prompt", "16"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "completed=3" in res.stdout and "prefix_hits=" in res.stdout
    assert "[serve] kv layout=paged" in res.stdout


# ------------------------------------------- checkpoints and hot-reload
def _jax_engine_parts():
    jax = pytest.importorskip("jax")
    from repro.configs.base import get_reduced as jax_reduced
    from repro.models import build_model as jax_build
    jm = jax_build(jax_reduced("qwen3-32b"), compute_dtype=jax.numpy.float32,
                   attn_chunk=16)
    return jax, jm


def _save_ref_state(root, step, params):
    """A train-state checkpoint written by `repro`: params, a momentum
    state and the step counters."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import CheckpointManager as JCM
    JCM(root).save(step, {
        "params": params,
        "opt": {"inner": {"m": jax.tree.map(jnp.zeros_like, params)},
                "step": jnp.asarray(step, jnp.int32)},
        "step": jnp.asarray(step, jnp.int32)})


def _fp32_port_model():
    return build_model(get_reduced("qwen3-32b"), compute_dtype=torch.float32)


def test_serves_reference_checkpoint(tmp_path, capsys):
    """`from_config` with ckpt_dir serves the params of repro's latest
    checkpoint (params-only restore by manifest path): the reference
    engine's greedy tokens on the same params."""
    jax, jm = _jax_engine_parts()
    from repro.engine import EngineConfig as JEC
    from repro.engine import GenerationRequest as JReq
    from repro.engine import ServeEngine as JEngine
    jp = jm.init(jax.random.key(0))
    _save_ref_state(tmp_path, 5, jp)
    eng = ServeEngine.from_config(
        EngineConfig(max_slots=3, max_len=48, page_size=4,
                     ckpt_dir=str(tmp_path)),
        model=_fp32_port_model(), device="cpu")
    assert eng.loaded_step == 5
    assert "[serve] serving checkpoint step 5" in capsys.readouterr().out
    assert eng.params["embed"]["table"].dtype == torch.float32
    prompts = _workload(jm.cfg.vocab_size, n=4)
    jh = []
    jeng = JEngine(JEC(max_slots=3, max_len=48, page_size=4), jm, None, jp)
    for size in [1, 2, 1]:
        for _ in range(size):
            jh.append(jeng.submit(JReq(prompts[len(jh)], max_new_tokens=6)))
        jeng.step()
    jeng.drain()
    th = _drive(eng, prompts, [1, 2, 1])
    assert [h.tokens for h in th] == [h.tokens for h in jh]


def test_cli_serves_checkpoint_with_hot_reload(tmp_path, capsys):
    """The serve CLI's --ckpt-dir / --hot-reload (a later slice's flags
    until this one): it serves the directory's latest step and says so."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import serve
    model = build_model(get_reduced("qwen3-32b"))
    CheckpointManager(tmp_path).save(
        7, {"params": model.init(device="cpu"), "step": 7})
    handles = serve.main(["--arch", "qwen3-32b", "--reduced", "--device",
                          "cpu", "--requests", "2", "--gen", "3",
                          "--prompt-len", "8", "--ckpt-dir", str(tmp_path),
                          "--hot-reload"])
    out = capsys.readouterr().out
    assert f"serving checkpoint step 7 from {tmp_path}" in out
    assert "reloads=0" in out and "restore_fallbacks=0" in out
    assert all(h.done for h in handles)


def _drop_in(src, dst, step):
    """Land a finished step directory atomically, as a writer does."""
    import shutil
    name = f"step_{step:08d}"
    shutil.copytree(src / name, dst / (name + ".tmp"))
    os.rename(dst / (name + ".tmp"), dst / name)


def test_hot_reload_matches_reference(tmp_path):
    """tests/test_serving.py's mid-stream swap on both engines, from the
    same checkpoints: a request in flight when step 4 lands finishes on
    step 2's weights, a later one decodes on step 4's, at least one tick
    decodes two versions, and every request's tokens equal the
    reference engine's."""
    jax, jm = _jax_engine_parts()
    import jax.numpy as jnp
    from repro.engine import EngineConfig as JEC
    from repro.engine import GenerationRequest as JReq
    from repro.engine import ServeEngine as JEngine
    p2 = jm.init(jax.random.key(0))
    noise = jm.init(jax.random.key(1))
    p4 = jax.tree.map(lambda a, b: a + 0.5 * b, p2, noise)
    stage = tmp_path / "stage"
    _save_ref_state(stage, 2, p2)
    _save_ref_state(stage, 4, p4)
    rng = np.random.RandomState(3)
    V = jm.cfg.vocab_size
    prompts = [rng.randint(0, V, 6), rng.randint(0, V, 6)]
    runs = {}
    for kind in ("ref", "port"):
        root = tmp_path / kind
        root.mkdir()
        _drop_in(stage, root, 2)
        if kind == "ref":
            eng = JEngine.from_config(
                JEC(max_slots=2, max_len=40, page_size=4, ckpt_dir=str(root),
                    hot_reload=True), model=jm)
            Req = JReq
        else:
            eng = ServeEngine.from_config(
                EngineConfig(max_slots=2, max_len=40, page_size=4,
                             ckpt_dir=str(root), hot_reload=True),
                model=_fp32_port_model(), device="cpu")
            Req = GenerationRequest
        assert eng.loaded_step == 2
        h_old = eng.submit(Req(prompt=prompts[0], max_new_tokens=12))
        eng.step()                     # h_old in flight on version 0
        assert not h_old.done
        _drop_in(stage, root, 4)
        h_new = eng.submit(Req(prompt=prompts[1], max_new_tokens=4))
        eng.drain()                    # the poll swaps, then admits
        assert eng.stats["reloads"] == 1 and eng.loaded_step == 4
        assert (h_old.version, h_new.version) == (0, 1)
        assert len(h_old.tokens) == 12 and len(h_new.tokens) == 4
        runs[kind] = (eng, [h_old.tokens, h_new.tokens])
    assert runs["port"][1] == runs["ref"][1]
    assert runs["port"][0].stats["transition_ticks"] >= 1
    assert runs["port"][0].leaked_pages() == 0


def test_transition_passes_write_only_their_own_pages():
    """During a transition tick each version's decode pass may write K/V
    only into its own slots' pages (or the trash page): the arenas are
    written in place, so a write into another version's page would
    corrupt that request. Each request's tokens equal an engine serving
    its pinned version alone."""
    base = _port_engine(max_slots=2).params
    g = torch.Generator().manual_seed(5)
    new = T.map(lambda x: x + 0.5 * torch.randn(x.shape, generator=g), base)
    V = get_reduced("qwen3-32b").vocab_size
    rng = np.random.RandomState(4)
    p_old, p_new = rng.randint(0, V, 7), rng.randint(0, V, 9)

    eng = _port_engine(base, max_slots=2)
    passes = []
    decode = eng._decode

    def spy(params, toks, cache):
        k = cache.layers["attn"].k
        before = k.clone()
        out = decode(params, toks, cache)
        changed = (k != before).reshape(k.shape[0], k.shape[1], -1)
        pages = set(changed.any(-1).any(0).nonzero()[:, 0].tolist())
        v = 0 if params is base else 1
        own = set()
        for slot, h in eng.scheduler.active.items():
            if h.version == v:
                own |= set(eng._tables[slot][eng._owned[slot]].tolist())
        passes.append((v, pages, own))
        return out
    eng._decode = spy
    h_old = eng.submit(GenerationRequest(p_old, max_new_tokens=10))
    eng.step()
    eng.step()
    eng.swap_params(new)
    h_new = eng.submit(GenerationRequest(p_new, max_new_tokens=5))
    eng.drain()
    assert eng.stats["transition_ticks"] >= 1
    assert {v for v, _, _ in passes} == {0, 1}
    for v, pages, own in passes:
        assert pages <= own | {PagePool.TRASH}, (v, pages, own)
    for params, prompt, h in ((base, p_old, h_old), (new, p_new, h_new)):
        solo = _port_engine(params, max_slots=2)
        hs = solo.submit(GenerationRequest(prompt, max_new_tokens=len(
            h.tokens)))
        solo.drain()
        assert hs.tokens == h.tokens
    assert eng.leaked_pages() == 0 and len(eng._params) == 1


# ------------------------------------------------------- host pieces
def _pool_ops(Pool):
    """One op sequence through a PagePool class -> observable trace."""
    p = Pool(6, 4)
    trace = [p.alloc(2), p.pages_free]
    p.ref([trace[0][0]])
    trace.append((p.refcount(trace[0][0]), p.is_shared(trace[0][0])))
    trace.append(p.cow(trace[0][0]))
    p.release([trace[0][1]])
    trace += [p.pages_free, p.pages_used, p.alloc(10), p.alloc(3),
              p.pages_free, p.cow(trace[-1] if trace[-1] else 1)]
    return trace


def _index_ops(Index):
    """One op sequence through a PrefixIndex class -> observable trace."""
    idx = Index(4)
    a = np.arange(13, dtype=np.int32)
    b = np.concatenate([a[:8], np.arange(100, 104, dtype=np.int32)])
    trace = [idx.max_shareable(a), idx.register(a, [5, 6, 7]),
             idx.match(a), idx.match(b), idx.register(b, [5, 6, 9], start=0),
             len(idx), sorted(idx.pages()), 6 in idx]
    trace.append(idx.evict_lru(lambda pid: pid != 5))
    idx.forget(5)
    trace += [idx.match(a), len(idx), idx.evict_lru(), idx.evict_lru()]
    return trace


@pytest.mark.parametrize("which", ["pool", "index"])
def test_host_pieces_match_reference(which):
    pytest.importorskip("jax")           # repro.engine's package imports it
    from repro.engine.serving import scheduler as JS
    if which == "pool":
        from repro.engine.serving.slots import PagePool as JPool
        assert _pool_ops(PagePool) == _pool_ops(JPool)
    else:
        assert _index_ops(PrefixIndex) == _index_ops(JS.PrefixIndex)


@pytest.mark.parametrize("case", ["trash_never_alloc", "release_frees",
                                  "cow_moves_ref", "exhaustion"])
def test_page_pool(case):
    p = PagePool(4, 2)
    if case == "trash_never_alloc":
        got = p.alloc(3)
        assert PagePool.TRASH not in got and p.alloc(1) is None
    elif case == "release_frees":
        (a,) = p.alloc(1)
        p.ref([a])
        p.release([a])
        assert p.pages_used == 1
        p.release([a])
        assert p.pages_used == 0 and p.pages_free == 3
    elif case == "cow_moves_ref":
        (a,) = p.alloc(1)
        p.ref([a])
        b = p.cow(a)
        assert b != a and p.refcount(a) == 1 and p.refcount(b) == 1
    else:
        p.alloc(3)
        assert p.cow(1) is None and p.refcount(1) == 1


@pytest.mark.parametrize("case", ["chain", "no_full_page", "lru_leaf_first"])
def test_prefix_index(case):
    idx = PrefixIndex(4)
    a = np.arange(17, dtype=np.int32)
    if case == "chain":
        assert idx.register(a, [3, 4, 5, 6]) == [3, 4, 5, 6]
        assert idx.match(a[:13]) == [3, 4, 5]      # last token kept own
    elif case == "no_full_page":
        assert idx.register(a[:4], [3]) == [] and idx.match(a) == []
    else:
        idx.register(a, [3, 4])
        assert idx.evict_lru() == 4 and idx.match(a) == [3]


# -------------------------------------------------------- paged device ops
def _cache(NP=6, B=2, P=2, ps=4):
    model = build_model(get_reduced("qwen3-32b"), compute_dtype=torch.float32)
    params = model.init(device="cpu")
    cache = model.init_cache(params, B, P * ps, paged=(ps, NP))
    g = torch.Generator().manual_seed(3)
    att = cache.layers["attn"]
    att.k.copy_(torch.randn(att.k.shape, generator=g))
    att.v.copy_(torch.randn(att.v.shape, generator=g))
    return cache


@pytest.mark.parametrize("op", ["copy_pages", "set_page_tables",
                                "gather_prefix", "select_rows_paged"])
def test_paged_ops_match_reference(op):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.engine.serving import slots as JS
    from repro.models.attention import PagedKVCache as JPaged
    from repro.models.transformer import DecodeCache as JDC
    t = _cache()
    a = t.layers["attn"]
    j = JDC({"attn": JPaged(*(jnp.asarray(x.numpy()) for x in a))})
    if op == "copy_pages":
        src, dst = np.asarray([1, 2]), np.asarray([4, 5])
        got = TS.copy_pages(t, torch.from_numpy(src), torch.from_numpy(dst))
        want = JS.copy_pages(j, jnp.asarray(src), jnp.asarray(dst))
        pairs = [(got.layers["attn"].k, want.layers["attn"].k)]
    elif op == "set_page_tables":
        tab = np.asarray([[1, 2], [3, 0]], np.int32)
        got = TS.set_page_tables(t, torch.from_numpy(tab))
        want = JS.set_page_tables(j, jnp.asarray(tab))
        pairs = [(got.layers["attn"].page_table,
                  want.layers["attn"].page_table)]
    elif op == "gather_prefix":
        pages = np.asarray([3, 1])
        got = TS.gather_prefix(t, torch.from_numpy(pages))
        want = JS.gather_prefix(j, jnp.asarray(pages))
        pairs = list(zip(got.layers["attn"], want.layers["attn"]))
    else:
        sm = np.asarray([True, False])
        pm = np.asarray([False, True, False, True, False, False])
        other = _cache()
        other.layers["attn"].k.mul_(2.0)
        jo = JDC({"attn": JPaged(*(jnp.asarray(x.numpy())
                                   for x in other.layers["attn"]))})
        got = TS.select_rows_paged(torch.from_numpy(sm),
                                   torch.from_numpy(pm), other, t)
        want = JS.select_rows_paged(jnp.asarray(sm), jnp.asarray(pm), jo, j)
        pairs = list(zip(got.layers["attn"], want.layers["attn"]))
    for g_, w_ in pairs:
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


def test_engine_refuses_underprovisioned_arena():
    # below full provisioning (37 pages) the engine builds, and under
    # pressure preempts by recompute; every request still completes
    eng = _port_engine(kv_pages=20, prefix_sharing=False)
    handles = [eng.submit(GenerationRequest(p, max_new_tokens=48 - len(p)))
               for p in _workload(eng.model.cfg.vocab_size, n=3)]
    eng.drain()                     # three slots grow to 12 pages each
    assert eng.stats["preemptions"] > 0
    assert all(h.done and not h.failed for h in handles)
    assert eng.leaked_pages() == 0
    with pytest.raises(ValueError, match="cannot hold even one full slot"):
        _port_engine(kv_pages=5)
