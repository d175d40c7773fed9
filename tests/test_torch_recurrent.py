"""The recurrent and frontend families end to end in the port — rwkv6-7b
(SSM), hymba-1.5b (hybrid: GQA with a sliding window beside mamba
heads), llava-next-34b (vision frontend) and seamless-m4t-large-v2
(encoder-decoder) — against the JAX package on their reduced presets:
the serving engine's greedy tokens and stats on both KV layouts, with
admission groups of unequal prompts; the scan prefill keeping an ended
slot's state; the dense-fallback and speculation warnings; the engine's
refusal of frontend and encoder-decoder models and `ServeSession`'s
stepped loop for them; hot-reload across recurrent state; checkpoints
crossing between the packages; one Adasum step per preset through
`TrainSession`; an RVH step across two gloo ranks; and the entry
points. Params cross through numpy; inputs come from numpy seeds;
compute is fp32 on both sides.

Tolerances, with their reasons:
  * engines and the stepped loop: tokens and stats equal;
  * the training step: test_torch_train.py's (losses 1e-4, params 1e-5
    absolute, CombineStats rtol 1e-3).
"""
import re
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_reduced as jax_reduced
from repro.engine import EngineConfig as JEC
from repro.engine import ServeEngine as JEngine
from repro.engine import ServeSession as JServeSession
from repro.models import build_model as jax_build
from repro_torch import tree as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.data import pipeline as TP
from repro_torch.engine import (EngineConfig, GenerationRequest, ServeEngine,
                                ServeSession, TrainSession)
from repro_torch.engine.build import EngineWarning
from repro_torch.engine.serving.engine import _make_scan_prefill
from repro_torch.models import build_model
from repro_torch.models.transformer import ATTN_CACHES, cache_nodes

from test_torch_serve_ext import STAT_KEYS, run

RWKV, HYMBA = "rwkv6-7b", "hymba-1.5b"
LLAVA, SEAMLESS = "llava-next-34b", "seamless-m4t-large-v2"
ARCHS = (RWKV, HYMBA, LLAVA, SEAMLESS)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE = {}


def _models(arch):
    if arch not in _CACHE:
        cfg = get_reduced(arch)
        jm = jax_build(jax_reduced(arch), compute_dtype=jnp.float32,
                       attn_chunk=16)
        tm = build_model(cfg, compute_dtype=torch.float32, attn_chunk=16)
        jp = jm.init(jax.random.key(0))
        _CACHE[arch] = jm, tm, jp, _to_port(jp, cfg)
    return _CACHE[arch]


def _to_port(jp, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                             cfg=cfg)


def _workload(V, seed=0):
    """Three prompts of one bucket (16) but unequal lengths — one
    admission group when they arrive together — then two longer ones
    (bucket 32; the 40-token prompt crosses hymba's 32-token window)."""
    rng = np.random.RandomState(seed)
    return [dict(prompt=rng.randint(0, V, p), max_new_tokens=g)
            for p, g in ((9, 6), (13, 8), (16, 5), (25, 6), (40, 4))]


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", EngineWarning)
        warnings.simplefilter("ignore", UserWarning)
        return fn()


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("arch,layout,stagger", [
    (RWKV, "dense", 0), (RWKV, "paged", 1), (HYMBA, "paged", 0),
    (HYMBA, "paged", 1), (HYMBA, "dense", 0)])
def test_engine_tokens_match_jax_engine(arch, layout, stagger):
    """Greedy tokens, stats and the dense-fallback accounting equal to
    the JAX engine's. stagger 0 admits the first three prompts as one
    scan-prefill group of unequal lengths (9, 13, 16): the shorter ones'
    states must stop at their own last token."""
    jm, tm, jp, tp = _models(arch)
    reqs = _workload(tm.cfg.vocab_size)
    cfg = dict(max_slots=3, max_len=64, page_size=4, kv_layout=layout)
    je = _quiet(lambda: JEngine(JEC(**cfg), jm, None, jp))
    te = _quiet(lambda: ServeEngine(EngineConfig(**cfg), tm, tp))
    jh, th = run(je, reqs, stagger), run(te, reqs, stagger)
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    for k in STAT_KEYS:
        assert te.stats[k] == je.stats[k], k
    tk, jk = te.kv_stats(), je.kv_stats()
    for k in ("kv_layout", "dense_fallback_leaves", "dense_fallback_bytes",
              "kv_capacity_bytes"):
        assert tk[k] == jk[k], k
    assert te.prefill_mode == "scan"
    assert te.leaked_pages() == 0


@pytest.mark.parametrize("arch", [RWKV, HYMBA])
def test_scan_prefill_keeps_ended_slots_bitwise(arch):
    """A slot whose prompt has ended keeps its cache through the rest of
    its group's prefill: each slot's states, positions and attention
    rows below its length equal bitwise those of the same prefill cut at
    that slot's own length. (The row at an ended slot's pos is masked:
    the group's later steps write there, and the slot's next decode
    overwrites it.)"""
    _, tm, _, tp = _models(arch)
    rng = np.random.RandomState(3)
    lengths = [3, 8, 5]
    toks = torch.from_numpy(rng.randint(0, tm.cfg.vocab_size, (3, 8)))
    prefill = _make_scan_prefill(tm, 16)
    with torch.no_grad():
        _, full = prefill(tp, toks, torch.tensor(lengths))
        for b, n in enumerate(lengths):
            cut = torch.tensor([min(x, n) for x in lengths])
            _, part = prefill(tp, toks[:, :n], cut)
            for x, y in zip(cache_nodes(full), cache_nodes(part)):
                rows = isinstance(x, ATTN_CACHES)
                for i, (a, c) in enumerate(zip(x, y)):
                    a, c = a[:, b], c[:, b]
                    if rows and i < len(x) - 1:
                        a, c = a[:, :n], c[:, :n]
                    assert torch.equal(a, c), (b, type(x).__name__, i)


def test_fallback_and_speculation_warnings():
    """rwkv under kv_layout='paged' serves dense, loudly; hymba's mamba
    state stays dense beside its paged attention, loudly, counted in
    kv_stats; speculation on either is disabled with the reference's
    warning and every tick runs plain decode."""
    for arch, match, leaves in ((RWKV, "has no attention K/V to page", 4),
                                (HYMBA, r"3 cache leaves \(\d+ bytes\) stay "
                                 r"dense", 3)):
        _, tm, _, tp = _models(arch)
        for k in (0, 2):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                eng = ServeEngine(EngineConfig(max_slots=2, max_len=32,
                                               page_size=4, speculation_k=k),
                                  tm, tp)
            msgs = [str(w.message) for w in caught
                    if issubclass(w.category, EngineWarning)]
            assert len(msgs) == 1 + (k > 0), msgs
            assert re.search(match, msgs[0])
            assert (k > 0) == any("speculation disabled" in m for m in msgs)
            assert eng.kv_stats()["dense_fallback_leaves"] == leaves
            assert eng.spec_k == 0
        run(eng, _workload(tm.cfg.vocab_size)[:2])
        assert eng.stats["spec_ticks"] == 0
        assert eng.stats["completed"] == 2


@pytest.mark.parametrize("arch", [LLAVA, SEAMLESS])
def test_engine_refuses_frontend_models(arch):
    _, tm, _, tp = _models(arch)
    with pytest.raises(ValueError, match="ServeEngine serves decoder-only"):
        ServeEngine(EngineConfig(max_slots=2, max_len=32), tm, tp)


@pytest.mark.parametrize("arch", [LLAVA, SEAMLESS])
def test_session_stepped_tokens_match_reference(arch):
    """`ServeSession.generate` with the stub's embeddings takes the
    stepped loop: tokens equal the reference's. llava's patches are not
    fed to the decode cache, in the reference's loop as in the port's, so
    its tokens do not depend on them; seamless's cache is built from its
    frames, so its tokens do."""
    jm, tm, jp, tp = _models(arch)
    cfg = tm.cfg
    rng = np.random.RandomState(4)
    prompts = rng.randint(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    S = cfg.frontend_tokens or 10
    fe = [(0.5 * rng.standard_normal((2, S, cfg.frontend_dim))
           ).astype(np.float32) for _ in range(2)]
    jss = JServeSession.from_config(JEC(max_len=32), model=jm, params=jp)
    tss = ServeSession(EngineConfig(max_len=32), tm, tp)
    outs = []
    for f in fe:
        want = np.asarray(jss.generate(jnp.asarray(prompts), 6,
                                       frontend_embeds=jnp.asarray(f)))
        got = tss.generate(prompts, 6, frontend_embeds=f).numpy()
        np.testing.assert_array_equal(got, want)
        outs.append(got)
    assert (outs[0] == outs[1]).all() == (arch == LLAVA)


@pytest.mark.parametrize("arch,layout", [(HYMBA, "paged"), (HYMBA, "dense"),
                                         (RWKV, "dense")])
def test_hot_reload_keeps_recurrent_state_per_version(arch, layout):
    """A transition tick (slots of two param versions decode in one
    tick, one pass a version): each request's tokens equal an engine
    serving its pinned version alone — its recurrent state is its own
    version's."""
    jm, tm, jp, tp = _models(arch)
    new = _to_port(jm.init(jax.random.key(7)), tm.cfg)
    reqs = _workload(tm.cfg.vocab_size, seed=2)[3:]
    cfg = dict(max_slots=2, max_len=64, page_size=4, kv_layout=layout)
    eng = _quiet(lambda: ServeEngine(EngineConfig(**cfg), tm, tp))
    h_old = eng.submit(GenerationRequest(**reqs[0]))
    eng.step()
    eng.swap_params(new)
    h_new = eng.submit(GenerationRequest(**reqs[1]))
    eng.drain()
    assert eng.stats["transition_ticks"] >= 1
    for params, r, h in ((tp, reqs[0], h_old), (new, reqs[1], h_new)):
        solo = _quiet(lambda: ServeEngine(EngineConfig(**cfg), tm, params))
        assert run(solo, [r])[0].tokens == h.tokens


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_crosses_both_ways(arch, tmp_path):
    """A reference checkpoint of each family restores into the port bit
    for bit, and the port's restores in the reference."""
    from repro.checkpoint import CheckpointManager as JCM
    from repro_torch.checkpoint import CheckpointManager
    jm, tm, jp, tp = _models(arch)
    JCM(str(tmp_path / "ref")).save(2, {"params": jp})
    like = {"params": T.map(torch.zeros_like, tp)}
    got = CheckpointManager(str(tmp_path / "ref")).restore(like, 2)
    for a, b in zip(T.leaves(got["params"]), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    CheckpointManager(str(tmp_path / "port")).save(2, got)
    back = JCM(str(tmp_path / "port")).restore_params(jp, 2)
    for a, b in zip(jax.tree.leaves(back), T.leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# --------------------------------------------------------------- training
def _batch(arch):
    from test_torch_train import BATCH, SEQ
    src = TP.SyntheticLM(TP.DataConfig(seq_len=SEQ, global_batch=BATCH,
                                       vocab_size=get_reduced(arch).vocab_size,
                                       seed=3), get_reduced(arch))
    return src.batch(0)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_composition(arch):
    """One Adasum step (span 2, momentum) through `TrainSession` against
    the reference's sync_step composed from its own functions without a
    mesh (tests/test_torch_train.py's `_jax_trajectory`), on batches
    carrying the stub's embeddings where the preset has a frontend."""
    from repro_torch.control.noise import STAT_KEYS as STATS
    from test_torch_train import (BATCH, LR, SEQ, _jax_trajectory,
                                  _params_close)
    tm = _models(arch)[1]
    batch = _batch(arch)
    assert ("frontend_embeds" in batch) == (arch in (LLAVA, SEAMLESS))
    want_l, want_s, want_p = _jax_trajectory(arch, [batch], 2, "momentum")
    s = TrainSession.from_config(
        EngineConfig(arch=arch, reduced=True, span=2, backend="gspmd_tree",
                     optimizer="momentum", lr=LR, seq_len=SEQ,
                     global_batch=BATCH, log_every=10 ** 6),
        model=tm, device="cpu", callbacks=[])
    with torch.no_grad():
        for dst, src in zip(T.leaves(s.state["params"]),
                            T.leaves(_models(arch)[3])):
            dst.copy_(src)
    m = s.step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert s.runtime.combine_path.startswith("gspmd")
    np.testing.assert_allclose(float(m["loss"]), want_l[0], atol=1e-4)
    for k in STATS:
        np.testing.assert_allclose(float(m[k]), want_s[0][k], rtol=1e-3,
                                   atol=1e-9, err_msg=k)
    _params_close(T.leaves(s.state["params"]), jax.tree.leaves(want_p),
                  "momentum")


def test_rvh_step_on_two_gloo_ranks(tmp_path):
    """rwkv-reduced, one lane a rank, RVH across two gloo ranks: the
    reference's span-2 composition within test_torch_train.py's
    tolerances, params bitwise equal across the ranks."""
    from test_torch_train import LR, _jax_trajectory
    from torch_dist_workers import launch
    jm, tm, jp, tp = _models(RWKV)
    batch = _batch(RWKV)
    want_l, _, want_p = _jax_trajectory(RWKV, [batch], 2, "momentum")
    inputs = {"init/" + "/".join(k.key for k in p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    inputs.update({f"batch0/{k}": v for k, v in batch.items()})
    np.savez(tmp_path / "inputs.npz", **inputs)
    ranks = launch(2, "train", {
        "inputs": str(tmp_path / "inputs.npz"), "arch": RWKV,
        "attn_chunk": 16, "cases": [{"policy": dict(
            span=0, backend="rvh", optimizer="momentum"), "lr": LR,
            "steps": 1}]}, tmp_path)
    for r in ranks:
        (case,) = r
        assert case["path"] == "rvh" and case["bitwise"] == [True]
        np.testing.assert_allclose(case["losses"][0], want_l[0], atol=1e-4)
        for (path, w), g in zip(
                jax.tree_util.tree_flatten_with_path(want_p)[0],
                T.leaves(case["params"])):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0,
                                       err_msg=str(path))


# ----------------------------------------------------------- entry points
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_the_arch(arch, capsys):
    """rwkv and hymba through the engine (rwkv falls back to the dense
    layout); llava and seamless through the stepped loop, as the
    reference's CLI serves them."""
    from repro_torch.launch import serve
    _quiet(lambda: serve.main(["--device", "cpu", "--arch", arch,
                               "--reduced", "--requests", "2",
                               "--prompt-len", "8", "--gen", "4",
                               "--max-slots", "2"]))
    out = capsys.readouterr().out
    if arch in (LLAVA, SEAMLESS):
        assert "serve through the stepped batch path" in out
        assert "[serve] legacy completed=2" in out
    else:
        assert "completed=2" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_the_arch(arch, capsys):
    """Under each preset (llava's: span 4 and 4 accumulation steps, so a
    batch of 16 gives each microbatch one row)."""
    from repro_torch.launch.train import main
    _quiet(lambda: main(["--device", "cpu", "--arch", arch, "--reduced",
                         "--steps", "1", "--seq", "16", "--batch", "16"]))
    assert "[train] done: final loss" in capsys.readouterr().out
