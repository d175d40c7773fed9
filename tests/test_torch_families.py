"""The MLA and MoE decoders end to end in the port — minicpm3-4b (MLA),
mixtral-8x22b (MoE, sliding window) and moonshot-v1-16b-a3b (MoE with
shared experts and a dense first layer, so two block stacks and two
cache segments) — against the JAX package on their reduced presets:
forward logits, `lm_loss` with the aux loss and its gradients, one-token
decode against the forward, the serving engine's greedy tokens and
stats on both KV layouts, speculation, hot-reload across both segments,
checkpoints crossing between the packages, one Adasum training step
through `TrainSession`, an RVH step across two gloo ranks, and the
entry points. Params cross through numpy; inputs come from numpy seeds;
compute is fp32 on both sides unless a test says otherwise.

Tolerances, with their reasons:
  * logits 1e-4 absolute, loss 1e-5 (test_torch_model.py's and
    test_torch_train.py's): the same fp32 arithmetic through different
    matmul kernels, summation order only;
  * gradients: 1e-4 relative plus 1e-6 of the leaf's largest magnitude
    (at least 2e-6) absolute — the MoE experts' outputs reach ~100 (the
    reference initialises the stacked expert weights with fan-in E), so
    some gradient elements are near-cancelling sums of large terms;
  * decode against forward: the reference's own rule
    (tests/test_decode_consistency.py): rtol = atol = 0.05 on every
    position but isolated router flips (at most 5% of positions beyond
    0.1), at capacity_factor 8.0 for MoE — capacity depends on the
    number of tokens in a call, so a full-sequence and a one-token call
    drop different pairs otherwise;
  * bf16 logits: 0.1 absolute — bf16 activations through two layers,
    rounded in different orders by the two libraries;
  * engines: tokens and stats equal;
  * the training step: test_torch_train.py's (losses 1e-4, params
    1e-5 absolute, CombineStats rtol 1e-3);
  * token pins inside the port (spec == plain, hot-reload): equal
    streams backed by a logit gap wider than the rounding between the
    paths (tests/test_torch_serve_ext.py's `assert_pin`).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_reduced as jax_reduced
from repro.engine import EngineConfig as JEC
from repro.engine import ServeEngine as JEngine
from repro.engine.serving.engine import derive_draft_config as jax_derive
from repro.models import build_model as jax_build
from repro_torch import tree as T
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config, get_reduced
from repro_torch.engine import (EngineConfig, GenerationRequest, ServeEngine,
                                TrainSession)
from repro_torch.engine.serving.engine import derive_draft_config
from repro_torch.models import build_model

from test_torch_serve_ext import STAT_KEYS, assert_pin, run

ARCHS = ("minicpm3-4b", "mixtral-8x22b", "moonshot-v1-16b-a3b")
LOGIT_ATOL = 1e-4
NO_DROP = {"capacity_factor": 8.0}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread in this process: the reduced models' ops gain
    nothing from more, and in a run of several test workers the extra
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _over(arch, over):
    """Config overrides that apply to the arch (capacity only to MoE)."""
    return {k: v for k, v in over.items()
            if k != "capacity_factor" or "mini" not in arch}


@functools.lru_cache(maxsize=None)   # one init per case; params read-only
def _models(arch, capacity_factor=None):
    over = _over(arch, {} if capacity_factor is None
                 else {"capacity_factor": capacity_factor})
    jcfg = dataclasses.replace(jax_reduced(arch), **over)
    tcfg = dataclasses.replace(get_reduced(arch), **over)
    jm = jax_build(jcfg, compute_dtype=jnp.float32, attn_chunk=16)
    tm = build_model(tcfg, compute_dtype=torch.float32, attn_chunk=16)
    jp = jm.init(jax.random.key(0))
    return jm, tm, jp, _to_port(jp, tcfg)


def _to_port(jp, cfg=None):
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                             cfg=cfg)


def _tokens(seed, B, T_, V):
    return np.random.RandomState(seed).randint(0, V, (B, T_)).astype(
        np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """`lm_loss` (cross entropy + 0.01 · aux over both block stacks)
    and its gradients, with masked labels; the forward's logits."""
    jm, tm, jp, tp = _models(arch)
    toks = _tokens(0, 2, 16, jm.cfg.vocab_size)
    labels = np.roll(toks, -1, 1)
    labels[1, :4] = -100
    (jl, jmets), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    leaves, td = T.flatten(tp)
    req = [x.detach().clone().requires_grad_(True) for x in leaves]
    tl, tmets = tm.loss(T.unflatten(td, req),
                        {"tokens": torch.from_numpy(toks),
                         "labels": torch.from_numpy(labels)})
    tg = torch.autograd.grad(tl, req)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-5,
                               rtol=0)
    aux = float(tmets["aux"].detach())
    np.testing.assert_allclose(aux, float(jmets["aux"]), atol=1e-6, rtol=0)
    assert (aux > 0) == bool(tm.cfg.n_experts)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jg)[0], tg):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, err_msg=str(path),
                                   atol=max(2e-6, 1e-6 * np.abs(w).max()))
    with torch.no_grad():
        got = tm.forward(tp, torch.from_numpy(toks))
    want = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_ATOL, rtol=0)
    if "dense_blocks" in jp:
        assert T.leaves(tp["dense_blocks"])[0].shape[0] == \
            tm.cfg.first_dense_layers


def test_bf16_forward_matches_reference():
    """bf16 compute with bf16 params (mixtral's training preset) through
    the MoE blocks and the sliding window."""
    arch = "mixtral-8x22b"
    jcfg, tcfg = jax_reduced(arch), get_reduced(arch)
    jm = jax_build(jcfg, param_dtype=jnp.bfloat16, attn_chunk=16)
    tm = build_model(tcfg, param_dtype=torch.bfloat16, attn_chunk=16,
                     attn_impl="plain")
    jp = jm.init(jax.random.key(0))
    tp = _to_port(jp, tcfg)
    assert T.leaves(tp)[0].dtype == torch.bfloat16
    toks = _tokens(1, 2, 40, jcfg.vocab_size)       # past the window (32)
    want = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), atol=0.1, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """One-token decode over the per-slot cache (both segments) against
    the teacher-forced forward, under the reference's rule; and against
    the JAX package's decode, position by position."""
    jm, tm, jp, tp = _models(arch, NO_DROP["capacity_factor"])
    B, T_ = 2, 20
    toks = _tokens(2, B, T_, jm.cfg.vocab_size)
    with torch.no_grad():
        full = _np(tm.forward(tp, torch.from_numpy(toks)))
        cache = tm.init_cache(tp, B, T_ + 1, per_slot=True)
        jc = jm.init_cache(jp, B, T_ + 1, per_slot=True)
        jstep = jax.jit(jm.decode_step)
        dec = []
        for t in range(T_):
            lg, cache = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]),
                                       cache)
            jlg, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc)
            np.testing.assert_allclose(_np(lg), _np(jlg), atol=LOGIT_ATOL,
                                       rtol=0)
            dec.append(_np(lg)[:, 0])
    assert (cache.dense_layers is not None) == ("dense_blocks" in tp)
    dec = np.stack(dec, 1)
    per_pos = np.abs(dec - full).max(axis=(0, 2))
    assert (per_pos > 0.1).sum() <= max(1, int(0.05 * T_)), per_pos
    good = per_pos <= 0.1
    np.testing.assert_allclose(dec[:, good], full[:, good], rtol=0.05,
                               atol=0.05)


# ---------------------------------------------------------------- serving
def _workload(arch, V, n=4, seed=0, wrap=True):
    """Prompts with a 16-token shared system prompt (prefix sharing on
    the paged layout), or — for the sliding-window arch — prompts past
    the window (32), so prefill and decode cross the rolling wrap
    (`wrap`; else prompts that stay inside it)."""
    rng = np.random.RandomState(seed)
    if arch == "mixtral-8x22b":
        shapes = ([(40, 6), (9, 8), (33, 5), (20, 12)] if wrap else
                  [(9, 12), (14, 10), (5, 14)])[:n]
        return [dict(prompt=rng.randint(0, V, p), max_new_tokens=g)
                for p, g in shapes]
    sys_prompt = rng.randint(0, V, 16)
    return [dict(prompt=np.concatenate([sys_prompt,
                                        rng.randint(0, V, 5 + 4 * i)]),
                 max_new_tokens=6) for i in range(n)]


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax_engine(arch, layout):
    """Greedy tokens and stats equal to the JAX engine's at the default
    capacity factor: the port pads each admission group to the
    reference's bucket with the same pad id, so the pad tokens take the
    same expert slots."""
    jm, tm, jp, tp = _models(arch)
    reqs = _workload(arch, jm.cfg.vocab_size)
    cfg = dict(max_slots=3, max_len=64, page_size=4, kv_layout=layout)
    je = JEngine(JEC(**cfg), jm, None, jp)
    te = ServeEngine(EngineConfig(**cfg), tm, tp)
    jh, th = run(je, reqs), run(te, reqs)
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    for k in STAT_KEYS:
        assert te.stats[k] == je.stats[k], k
    assert te.leaked_pages() == 0
    assert te.kv_stats()["kv_capacity_bytes"] == \
        je.kv_stats()["kv_capacity_bytes"]
    if layout == "paged" and arch != "mixtral-8x22b":
        assert te.stats["prefix_hits"] > 0
    if arch == "moonshot-v1-16b-a3b":
        assert te.cache.dense_layers is not None


@pytest.mark.parametrize("spec", [None, {"n_layers": 1, "name": "d1"}])
@pytest.mark.parametrize("arch", ARCHS)
def test_derive_draft_config_matches_reference(arch, spec):
    got = derive_draft_config(get_reduced(arch), spec)
    want = jax_derive(jax_reduced(arch), spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    build_model(got)                        # the port builds every draft


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_equals_plain_tokens(arch):
    """Speculation (k=2, the derived draft) against plain decode inside
    the port, at capacity_factor 8.0: a verify forward routes B·(k+1)
    tokens where plain decode routes B, so at the default capacity the
    two could drop different pairs. The window arch's prompts stay
    inside the window: a tick speculates only while pos + k stays below
    the rolling capacity (as in the reference)."""
    jm, tm, jp, tp = _models(arch, NO_DROP["capacity_factor"])
    reqs = _workload(arch, jm.cfg.vocab_size, n=3, seed=1, wrap=False)
    streams, engines = {}, {}
    for k in (0, 2):
        eng = ServeEngine(EngineConfig(max_slots=2, max_len=64, page_size=4,
                                       speculation_k=k), tm, tp)
        streams[k] = [h.tokens for h in run(eng, reqs)]
        engines[k] = eng
    assert engines[2].stats["spec_ticks"] > 0
    assert engines[2].leaked_pages() == 0
    assert_pin(tm, tp, reqs, streams[2], streams[0])


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_hot_reload_visits_both_segments(layout):
    """A transition tick on moonshot (two cache segments): each request's
    tokens equal an engine serving its pinned version alone."""
    arch = "moonshot-v1-16b-a3b"
    jm, tm, jp, tp = _models(arch)
    new = _to_port(jm.init(jax.random.key(7)), tm.cfg)
    reqs = _workload(arch, jm.cfg.vocab_size, n=2, seed=2)
    cfg = dict(max_slots=2, max_len=64, page_size=4, kv_layout=layout)
    eng = ServeEngine(EngineConfig(**cfg), tm, tp)
    h_old = eng.submit(GenerationRequest(**reqs[0]))
    eng.step()
    eng.swap_params(new)
    h_new = eng.submit(GenerationRequest(**reqs[1]))
    eng.drain()
    assert eng.stats["transition_ticks"] >= 1
    for params, r, h in ((tp, reqs[0], h_old), (new, reqs[1], h_new)):
        solo = ServeEngine(EngineConfig(**cfg), tm, params)
        assert run(solo, [r])[0].tokens == h.tokens


# ------------------------------------------------------------ checkpoints
def test_moonshot_checkpoint_crosses_both_ways(tmp_path):
    """fp32 moonshot params, `dense_blocks` included: a reference
    checkpoint restores into the port bit for bit and, re-saved by the
    port, gives the reference's manifest entry for entry; the port's
    checkpoint validates and restores in the reference."""
    from repro.checkpoint import CheckpointManager as JCM
    from repro_torch.checkpoint import CheckpointManager
    arch = "moonshot-v1-16b-a3b"
    jm, tm, jp, tp = _models(arch)
    JCM(str(tmp_path / "ref")).save(3, {"params": jp})
    like = {"params": T.map(torch.zeros_like, tp)}
    got = CheckpointManager(str(tmp_path / "ref")).restore(like, 3)
    for a, b in zip(T.leaves(got["params"]), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    CheckpointManager(str(tmp_path / "port")).save(3, got)
    import json
    man = [json.loads((tmp_path / d / "step_00000003" / "manifest.json")
                      .read_text())["leaves"] for d in ("ref", "port")]
    keys = ("file", "path", "shape", "dtype", "crc32")
    assert [[e[k] for k in keys] for e in man[1]] == \
        [[e[k] for k in keys] for e in man[0]]
    assert any("['dense_blocks']" in e["path"] for e in man[1])
    back = JCM(str(tmp_path / "port")).restore_params(jp, 3)
    for a, b in zip(jax.tree.leaves(back), T.leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# --------------------------------------------------------------- training
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_composition(arch):
    """One Adasum step (span 2, momentum) through `TrainSession` against
    the reference's sync_step composed from its own functions without a
    mesh (tests/test_torch_train.py's `_jax_trajectory`)."""
    from repro_torch.control.noise import STAT_KEYS as STATS
    from test_torch_train import (BATCH, LR, SEQ, _batches, _jax_trajectory,
                                  _params_close)
    tm = _models(arch)[1]
    batch = _batches(tm.cfg.vocab_size, 1)[0]
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
    """moonshot-reduced, one lane a rank, RVH across two gloo ranks: the
    reference's span-2 composition within test_torch_train.py's
    tolerances, params bitwise equal across the ranks."""
    from test_torch_train import BATCH, LR, SEQ, _batches, _jax_trajectory
    from torch_dist_workers import launch
    arch = "moonshot-v1-16b-a3b"
    jm, tm, jp, tp = _models(arch)
    batch = _batches(tm.cfg.vocab_size, 1)[0]
    want_l, _, want_p = _jax_trajectory(arch, [batch], 2, "momentum")
    inputs = {"init/" + "/".join(k.key for k in p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    inputs.update({f"batch0/{k}": v for k, v in batch.items()})
    np.savez(tmp_path / "inputs.npz", **inputs)
    ranks = launch(2, "train", {
        "inputs": str(tmp_path / "inputs.npz"), "arch": arch,
        "attn_chunk": 16, "cases": [{"policy": dict(
            span=0, backend="rvh", optimizer="momentum"), "lr": LR,
            "steps": 1}]}, tmp_path)
    for r in ranks:
        (case,) = r
        assert case["path"] == "rvh" and case["bitwise"] == [True]
        np.testing.assert_allclose(case["losses"][0], want_l[0], atol=1e-4)
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want_p)[0],
                                T.leaves(case["params"])):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0,
                                       err_msg=str(path))


# ----------------------------------------------------------- entry points
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_the_arch(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", arch, "--reduced",
                "--requests", "2", "--prompt-len", "8", "--gen", "4",
                "--max-slots", "2", "--system-prompt", "8"])
    out = capsys.readouterr().out
    assert "completed=2" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_the_arch(arch, capsys):
    """Under the arch's preset (mixtral's: bf16 params and optimizer
    state, 8 accumulation steps, span 2 — a batch of 16 gives each lane
    8 rows to split)."""
    from repro_torch.launch.train import main
    main(["--device", "cpu", "--arch", arch, "--reduced", "--steps", "1",
          "--seq", "16", "--batch", "16"])
    assert "[train] done: final loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b", "llava-next-34b",
                                  "seamless-m4t-large-v2"])
def test_other_families_now_build(arch):
    """The four families refused until ROADMAP item 6 was done build at
    their full presets, and `count_params` (7.53 B rwkv, 1.39 B hymba,
    34.4 B llava, 2.04 B seamless) equals the reference's analytic
    count, leaf for leaf of its init."""
    from repro.configs.base import get_config as jax_config
    from repro.models import api as jax_api
    from repro_torch.models import count_params
    cfg = get_config(arch)
    model = build_model(cfg)
    assert model.cfg is cfg
    assert count_params(cfg) == jax_api.count_params(jax_config(arch))
