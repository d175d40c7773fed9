"""The port's one-device training step against the JAX package: optimizer
deltas, `lm_loss` and per-leaf gradients on the reduced dense presets,
3-step `sync_step` / `local_sgd_step` trajectories against the
reference's composition of the same functions, one 2-step run against
the reference's real `build_runtime` on a 4-device CPU mesh, the data
pipeline, the train CLI, the later-slice refusals and the flash
wrappers' gradient guard. Params cross through `repro_torch.bridge`,
batches come from numpy seeds; compute is fp32 on both sides.

Tolerances, with their reasons:
  * optimizer deltas: rtol 1e-6, atol 1e-9 — the same fp32 elementwise
    arithmetic in another library;
  * loss: 1e-5 absolute, gradients 2e-6 absolute + 1e-4 relative — both
    sides run the same fp32 graph through different matmul and
    reduction kernels (summation order only);
  * trajectories: losses 1e-4 absolute and params 1e-5 absolute over
    three steps at lr 1e-3 — the gradient's ~1e-6 relative difference
    passes through the Adasum scalars and the optimizer; under adam a
    few elements with near-zero gradients may move by up to lr a step
    (see the test);
  * CombineStats metrics: rtol 1e-3 — ratios of level-0 dot sums
    (lane_cos, noise_scale) amplify the gradients' relative difference.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_reduced as jax_reduced
from repro.control.noise import summarize_stats as jax_summarize
from repro.core import combine as JC
from repro.core.dist_opt import DistributedOptimizer as JDistOpt
from repro.data import pipeline as JP
from repro.models import build_model as jax_build
from repro.optim import optimizers as JO
from repro_torch import tree as T
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_reduced
from repro_torch.control.noise import STAT_KEYS
from repro_torch.data import pipeline as TP
from repro_torch.engine import EngineConfig, TrainSession, build_runtime
from repro_torch.engine.build import EngineWarning
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import build_model
from repro_torch.optim import optimizers as TO
from repro_torch.parallel.policy import RunPolicy

from conftest import run_in_subprocess

SRC = Path(__file__).resolve().parents[1] / "src"
DENSE = ("gemma-7b", "minitron-4b", "qwen3-32b")
LR = 1e-3
SEQ, BATCH = 16, 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree_close(got, want, **tol):
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            T.leaves(got)):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=str(path), **tol)


@functools.lru_cache(maxsize=None)    # one init per arch; params are copied
def _models(arch):
    jm = jax_build(jax_reduced(arch), compute_dtype=jnp.float32,
                   attn_chunk=16)
    tm = build_model(get_reduced(arch), compute_dtype=torch.float32)
    jp = jm.init(jax.random.key(0))
    return jm, tm, jp, jax.tree.map(np.asarray, jp)


def _port_params(arch):
    return params_from_numpy(_models(arch)[3], device="cpu",
                             cfg=get_reduced(arch))


def _batches(vocab, steps, seed=3):
    src = TP.SyntheticLM(TP.DataConfig(seq_len=SEQ, global_batch=BATCH,
                                       vocab_size=vocab, seed=seed))
    return [src.batch(s) for s in range(steps)]


# ------------------------------------------------------------ data pipeline
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (5, 3)])
def test_synthetic_batches_bitwise_equal(seed, step):
    cfg = dict(seq_len=24, global_batch=6, vocab_size=257, seed=seed)
    want = JP.make_source(JP.DataConfig(**cfg)).batch(step)
    got = TP.make_source(TP.DataConfig(**cfg)).batch(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_memmap_batches_bitwise_equal(tmp_path):
    path = tmp_path / "toks.bin"
    np.random.default_rng(0).integers(0, 257, 5000, dtype=np.int32).tofile(
        path)
    cfg = dict(seq_len=32, global_batch=4, vocab_size=257, seed=2,
               kind="memmap", path=str(path))
    for step in (0, 4):
        want = JP.make_source(JP.DataConfig(**cfg)).batch(step)
        got = TP.make_source(TP.DataConfig(**cfg)).batch(step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------------- optimizers
OPTS = {
    "sgd": {}, "momentum": {}, "nesterov": dict(nesterov=True,
                                                weight_decay=0.01),
    "adam": {}, "adam_wd_bf16": dict(weight_decay=0.01,
                                     state_dtype="bfloat16"),
    "lamb": {}, "lamb_bf16": dict(state_dtype="bfloat16"),
    # adam's passes a slice of a leaf at a time (`ADAM_PIECE` elements,
    # here 7: one row of w, 7 and 1 of b)
    "adam_bf16_pieces": dict(state_dtype="bfloat16", piece=7),
    "lamb_pieces": dict(piece=7),
}


@pytest.mark.parametrize("case", sorted(OPTS))
def test_optimizer_deltas_match_reference(case, monkeypatch):
    name = {"nesterov": "momentum"}.get(case, case.split("_")[0])
    kw = dict(OPTS[case])
    if "piece" in kw:
        monkeypatch.setattr(TO, "ADAM_PIECE", kw.pop("piece"))
    dt = kw.pop("state_dtype", None)
    jkw, tkw = dict(kw), dict(kw)
    if dt:
        jkw["state_dtype"], tkw["state_dtype"] = (getattr(jnp, dt),
                                                  getattr(torch, dt))
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((16, 8)).astype(np.float32),
              "b": rng.standard_normal(8).astype(np.float32)}
    jopt, topt = JO.get_optimizer(name, 0.01, **jkw), \
        TO.get_optimizer(name, 0.01, **tkw)
    assert topt.default_combine_point == jopt.default_combine_point
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        jd, js = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                             js, jp, jnp.asarray(step, jnp.int32))
        td, ts = topt.update({k: torch.from_numpy(v) for k, v in
                              grads.items()}, ts, tp, step)
        _tree_close(td, jd, rtol=1e-6, atol=1e-9)
        jp = jax.tree.map(lambda p, d: p + d, jp, jd)
        T.map(lambda p, d: p.add_(d), tp, td)
    _tree_close(ts, js, rtol=1e-6, atol=1e-9)


# ----------------------------------------------------- loss and gradients
@pytest.mark.parametrize("arch", DENSE)
def test_lm_loss_and_grads_match_reference(arch):
    jm, tm, jp, _ = _models(arch)
    tp = _port_params(arch)
    b = _batches(tm.cfg.vocab_size, 1)[0]
    b["labels"][1, :5] = -100                         # masked positions
    (jl, jmets), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    leaves, td = T.flatten(tp)
    req = [x.requires_grad_(True) for x in leaves]
    tl, tmets = tm.loss(T.unflatten(td, req),
                        {k: torch.from_numpy(v) for k, v in b.items()})
    tg = torch.autograd.grad(tl, req)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-5,
                               rtol=0)
    assert set(tmets) == set(jmets)
    _tree_close(T.unflatten(td, list(tg)), jg, atol=2e-6, rtol=1e-4)


def test_remat_changes_no_gradient():
    _, tm, _, _ = _models("gemma-7b")
    plain = build_model(tm.cfg, compute_dtype=torch.float32, remat=False)
    b = {k: torch.from_numpy(v) for k, v in
         _batches(tm.cfg.vocab_size, 1)[0].items()}
    grads = []
    for m in (tm, plain):
        leaves, td = T.flatten(_port_params("gemma-7b"))
        req = [x.requires_grad_(True) for x in leaves]
        grads.append(torch.autograd.grad(m.loss(T.unflatten(td, req), b)[0],
                                         req))
    for a, c in zip(*grads):
        assert torch.equal(a, c)


@pytest.mark.parametrize("where", ["build_model", "session"])
def test_attn_chunk_reaches_the_loss(monkeypatch, where):
    """`attn_chunk` sets the plain attention's query chunk in the training
    loss (the session caps it at seq_len, as the reference's does); the
    loss does not depend on it."""
    seen = []
    inner = FA.chunked_attention

    def spy(*args, chunk=512, **kw):
        seen.append(chunk)
        return inner(*args, chunk=chunk, **kw)
    monkeypatch.setattr(FA, "chunked_attention", spy)
    cfg = get_reduced("gemma-7b")
    b = {k: torch.from_numpy(v) for k, v in
         _batches(cfg.vocab_size, 1)[0].items()}
    if where == "session":
        s = TrainSession.from_config(
            EngineConfig(arch="gemma-7b", reduced=True, seq_len=SEQ,
                         global_batch=BATCH, attn_chunk=4), device="cpu")
        s.model.loss(s.state["params"], b)
        assert set(seen) == {4}
        seen.clear()
        s = TrainSession.from_config(
            EngineConfig(arch="gemma-7b", reduced=True, seq_len=SEQ,
                         global_batch=BATCH), device="cpu")
        s.model.loss(s.state["params"], b)
        assert set(seen) == {SEQ}
        return
    losses = []
    for chunk in (5, 512):
        m = build_model(cfg, compute_dtype=torch.float32, attn_chunk=chunk)
        losses.append(float(m.loss(_port_params("gemma-7b"), b)[0]))
        assert set(seen) == {chunk}
        seen.clear()
    # masked keys add exact zeros; only the matmul shapes differ
    np.testing.assert_allclose(losses[0], losses[1], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="attn_chunk"):
        build_model(cfg, attn_chunk=0)


# ---------------------------------------------- trajectories vs reference
def _params_close(got, want, opt):
    """Final params, leaf by leaf. Adam moves each element by lr * m /
    (sqrt(v) + 1e-8) whatever its gradient's scale, so an element whose
    gradient is a near-cancelling sum (relative rounding ~1e-3) takes a
    visibly different update: under adam at most 1% of the elements may
    differ by more than 1e-6, and none by more than lr a step."""
    for g, w in zip(got, want):
        diff = np.abs(_np(g) - _np(w))
        if opt != "adam":
            assert diff.max() <= 1e-5, diff.max()
        else:
            assert diff.max() <= 3 * LR and (diff > 1e-6).mean() < 1e-2


def _jax_trajectory(arch, batches, span, opt_name, accum=1, local=1,
                    per_layer=True):
    """The reference's sync_step / local_sgd_step (build.py:309-426) as a
    mesh-free composition of its own functions."""
    jm = _models(arch)[0]
    params = _models(arch)[2]
    ccfg = JC.CombineConfig(span=span, per_layer=per_layer)
    opt = JO.get_optimizer(opt_name, LR)
    dopt = JDistOpt(opt, ccfg, JC.build_fused_combiner(ccfg), span)
    scomb = jax.jit(JC.build_fused_combiner(ccfg, with_stats=True))
    update = jax.jit(lambda G, o, p: dopt.update_stats(G, o, p, scomb))
    grad = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    vgrad = jax.jit(jax.vmap(jax.value_and_grad(jm.loss, has_aux=True),
                             in_axes=(None, 0)))
    state = {"params": params, "opt": dopt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    losses, stats_rows = [], []
    for b in batches:
        p = state["params"]
        lanes = {k: jnp.asarray(v).reshape((span, -1) + v.shape[1:])
                 for k, v in b.items()}
        if local > 1:
            inner0 = state["opt"]["inner"]
            per_lane = span > 1 and dopt.point == "post"
            deltas, inners, mets = [], [], []
            for i in range(span):
                oi = jax.tree.map(lambda x: x[i], inner0) if per_lane \
                    else inner0
                q, lm = p, []
                for j in range(local):
                    mb = {k: v[i].reshape((local, -1) + v.shape[2:])[j]
                          for k, v in lanes.items()}
                    (_, m), g = grad(q, mb)
                    d, oi = opt.update(g, oi, q,
                                       state["opt"]["step"] + j)
                    q = jax.tree.map(lambda a, c: (a.astype(jnp.float32)
                                                   + c).astype(a.dtype),
                                     q, d)
                    lm.append(m["loss"])
                deltas.append(jax.tree.map(lambda e, s: e - s, q, p))
                inners.append(oi)
                mets.append(np.mean(lm))
            stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *deltas)
            delta, stats = scomb(stacked)
            inner = (jax.tree.map(lambda *xs: jnp.stack(xs), *inners)
                     if per_lane else inners[0])
            opt_state = {"inner": inner,
                         "step": state["opt"]["step"] + local}
            loss = np.mean(mets)
        else:
            if accum > 1:
                G, ls = None, []
                for j in range(accum):
                    mb = {k: v.reshape((span, accum, -1) + v.shape[2:])[:, j]
                          for k, v in lanes.items()}
                    (_, m), g = vgrad(p, mb)
                    ls.append(np.asarray(m["loss"]))
                    G = g if G is None else jax.tree.map(jnp.add, G, g)
                loss = np.mean(ls)
            else:
                (_, m), G = vgrad(p, lanes)
                loss = float(jnp.mean(m["loss"]))
            delta, opt_state, stats = update(G, state["opt"], p)
        state = {"params": dopt.apply(p, delta), "opt": opt_state,
                 "step": state["step"] + 1}
        losses.append(float(loss))
        stats_rows.append({k: float(v) for k, v in
                           jax_summarize(stats, span, BATCH // span).items()})
    return losses, stats_rows, state["params"]


TRAJ = [  # (span, optimizer, accum_steps, local_steps, per_layer)
    (2, "sgd", 1, 1, True), (4, "sgd", 1, 1, True),
    (2, "momentum", 1, 1, True), (4, "momentum", 1, 1, True),
    (2, "adam", 1, 1, True), (4, "adam", 1, 1, True),
    (2, "lamb", 1, 1, True), (4, "lamb", 1, 1, True),
    (4, "momentum", 1, 1, False),
    (2, "momentum", 2, 1, True), (2, "adam", 2, 1, True),
    (2, "momentum", 1, 2, True), (2, "adam", 1, 2, True),
]


@pytest.mark.parametrize("span,opt,accum,local,per_layer", TRAJ)
def test_trajectory_matches_reference_composition(span, opt, accum, local,
                                                  per_layer):
    arch = "gemma-7b"
    tm = _models(arch)[1]
    batches = _batches(tm.cfg.vocab_size, 3)
    want_l, want_s, want_p = _jax_trajectory(arch, batches, span, opt,
                                             accum, local, per_layer)
    rt = build_runtime(tm, RunPolicy(span=span, backend="gspmd_tree",
                                     optimizer=opt, accum_steps=accum,
                                     local_steps=local,
                                     per_layer=per_layer), lr=LR)
    params = _port_params(arch)
    state = {"params": params, "opt": rt.dopt.init(params), "step": 0}
    for i, b in enumerate(batches):
        state, m = rt.train_step(state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), want_l[i], atol=1e-4)
        assert int(m["grad_lanes"]) == span
        for k in STAT_KEYS:
            np.testing.assert_allclose(float(m[k]), want_s[i][k], rtol=1e-3,
                                       atol=1e-9, err_msg=k)
    assert state["step"] == 3
    _params_close(T.leaves(state["params"]), jax.tree.leaves(want_p), opt)


def test_span_one_runs_no_combine():
    tm = _models("gemma-7b")[1]
    rt = build_runtime(tm, RunPolicy(span=1, backend="gspmd_tree",
                                     optimizer="sgd"), lr=LR)
    assert not rt.combine_stats
    params = _port_params("gemma-7b")
    b = {k: torch.from_numpy(v) for k, v in
         _batches(tm.cfg.vocab_size, 1)[0].items()}
    state, m = rt.train_step({"params": params,
                              "opt": rt.dopt.init(params), "step": 0}, b)
    assert set(STAT_KEYS).isdisjoint(m) and int(m["grad_lanes"]) == 1


def test_combine_impl_plain_equals_kernel_arm_on_cpu():
    tm = _models("gemma-7b")[1]
    b = {k: torch.from_numpy(v) for k, v in
         _batches(tm.cfg.vocab_size, 1)[0].items()}
    out = []
    for impl in ("kernel", "plain"):
        rt = build_runtime(tm, RunPolicy(span=4, backend="gspmd_tree",
                                         optimizer="momentum"), lr=LR,
                           combine_impl=impl)
        params = _port_params("gemma-7b")
        state, _ = rt.train_step({"params": params,
                                  "opt": rt.dopt.init(params), "step": 0}, b)
        out.append(T.leaves(state["params"]))
    assert all(torch.equal(a, c) for a, c in zip(*out))
    with pytest.raises(ValueError, match="combine_impl"):
        build_runtime(tm, RunPolicy(span=2), combine_impl="cuda")


# ------------------------------------------ the reference's build_runtime
def test_matches_jax_build_runtime_on_4_device_mesh(tmp_path):
    """The real reference runtime (span 2 < dp 4: the fused gspmd_tree
    path, adam at the post point) for 2 steps from its own init, then the
    port from the same params on the same batches."""
    out = tmp_path / "ref.npz"
    run_in_subprocess(f"""
import jax, numpy as np
from repro.configs.base import get_reduced
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.engine import build_runtime
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.parallel.policy import RunPolicy
mesh = make_mesh_compat((4, 1), ("data", "model"))
cfg = get_reduced("gemma-7b")
model = build_model(cfg, compute_dtype=jax.numpy.float32, attn_chunk=16)
rt = build_runtime(model, mesh, RunPolicy(span=2, backend="gspmd_tree",
                   optimizer="adam"), lr={LR})
state = rt.init_state(jax.random.key(0))
flat = lambda t: {{"/".join(k.key for k in p): np.asarray(v) for p, v in
                  jax.tree_util.tree_flatten_with_path(t)[0]}}
init = flat(state["params"])
src = SyntheticLM(DataConfig(seq_len={SEQ}, global_batch={BATCH},
                             vocab_size=cfg.vocab_size, seed=3))
losses = []
step = jax.jit(rt.train_step)
for s in range(2):
    state, m = step(state, src.batch(s))
    losses.append(float(m["loss"]))
np.savez({str(out)!r}, losses=np.asarray(losses),
         **{{"init/" + k: v for k, v in init.items()}},
         **{{"final/" + k: v for k, v in flat(state["params"]).items()}})
""", devices=4, timeout=600)
    ref = np.load(out)
    tree = {}
    for key in ref.files:
        if key.startswith("init/"):
            node = tree
            *path, leaf = key[5:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = ref[key]
    tm = _models("gemma-7b")[1]
    params = params_from_numpy(tree, device="cpu", cfg=tm.cfg)
    rt = build_runtime(tm, RunPolicy(span=2, backend="gspmd_tree",
                                     optimizer="adam"), lr=LR)
    state = {"params": params, "opt": rt.dopt.init(params), "step": 0}
    for s, b in enumerate(_batches(tm.cfg.vocab_size, 2)):
        state, m = rt.train_step(state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), ref["losses"][s],
                                   atol=1e-4)
    final = params_to_numpy(state["params"])
    got, want = [], []
    for key in ref.files:
        if key.startswith("final/"):
            node = final
            for p in key[6:].split("/"):
                node = node[p]
            got.append(node)
            want.append(ref[key])
    assert len(got) == len(T.leaves(final))
    _params_close(got, want, "adam")


# --------------------------------------------------- session, CLI, config
def test_session_fit_and_metadata():
    cfg = EngineConfig(arch="gemma-7b", reduced=True, span=2,
                       backend="gspmd_tree", optimizer="momentum",
                       seq_len=SEQ, global_batch=BATCH, steps=2)
    s = TrainSession.from_config(cfg, device="cpu", callbacks=[])
    hist = s.fit()
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    meta = s.run_metadata()
    assert meta["combine_path"] == "gspmd-fused" and meta["span"] == 2
    assert meta["combine_point"] == "pre" and meta["stats_enabled"]
    assert set(meta["combine_stats"]) == set(STAT_KEYS)
    assert s.fit() == []                        # already at step 2


def test_rvh_with_lanes_warns_or_raises_under_strict():
    base = dict(arch="gemma-7b", reduced=True, span=2, backend="rvh",
                seq_len=SEQ, global_batch=BATCH)
    with pytest.warns(EngineWarning, match="falling back"):
        s = TrainSession.from_config(EngineConfig(**base), device="cpu",
                                     callbacks=[])
    assert s.runtime.combine_path == "gspmd-fused"
    with pytest.raises(ValueError, match="rvh"):
        TrainSession.from_config(EngineConfig(strict=True, **base),
                                 device="cpu")


@pytest.mark.parametrize("over,match", [
    (dict(span=3), "power of two"), (dict(span=16), "divisible"),
    (dict(span=2, accum_steps=3), "accum_steps"),
    (dict(local_steps=2, accum_steps=2), "mutually exclusive"),
    (dict(backend="nope"), "backend"), (dict(combine="nope"), "combine")])
def test_validate_rejects(over, match):
    cfg = EngineConfig(arch="gemma-7b", reduced=True, global_batch=BATCH,
                       **over)
    with pytest.raises(ValueError, match=match):
        cfg.validate(dp_total=1)


def test_train_cli_exits_zero_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "gemma-7b", "--reduced", "--span", "2", "--steps", "3",
         "--seq", "32", "--batch", "8"],
        env=dict(os.environ, PYTHONPATH=str(SRC)),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[train] done: final loss" in res.stdout
    assert "prefetch=on depth=1" in res.stdout


@pytest.mark.parametrize("flags,item", [
    (["--data-mesh", "2"], "7"), (["--model-mesh", "2"], "7")])
def test_later_slice_flags_raise(flags, item, capsys):
    """Refused until the model axis came (the name is from then). On one
    rank `--data-mesh 2` or `--model-mesh 2` runs as the reference's
    fallback mesh (1, 1) does: the run without the flag, bitwise. The
    same grid short of 4 ranks still names its item."""
    from repro_torch.engine import EngineConfig
    from repro_torch.launch.train import main
    argv = ["--device", "cpu", "--arch", "gemma-7b", "--reduced",
            "--steps", "1", "--seq", "16", "--batch", "8"]
    got, want = main(argv + flags), main(argv)
    assert "world=1 dist=none mesh=1x1" in capsys.readouterr().out
    assert [h["loss"] for h in got] == [h["loss"] for h in want]
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP.md queue 1, item {item}\)"):
        EngineConfig.from_cli(["--arch", "gemma-7b"] + flags).rank_mesh(3)


def test_recurrent_family_trains_on_cpu(capsys):
    """`--arch rwkv6-7b`, refused until ROADMAP item 6 was done, now
    trains (its preset: backend rvh, which falls back to gspmd_tree on
    one process)."""
    import warnings
    from repro_torch.launch.train import main
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        main(["--device", "cpu", "--arch", "rwkv6-7b", "--reduced",
              "--steps", "1", "--seq", "16", "--batch", "8"])
    assert "[train] done: final loss" in capsys.readouterr().out


@pytest.mark.parametrize("flags,match", [
    (["--elastic"], "elastic=True needs ckpt_dir"),
    (["--adaptive-batch"], "adaptive_batch=True needs ckpt_dir"),
    (["--adaptive-batch", "--ckpt-dir", "ck", "--no-combine-stats"],
     "needs combine_stats=True"),
    (["--adaptive-batch", "--ckpt-dir", "ck", "--elastic"],
     "mutually exclusive drivers")])
def test_driver_flags_are_the_references_errors(flags, match):
    """--elastic and --adaptive-batch run (fit_elastic, fit_adaptive);
    their cross-field refusals are the reference's ValueErrors."""
    from repro.engine import EngineConfig as JEngineConfig
    from repro_torch.launch.train import main
    argv = ["--device", "cpu", "--arch", "gemma-7b", "--reduced",
            "--steps", "1", "--seq", "16", "--batch", "8"] + flags
    with pytest.raises(ValueError, match=match):
        main(argv)
    with pytest.raises(ValueError, match=match):
        JEngineConfig.from_cli(argv[2:])


def test_elastic_cli_on_two_cpu_ranks(tmp_path):
    """`--elastic --fail-at 2` under torch.distributed.run on two CPU
    ranks: the loss at step 2 shrinks the run to one rank (rank 1
    parks), which resumes from the boundary checkpoint and finishes;
    both ranks exit 0 and rank 0 prints the restart and resilience.
    Momentum steps at the pre point: adam's per-lane state at span 2
    has no fold onto one lane without a lane axis, in the reference's
    reshard_lanes as in the port's."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--arch", "gemma-7b", "--reduced", "--steps",
         "4", "--seq", "32", "--batch", "8", "--optimizer", "momentum",
         "--elastic", "--fail-at", "2", "--ckpt-dir", str(tmp_path / "ck")],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert "[elastic] injected node failure at step 2: restarting at dp=1 " \
           "(was 2), no hyperparameter change" in out, out
    assert "[control] rebuild #1: batch=8 span=1" in out
    assert out.count("[train] done: final loss") == 1
    assert "[train] resilience restore_fallbacks=0 quarantined_steps=0 " \
           "restarts=1 grow_backs=0" in out


def test_unknown_combiner_is_the_references_error():
    """The reference has no 'dasgd' (its registry names it only in a
    docstring example): an unknown op, refused by the config as there."""
    from repro.engine import EngineConfig as JEngineConfig
    from repro_torch.launch.train import main
    argv = ["--device", "cpu", "--arch", "gemma-7b", "--reduced",
            "--steps", "1", "--seq", "16", "--batch", "8", "--combine",
            "dasgd"]
    with pytest.raises(ValueError, match="unknown combine op 'dasgd'"):
        main(argv)
    with pytest.raises(ValueError, match="unknown combine op 'dasgd'"):
        JEngineConfig.from_cli(argv[2:])


@pytest.mark.parametrize("flags", [
    ["--combine-delay", "1", "--optimizer", "momentum"],
    ["--acc-dtype", "float64"],
    ["--acc-dtype", "float64", "--combine-delay", "1", "--no-fused-combine"]])
def test_combiner_flags_train_on_cpu(flags):
    """The flags this slice brings train: a finite loss each step, the
    delayed run with its carry, the fp64 one with fp64 dots."""
    from repro_torch.launch.train import main
    argv = ["--device", "cpu", "--arch", "gemma-7b", "--reduced", "--span",
            "2", "--backend", "gspmd_tree", "--steps", "2", "--seq", "16",
            "--batch", "8", "--no-prefetch"] + flags
    history = main(argv)
    assert len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)


# ------------------------------------------------- flash wrappers' guard
def test_flash_wrappers_refuse_gradients():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 4, 16, generator=g, requires_grad=True)
    k = torch.randn(1, 8, 2, 16, generator=g)
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_attention(q, k, k)
    with torch.no_grad():
        FA.flash_attention(q, k, k)
    qd = torch.randn(2, 4, 16, generator=g, requires_grad=True)
    pages = torch.randn(3, 4, 2, 16, generator=g)
    table = torch.tensor([[1], [2]], dtype=torch.int32)
    pos = torch.tensor([1, 3], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        FA.paged_decode_attention(qd, pages, pages, table, pos)
    with torch.no_grad():
        FA.paged_decode_attention(qd, pages, pages, table, pos)
