"""The port's SSM mixers (`repro_torch.models.ssm`) against the JAX
package's (`repro.models.ssm`): the causal conv, the chunked Mamba2 and
RWKV6 forwards over several chunks, the channel mix, both decode steps,
and decode == forward for the rwkv and hymba presets. Inputs and params
come from numpy seeds (the reference's init, then perturbed so that
every parameter takes part); compute is fp32 on both sides.

The masked exponent: at a trained-size decay (rwkv decay_base 2.0, hymba
A_log 3.0) the reference's within-chunk `exp` overflows on the masked
triangle and its gradient is NaN, while the port's forward is the
reference's and its gradient finite — and equal to autograd through the
plain per-step recurrence.

Tolerances, with their reasons:
  * mixer outputs and decode steps: 1e-4 absolute (outputs reach ~2,
    after an RMS norm; test_torch_families.py's logit tolerance) — the
    same fp32 arithmetic, summation order only;
  * decode against forward: the reference's own rule
    (tests/test_decode_consistency.py: rtol = atol = 0.05 at bf16; here
    fp32, so 1e-4);
  * the chunked gradient against the per-step recurrence's: 1e-3
    relative plus 3e-3 of the leaf's largest magnitude absolute — one
    recurrence summed in two orders at decays of e^-14 (mamba) to
    e^-7.4 (rwkv) a step; the decay leaves' gradients (decay_A/B/base,
    A_log, dt_bias) are near-cancelling sums over the whole sequence,
    and each fp32 path lands up to ~1.2e-3 of the leaf's largest
    magnitude from a float64 evaluation of the same chunked math.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_reduced as jax_reduced
from repro.models import ssm as JS
from repro.models import build_model as jax_build
from repro_torch import tree as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.models import ssm as S

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _perturbed(tree, seed, consts):
    """The reference's init as numpy, with the constant-initialised
    leaves named in `consts` given seeded values around their init."""
    rng = np.random.RandomState(seed)
    out = jax.tree.map(np.asarray, tree)
    for k, scale in consts.items():
        out[k] = (out[k] + scale * rng.standard_normal(out[k].shape)
                  ).astype(np.float32)
    return out


def _pair(tree):
    """(jax tree, torch tree) of the same numpy values."""
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def _x(seed, B, T_, d, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(
        (B, T_, d))).astype(np.float32)


RWKV = jax_reduced("rwkv6-7b")
HYMBA = jax_reduced("hymba-1.5b")
RWKV_CONSTS = {"mu": 0.2, "decay_base": 1.0, "bonus": 0.3, "ln_x": 0.1}
MAMBA_CONSTS = {"dt_bias": 0.3, "A_log": 0.3, "D": 0.3, "conv_w": 0.2}


def _rwkv_params(seed=0, **over):
    t = _perturbed(JS.rwkv_time_init(jax.random.key(seed), RWKV,
                                     jnp.float32), seed, RWKV_CONSTS)
    for k, v in over.items():
        t[k] = np.full_like(t[k], v)
    c = _perturbed(JS.rwkv_chan_init(jax.random.key(seed + 1), RWKV,
                                     jnp.float32), seed + 1, {"mu": 0.2})
    return t, c


def _mamba_params(seed=0, **over):
    p = _perturbed(JS.mamba_init(jax.random.key(seed), HYMBA, jnp.float32),
                   seed, MAMBA_CONSTS)
    for k, v in over.items():
        p[k] = np.full_like(p[k], v)
    return p


# ------------------------------------------------------------ the mixers
def test_causal_conv_matches_reference():
    x = _x(0, 2, 11, 24)
    w = np.random.RandomState(1).standard_normal((4, 24)).astype(np.float32)
    _close(S._causal_conv(torch.from_numpy(x), torch.from_numpy(w)),
           JS._causal_conv(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("T_", [32, 96])          # one chunk, three
def test_rwkv_time_and_chan_forward_match_reference(T_):
    tn, cn = _rwkv_params()
    (jt, tt), (jc, tc) = _pair(tn), _pair(cn)
    x = _x(2, 2, T_, RWKV.d_model)
    want = jax.jit(lambda p, x: JS.rwkv_time_forward(p, RWKV, x, jnp.float32)
                   )(jt, jnp.asarray(x))
    got = S.rwkv_time_forward(tt, RWKV, torch.from_numpy(x), torch.float32)
    _close(got, want)
    prev = _x(3, 2, 1, RWKV.d_model)
    _close(S.rwkv_chan_forward(tc, RWKV, torch.from_numpy(x),
                               torch.from_numpy(prev), torch.float32),
           jax.jit(lambda p, x, v: JS.rwkv_chan_forward(p, RWKV, x, v,
                                                        jnp.float32))(
               jc, jnp.asarray(x), jnp.asarray(prev)))


@pytest.mark.parametrize("T_", [40, 128])         # one chunk, two
def test_mamba_forward_matches_reference(T_):
    jp, tp = _pair(_mamba_params())
    x = _x(4, 2, T_, HYMBA.d_model)
    want = jax.jit(lambda p, x: JS.mamba_forward(p, HYMBA, x, jnp.float32)
                   )(jp, jnp.asarray(x))
    _close(S.mamba_forward(tp, HYMBA, torch.from_numpy(x), torch.float32),
           want)


def test_decode_steps_match_reference():
    """Both one-token steps from a random state: outputs and every state
    leaf."""
    rng = np.random.RandomState(5)
    B = 3
    tn, cn = _rwkv_params(1)
    (jt, tt), (jc, _) = _pair(tn), _pair(cn)
    K, d = RWKV.rwkv_head_dim, RWKV.d_model
    st = [rng.standard_normal((B, d // K, K, K)).astype(np.float32),
          rng.standard_normal((B, d)).astype(np.float32),
          rng.standard_normal((B, d)).astype(np.float32),
          np.array([4, 9, 0], np.int32)]
    x = _x(6, B, 1, d)
    jo, js = jax.jit(lambda t, c, x, s: JS.rwkv_decode_step(
        t, c, RWKV, x, s, jnp.float32))(jt, jc, jnp.asarray(x),
                                        JS.RWKVState(*map(jnp.asarray, st)))
    to, ts = S.rwkv_decode_step(tt, RWKV, torch.from_numpy(x),
                                S.RWKVState(*map(torch.from_numpy, st)),
                                torch.float32)
    _close(to, jo)
    for a, b in zip(ts, js):
        _close(a, b)
    jm, tm = _pair(_mamba_params(2))
    H = HYMBA.ssm_heads
    P = HYMBA.d_model // H
    ms = [rng.standard_normal((B, H, HYMBA.ssm_state, P)).astype(np.float32),
          rng.standard_normal((B, HYMBA.ssm_conv - 1, H * P)).astype(
              np.float32), np.array([1, 2, 3], np.int32)]
    x = _x(7, B, 1, HYMBA.d_model)
    jo, js = jax.jit(lambda p, x, s: JS.mamba_decode_step(
        p, HYMBA, x, s, jnp.float32))(jm, jnp.asarray(x),
                                      JS.MambaState(*map(jnp.asarray, ms)))
    to, ts = S.mamba_decode_step(tm, HYMBA, torch.from_numpy(x),
                                 S.MambaState(*map(torch.from_numpy, ms)),
                                 torch.float32)
    _close(to, jo)
    for a, b in zip(ts, js):
        _close(a, b)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_decode_matches_forward(arch):
    """The whole model: one-token decode over the per-slot cache against
    the chunked forward (tests/test_decode_consistency.py:20-40), at
    fp32, on the reference's weights — and position by position against
    the reference's decode."""
    cfg = get_reduced(arch)
    jm = jax_build(jax_reduced(arch), compute_dtype=jnp.float32,
                   attn_chunk=16)
    tm = build_model(cfg, compute_dtype=torch.float32, attn_chunk=16)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                           cfg=cfg)
    # rwkv: two 32-row chunks; hymba: past its window (32)
    B, T_ = 2, 64 if cfg.family == "ssm" else 40
    toks = np.random.RandomState(8).randint(0, cfg.vocab_size, (B, T_))
    with torch.no_grad():
        full = _np(tm.forward(tp, torch.from_numpy(toks)))
        cache = tm.init_cache(tp, B, T_ + 1, per_slot=True)
        jc = jm.init_cache(jp, B, T_ + 1, per_slot=True)
        jstep = jax.jit(jm.decode_step)
        for t in range(T_):
            lg, cache = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]),
                                       cache)
            jlg, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                            jc)
            _close(lg, jlg, 1e-4)
            np.testing.assert_allclose(_np(lg)[:, 0], full[:, t], atol=1e-4,
                                       rtol=1e-4)
    for a, b in zip(T.leaves(tuple(cache.layers.values())
                             if isinstance(cache.layers, dict)
                             else cache.layers),
                    jax.tree.leaves(jc.layers)):
        _close(a, b, 1e-4)


# ------------------------------------------------ the masked exponent
def _rwkv_sequential(tt, x):
    """The time mix as the plain per-step recurrence (torch autograd)."""
    B, T_, d = x.shape
    K = RWKV.rwkv_head_dim
    H = d // K
    r, k, v, g, logw = S._rwkv_features(
        tt, RWKV, x, torch.zeros((B, 1, d)), torch.float32)
    r, k, v, w = (t.reshape(B, T_, H, K) for t in (r, k, v, torch.exp(logw)))
    u = tt["bonus"]
    St = torch.zeros((B, H, K, K))
    ys = []
    for t in range(T_):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               St + u[None, :, :, None] * kv))
        St = w[:, t, :, :, None] * St + kv
    y = torch.stack(ys, 1).reshape(B, T_, d)
    return S._rwkv_out(tt, RWKV, y, g, torch.float32)


def _mamba_sequential(tm, x):
    B, T_, _ = x.shape
    xs, z, Bm, Cm, dt, a, H, P = S._mamba_features(tm, HYMBA, x,
                                                   torch.float32)
    xs = torch.nn.functional.silu(S._causal_conv(xs, tm["conv_w"]))
    xh = xs.reshape(B, T_, H, P)
    St = torch.zeros((B, H, HYMBA.ssm_state, P))
    ys = []
    for t in range(T_):
        St = (torch.exp(dt[:, t] * a)[:, :, None, None] * St
              + torch.einsum("bn,bhp->bhnp", Bm[:, t],
                             xh[:, t] * dt[:, t, :, None]))
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], St))
    return S._mamba_out(tm, HYMBA, torch.stack(ys, 1), xh, z, torch.float32)


CASES = {
    "rwkv": (lambda: _pair(_rwkv_params(3, decay_base=2.0)[0]),
             lambda p, x: JS.rwkv_time_forward(p, RWKV, x, jnp.float32),
             lambda p, x: S.rwkv_time_forward(p, RWKV, x, torch.float32),
             _rwkv_sequential, RWKV, 64),
    "mamba": (lambda: _pair(_mamba_params(3, A_log=3.0)),
              lambda p, x: JS.mamba_forward(p, HYMBA, x, jnp.float32),
              lambda p, x: S.mamba_forward(p, HYMBA, x, torch.float32),
              _mamba_sequential, HYMBA, 128),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_large_decay_gradient_is_finite(case):
    """rwkv at decay_base 2.0 (|log w| = e^2 a step, ~236 over a 32-row
    chunk) and mamba at A_log 3.0: the forwards agree with the
    reference's; the reference's gradient has NaN (0 · inf on the
    masked triangle), the port's is finite and equals autograd through
    the per-step recurrence."""
    make, jfwd, tfwd, seq, cfg, T_ = CASES[case]
    (jp, tp) = make()
    x = _x(9, 2, T_, cfg.d_model)
    _close(tfwd(tp, torch.from_numpy(x)), jax.jit(jfwd)(jp, jnp.asarray(x)))
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jfwd(p, jnp.asarray(x)) ** 2))
                 )(jp)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(jg))
    leaves, td = T.flatten(tp)

    def grads(fn):
        req = [p.detach().clone().requires_grad_(True) for p in leaves]
        out = fn(T.unflatten(td, req), torch.from_numpy(x))
        return torch.autograd.grad((out ** 2).sum(), req)
    got, want = grads(tfwd), grads(seq)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3,
                                   atol=3e-3 * float(w.abs().max()) + 1e-9)


def test_large_decay_loss_gradient_is_finite():
    """The same at the model level: rwkv-reduced at decay_base 2.0
    through `lm_loss` — finite loss and gradients."""
    cfg = get_reduced("rwkv6-7b")
    tm = build_model(cfg, compute_dtype=torch.float32)
    p = tm.init(torch.Generator().manual_seed(0), device="cpu")
    p["blocks"]["time"]["decay_base"].fill_(2.0)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 64))
    leaves, td = T.flatten(p)
    req = [x.requires_grad_(True) for x in leaves]
    loss, _ = tm.loss(T.unflatten(td, req),
                      {"tokens": torch.from_numpy(toks),
                       "labels": torch.from_numpy(np.roll(toks, -1, 1))})
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all()
               for g in torch.autograd.grad(loss, req))


def test_chunk_must_divide_sequence():
    """The reference's `T % Q == 0` assertion is kept."""
    tn, _ = _rwkv_params()
    _, tt = _pair(tn)
    with pytest.raises(AssertionError):
        S.rwkv_time_forward(tt, RWKV, torch.zeros(1, 40, RWKV.d_model),
                            torch.float32)
