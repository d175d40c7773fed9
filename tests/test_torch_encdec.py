"""The port's encoder-decoder (`repro_torch.models.encdec`, the
seamless-m4t-large-v2 backbone) and the vision frontend (llava's
projector in `transformer.forward` / `lm_loss`) against the JAX
package's, on the reduced presets: the reference's weights through
numpy, inputs from numpy seeds, fp32 compute on both sides.

Tolerances, with their reasons:
  * encoder states, teacher-forced logits, loss: 1e-4 absolute (loss
    1e-5), test_torch_families.py's — the same fp32 arithmetic through
    different matmul kernels;
  * gradients: 1e-4 relative plus 1e-6 of the leaf's largest magnitude
    absolute (at least 2e-6), test_torch_families.py's;
  * the decode cache's cross K/V: one bf16 step (2^-8 relative) — both
    packages round fp32 projections to bf16 (the reference's
    `init_cache` computes them in bf16 whatever the compute dtype), and
    a sum order can tip a rounding;
  * decode logits: 2e-2 absolute — the self cache and the cross K/V are
    bf16 on both sides (mirrored on purpose), so bf16 attention
    probabilities and values go through two layers, rounded in
    different orders by the two libraries; they are held to the fp32
    teacher-forced logits within 0.1 as well.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.models import encdec as JE
from repro_torch import tree as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.models import encdec as E

SEAMLESS = "seamless-m4t-large-v2"
LLAVA = "llava-next-34b"
ATOL = 1e-4


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
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                               cfg=cfg)
        _CACHE[arch] = jm, tm, jp, tp
    return _CACHE[arch]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _batch(cfg, seed, B=2, T_=12, S=10):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, T_)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -100
    labels[1, :3] = -100
    fe = (0.02 * rng.standard_normal((B, S, cfg.frontend_dim))
          ).astype(np.float32)
    return {"tokens": toks, "labels": labels, "frontend_embeds": fe}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads_close(tm, tp, jm, jp, batch):
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, _jb(batch))
    leaves, td = T.flatten(tp)
    req = [x.detach().clone().requires_grad_(True) for x in leaves]
    tl, mets = tm.loss(T.unflatten(td, req), _tb(batch))
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-5,
                               rtol=0)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                            torch.autograd.grad(tl, req)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, err_msg=str(path),
                                   atol=max(2e-6, 1e-6 * np.abs(w).max()))
    return mets


# ----------------------------------------------------- encoder-decoder
def test_encode_and_decode_train_match_reference():
    jm, tm, jp, tp = _models(SEAMLESS)
    cfg = tm.cfg
    b = _batch(cfg, 0)
    jenc = jax.jit(lambda p, f: JE.encode(p, jm.cfg, f, jnp.float32, 16))(
        jp, jnp.asarray(b["frontend_embeds"]))
    tenc = E.encode(tp, cfg, torch.from_numpy(b["frontend_embeds"]),
                    torch.float32, 16)
    _close(tenc, jenc)
    for last in (False, True):
        want = jax.jit(lambda p, e, t: JE.decode_train(
            p, jm.cfg, e, t, jnp.float32, 16, last_only=last))(
            jp, jenc, jnp.asarray(b["tokens"]))
        got = E.decode_train(tp, cfg, tenc, torch.from_numpy(b["tokens"]),
                             torch.float32, 16, last_only=last)
        assert got.shape == want.shape
        _close(got, want)
    # the model's forward: frames and tokens in, logits out
    _close(tm.forward(tp, torch.from_numpy(b["tokens"]),
                      torch.from_numpy(b["frontend_embeds"])),
           jax.jit(jm.forward)(jp, _jb(b)))


def test_encdec_loss_and_grads_match_reference():
    jm, tm, jp, tp = _models(SEAMLESS)
    mets = _grads_close(tm, tp, jm, jp, _batch(tm.cfg, 1))
    assert float(mets["aux"]) == 0.0


def test_init_cache_and_decode_step_match_reference():
    """The cache from frames (cross K/V in bf16, a bf16 self cache, as the
    reference builds it) and eight decode steps: logits and the self rows
    against the reference's, and the logits against the fp32
    teacher-forced decoder."""
    jm, tm, jp, tp = _models(SEAMLESS)
    cfg = tm.cfg
    b = _batch(cfg, 2, T_=8)
    fe = b["frontend_embeds"]
    jc = jax.jit(lambda p, f: jm.init_cache(p, 2, 16, frontend_embeds=f))(
        jp, jnp.asarray(fe))
    tc = tm.init_cache(tp, 2, 16, frontend_embeds=torch.from_numpy(fe))
    assert tc.cross_k.dtype == tc.self_cache.k.dtype == torch.bfloat16
    assert tc.cross_k.shape == jc.cross_k.shape
    for a, w in ((tc.cross_k, jc.cross_k), (tc.cross_v, jc.cross_v)):
        np.testing.assert_allclose(_np(a), _np(w), rtol=2 ** -8,
                                   atol=2 ** -8 * np.abs(_np(w)).max())
    full = _np(tm.forward(tp, torch.from_numpy(b["tokens"]),
                          torch.from_numpy(fe)))
    jstep = jax.jit(jm.decode_step)
    for t in range(b["tokens"].shape[1]):
        tok = b["tokens"][:, t:t + 1]
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc)
        jl, jc = jstep(jp, jnp.asarray(tok), jc)
        _close(tl, jl, 2e-2)
        np.testing.assert_allclose(_np(tl)[:, 0], full[:, t], atol=0.1,
                                   rtol=0)
    np.testing.assert_array_equal(tc.self_cache.pos.numpy(),
                                  np.asarray(jc.self_cache.pos))
    _close(tc.self_cache.k, jc.self_cache.k, 2e-2)


def test_encdec_cache_needs_frames():
    _, tm, _, tp = _models(SEAMLESS)
    with pytest.raises(ValueError, match="frontend_embeds or enc_out"):
        tm.init_cache(tp, 1, 8)


# ------------------------------------------------------ vision frontend
def test_llava_forward_and_loss_with_frontend_match_reference():
    """The projector (w2 · gelu(w1 · patches)) prepended to the token
    embeddings: logits over patches + tokens, and the loss with the patch
    positions' labels at -100, with its gradients (the projector's
    included)."""
    jm, tm, jp, tp = _models(LLAVA)
    cfg = tm.cfg
    b = _batch(cfg, 3, S=cfg.frontend_tokens)
    got = tm.forward(tp, torch.from_numpy(b["tokens"]),
                     torch.from_numpy(b["frontend_embeds"]))
    want = jax.jit(jm.forward)(jp, _jb(b))
    assert got.shape == (2, cfg.frontend_tokens + 12, cfg.vocab_size)
    _close(got, want)
    _grads_close(tm, tp, jm, jp, b)
