"""The port's MoE layer (`repro_torch.models.moe`) against the JAX
package's `repro.models.moe`: capacity, the dispatch's output and aux
loss (mixtral's 4-expert top-2, moonshot's shared experts, a capacity
factor of 0.5 that drops pairs, shard-local dispatch, tied router
logits), their gradients, and the configs and parameter counts of the
three MLA and MoE presets. Params cross through numpy; inputs come
from numpy seeds.

Tolerances, with their reasons:
  * fp32: output 1e-5 absolute + 1e-5 relative, aux 1e-6 — the same
    fp32 arithmetic through different matmul kernels (summation order
    only). The outputs reach ~100: the reference initialises the
    stacked expert weights [E, ...] with fan-in E (std 1/sqrt(E)). A
    routing difference (top-k, slot positions, drops) would move a
    token's output by O(10), far outside this;
  * gradients: 1e-4 relative, plus 1e-6 of the leaf's largest magnitude
    (at least 1e-5) absolute — a few elements of the router's and the
    experts' gradients are near-cancelling sums of O(100) terms;
  * bf16: 2^-7 of the output's largest magnitude (two bf16 steps at that
    scale) — one bf16 rounding of the expert outputs and of the K-sum,
    which the two libraries may order differently.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import base as JCB
from repro.models import moe as JM
from repro_torch import tree as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as TCB
from repro_torch.models import moe as TM

ARCHS = ("minicpm3-4b", "mixtral-8x22b", "moonshot-v1-16b-a3b")
ATOL32, RTOL32 = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread in this process: the reduced models' ops gain
    nothing from more, and in a run of several test workers the extra
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CASES = {   # name: (arch, config overrides, local_shards, B, T)
    "mixtral": ("mixtral-8x22b", {}, 1, 2, 12),
    "moonshot_shared": ("moonshot-v1-16b-a3b", {}, 1, 2, 12),
    "drops_cf0.5": ("moonshot-v1-16b-a3b", {"capacity_factor": 0.5}, 1, 3,
                    20),
    "shards2": ("mixtral-8x22b", {"capacity_factor": 0.5}, 2, 2, 16),
    "shards3_fallback": ("mixtral-8x22b", {}, 3, 2, 8),
}


# jitted: eager JAX compiles each op on its own, which takes longer here
jax_moe = jax.jit(JM.moe_apply, static_argnums=(1, 3, 4))


def _cfgs(arch, over):
    return (dataclasses.replace(JCB.get_reduced(arch), **over),
            dataclasses.replace(TCB.get_reduced(arch), **over))


def _params(jcfg, seed=0, router=None):
    p = JM.moe_init(jax.random.key(seed), jcfg, jnp.float32)
    if router is not None:
        p = dict(p, router=jnp.asarray(router, jnp.float32))
    return p, params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _x(B, T, D, seed=1):
    return np.random.RandomState(seed).randn(B, T, D).astype(np.float32)


def _dropped(jcfg, p, x, shards):
    """The (token, k) pairs the reference drops: recomputed from its
    router with jax.lax.top_k and the cumsum positions."""
    B, T, D = x.shape
    N = B * T
    S = shards if N % shards == 0 else 1
    xf = jnp.asarray(x).reshape(S, N // S, D)
    probs = jax.nn.softmax(xf @ p["router"], -1)
    _, idx = jax.lax.top_k(probs, jcfg.n_experts_per_tok)
    flat = idx.reshape(S, -1)
    oh = jax.nn.one_hot(flat, jcfg.n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, 1) - 1, flat[..., None], 2)
    return int((pos[..., 0] >= JM.capacity(jcfg, N // S)).sum())


@pytest.mark.parametrize("n", [1, 4, 7, 24, 100, 4096])
@pytest.mark.parametrize("arch", ARCHS[1:])
def test_capacity_matches_reference(arch, n):
    jcfg, tcfg = _cfgs(arch, {})
    for cf in (0.5, 1.25, 8.0):
        j, t = (dataclasses.replace(c, capacity_factor=cf)
                for c in (jcfg, tcfg))
        assert TM.capacity(t, n) == JM.capacity(j, n)


def test_top_k_takes_lower_index_on_ties():
    """`jax.lax.top_k`'s order among equal values; `torch.topk` gives no
    such promise (on the CPU it does not keep it)."""
    p = np.asarray([[0.1, 0.3, 0.3, 0.3, 0.0], [0.25, 0.25, 0.25, 0.25, 0.0],
                    [0.0, 0.5, 0.0, 0.5, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(p), 3)
    tv, ti = TM.top_k(torch.from_numpy(p), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_reference(case):
    arch, over, shards, B, T_ = CASES[case]
    jcfg, tcfg = _cfgs(arch, over)
    jp, tp = _params(jcfg)
    x = _x(B, T_, jcfg.d_model)
    jo, ja = jax_moe(jp, jcfg, jnp.asarray(x), jnp.float32, shards)
    to, ta = TM.moe_apply(tp, tcfg, torch.from_numpy(x), torch.float32,
                          shards)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL32,
                               rtol=RTOL32)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6, rtol=0)
    if case.startswith("drops") or case == "shards2":
        assert _dropped(jcfg, jp, x, shards) > 0     # the case drops pairs


@pytest.mark.parametrize("ties", ["all_equal", "two_columns"])
def test_tied_router_logits_match_reference(ties):
    """Tied router probabilities: the pairs go to the lower expert index
    first, as in `jax.lax.top_k`. All-equal logits send every token to
    experts 0..K-1 (and overflow their capacity); two equal router
    columns tie those two experts for every token."""
    jcfg, tcfg = _cfgs("mixtral-8x22b", {})
    D, E = jcfg.d_model, jcfg.n_experts
    router = np.random.RandomState(3).randn(D, E).astype(np.float32) * 0.02
    if ties == "all_equal":
        router[:] = 0.0
    else:
        router[:, 2] = router[:, 1]
    jp, tp = _params(jcfg, router=router)
    x = _x(2, 16, D)
    jo, ja = jax_moe(jp, jcfg, jnp.asarray(x), jnp.float32)
    to, ta = TM.moe_apply(tp, tcfg, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL32,
                               rtol=RTOL32)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6, rtol=0)


def test_moe_apply_bf16_matches_reference():
    """bf16 compute, bf16 input: the gates are cast to the expert
    output's dtype before the K-sum, then the sum to x's dtype."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", {})
    jp, tp = _params(jcfg)
    x = _x(2, 12, jcfg.d_model)
    jo, ja = jax_moe(jp, jcfg, jnp.asarray(x, jnp.bfloat16),
                          jnp.bfloat16)
    to, ta = TM.moe_apply(tp, tcfg, torch.from_numpy(x).bfloat16(),
                          torch.bfloat16)
    assert to.dtype == torch.bfloat16
    want = np.asarray(jo.astype(jnp.float32))
    np.testing.assert_allclose(to.float().numpy(), want,
                               atol=2.0 ** -7 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-3, rtol=0)


@pytest.mark.parametrize("case", ["moonshot_shared", "drops_cf0.5"])
def test_moe_grads_match_reference(case):
    """d(Σ out·w + aux)/d(params, x): through the gates, the gathers of
    the dispatch and the combine, and the aux loss's mean router
    probability (its routed fractions carry no gradient)."""
    arch, over, shards, B, T_ = CASES[case]
    jcfg, tcfg = _cfgs(arch, over)
    jp, tp = _params(jcfg)
    x = _x(B, T_, jcfg.d_model)
    w = _x(B, T_, jcfg.d_model, seed=9)

    def jloss(p, xx):
        o, a = jax_moe(p, jcfg, xx, jnp.float32, shards)
        return jnp.sum(o * w) + a
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves, td = T.flatten(tp)
    req = [t.requires_grad_(True) for t in leaves]
    xt = torch.from_numpy(x).requires_grad_(True)
    o, a = TM.moe_apply(T.unflatten(td, req), tcfg, xt, torch.float32,
                        shards)
    grads = torch.autograd.grad((o * torch.from_numpy(w)).sum() + a,
                                req + [xt])
    wants = jax.tree_util.tree_flatten_with_path(jgp)[0] + [("x", jgx)]
    for (path, want), got in zip(wants, grads):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=1e-4,
            atol=max(1e-5, 1e-6 * np.abs(want).max()), err_msg=str(path))


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch, reduced):
    get_t = TCB.get_reduced if reduced else TCB.get_config
    get_j = JCB.get_reduced if reduced else JCB.get_config
    assert dataclasses.asdict(get_t(arch)) == dataclasses.asdict(get_j(arch))


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch, active_only):
    from repro.models.api import count_params as jax_count
    from repro_torch.models.api import count_params
    assert count_params(TCB.get_config(arch), active_only) == \
        jax_count(JCB.get_config(arch), active_only)
