"""Speculative decoding in the port (draft propose -> one verify forward
-> rollback by a pos rewrite) against the JAX package, and its pins
inside the port.

The engines are held to the JAX engines on the same params (carried
across by `repro_torch.bridge`), requests and arrivals: greedy tokens
and every speculation stat are equal — with the reference benchmark's
sliced draft (`benchmarks/serve_spec.py`: the target's upper blocks
zeroed, the draft its one-layer slice, acceptance 1.0), and with a
random draft (acceptance ~0: every tick proposes, verifies and rolls
back). The draft computes in bf16 on both sides, as the reference
builds it.

Inside the port, spec == plain greedy tokens, backed by the logit gap
(see `tests/test_torch_serve_ext.py`): the verify forward computes T
rows at once where plain decode computes one.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_reduced as jax_reduced
from repro.engine.serving.engine import derive_draft_config as jax_derive
from repro_torch.configs.base import get_reduced
from repro_torch.engine import EngineConfig, GenerationRequest, ServeEngine
from repro_torch.engine.serving.engine import derive_draft_config

from test_torch_serve_ext import (assert_pin, assert_same_run, both,
                                  requests, run, tiny_pair, to_port)

SELF = {"draft_config": {"name": "spec-self"}}   # draft == target


def sliced(n_layers=4):
    """The reference benchmark's construction at tiny size: blocks
    1.. of the target get `wo` and `w_down` zeroed (each becomes a
    residual passthrough), and the draft is the target's first block."""
    jm, tm, jp, tp = tiny_pair(n_layers=n_layers)
    mask = jnp.asarray([1.0] + [0.0] * (n_layers - 1), jnp.float32)
    blocks = dict(jp["blocks"])
    blocks["attn"] = dict(blocks["attn"],
                          wo=blocks["attn"]["wo"] * mask[:, None, None])
    blocks["mlp"] = dict(blocks["mlp"],
                         w_down=blocks["mlp"]["w_down"] * mask[:, None, None])
    jp = dict(jp, blocks=blocks)
    jdraft = dict(jp, blocks=jax.tree.map(lambda x: x[:1], jp["blocks"]))
    return jm, tm, jp, to_port(jp), jdraft


# ------------------------------------------------------------ draft config
@pytest.mark.parametrize("spec", [None, {"arch": "qwen3-32b",
                                         "reduced": True},
                                  {"n_layers": 1, "name": "d1"},
                                  {"arch": "qwen3-32b", "reduced": True,
                                   "n_layers": 1}])
@pytest.mark.parametrize("target", ["qwen3", "qwen3_swa"])
def test_derive_draft_config_matches_reference(spec, target):
    over = {"sliding_window": 16} if target == "qwen3_swa" else {}
    t = dataclasses.replace(get_reduced("qwen3-32b"), **over)
    j = dataclasses.replace(jax_reduced("qwen3-32b"), **over)
    got, want = derive_draft_config(t, spec), jax_derive(j, spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.sliding_window == 0


@pytest.mark.parametrize("spec", [{"vocab_size": 999},
                                  {"family": "ssm"}])
def test_derive_draft_config_errors_match_reference(spec):
    msgs = []
    for derive, cfg in ((derive_draft_config, get_reduced("qwen3-32b")),
                        (jax_derive, jax_reduced("qwen3-32b"))):
        with pytest.raises(ValueError) as e:
            derive(cfg, spec)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kw,match", [
    (dict(speculation_k=-1), "speculation_k"),
    (dict(draft_config={"arch": "x"}), "draft_config"),
    (dict(speculation_k=2, draft_config={}), "non-empty")])
def test_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        EngineConfig(**kw).validate()
    assert EngineConfig(speculation_k=4,
                        draft_config={"n_layers": 1}).validate()


# ------------------------------------------------ engines against JAX
WORKLOAD = [(12, 30), (17, 26), (9, 34), (14, 28)]   # serve_spec's shape


@pytest.mark.parametrize("case", ["sliced_paged", "sliced_dense",
                                  "random_paged"])
def test_spec_engine_matches_reference(case):
    reqs = requests(0, WORKLOAD)
    cfg = dict(max_slots=4, max_len=64, speculation_k=4,
               kv_layout=case.split("_")[1])
    if case.startswith("sliced"):
        jm, tm, jp, tp, jdraft = sliced()
        cfg["draft_config"] = {"n_layers": 1, "name": "spec-draft"}
    else:
        jm, tm, jp, tp = tiny_pair()
        # the reference draws the auto-derived draft from key(1): both
        # engines get those weights
        from repro.models import build_model as jax_build
        jdraft = jax_build(jax_derive(jm.cfg), param_dtype=jnp.float32
                           ).init(jax.random.key(1))
    je, te, jh, th = both(jm, tm, jp, tp, reqs, stagger=2, jdraft=jdraft,
                          **cfg)
    assert_same_run(je, te, jh, th)
    assert te.stats["spec_ticks"] > 0
    tt, jt = te.throughput(), je.throughput()
    for k in ("spec_acceptance_rate", "dispatches_per_token",
              "draft_prefills"):
        assert tt[k] == jt[k], k
    if case.startswith("sliced"):
        assert tt["spec_acceptance_rate"] == 1.0
    for a, b in zip(th, jh):
        assert (a.spec_proposed, a.spec_accepted) == \
            (b.spec_proposed, b.spec_accepted)


# ------------------------------------------------------ pins in the port
@pytest.mark.parametrize("draft", ["sliced", "random"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_spec_equals_plain_tokens(draft, layout):
    if draft == "sliced":
        jm, tm, jp, tp, jdraft = sliced()
        kw = dict(draft_config={"n_layers": 1, "name": "spec-draft"})
        dparams = to_port(jdraft)
    else:
        jm, tm, jp, tp = tiny_pair()
        kw, dparams = {}, None
    reqs = requests(1, [(7, 12), (13, 9), (19, 14)])
    cfg = dict(max_slots=2, max_len=48, kv_layout=layout)
    plain = run(ServeEngine(EngineConfig(**cfg), tm, tp), reqs)
    eng = ServeEngine(EngineConfig(speculation_k=3, **cfg, **kw), tm, tp,
                      draft_params=dparams)
    spec = run(eng, reqs)
    assert eng.stats["spec_ticks"] > 0
    assert_pin(tm, tp, reqs, [h.tokens for h in spec],
               [h.tokens for h in plain])


# ------------------------ the reference's own cases (test_spec_decode.py)
def test_self_draft_accepts_everything():
    jm, tm, jp, tp = tiny_pair()
    reqs = requests(1, [(7, 8), (13, 9)])
    plain = run(ServeEngine(EngineConfig(max_slots=2, max_len=48), tm, tp),
                reqs)
    eng = ServeEngine(EngineConfig(max_slots=2, max_len=48, speculation_k=3,
                                   **SELF), tm, tp, draft_params=tp)
    spec = run(eng, reqs)
    assert [h.tokens for h in spec] == [h.tokens for h in plain]
    assert eng.kv_stats()["spec_acceptance_rate"] == 1.0
    assert eng.stats["spec_ticks"] < eng.stats["generated_tokens"]


def test_k_plus_one_trap_stays_closed():
    """After a full-accept tick the next propose must see the row of the
    last draft token (k+1 draft steps). With a self-draft every tick
    after a full accept must still accept: a k-step draft leaves a hole
    at row pos+k and acceptance collapses there."""
    jm, tm, jp, tp = tiny_pair()
    eng = ServeEngine(EngineConfig(max_slots=1, max_len=64, speculation_k=3,
                                   **SELF), tm, tp, draft_params=tp)
    accs = []
    verify = eng._verify

    def spy(*a):
        out = verify(*a)
        accs.append(int(out[2][0]))
        return out
    eng._verify = spy
    run(eng, requests(2, [(9, 40)]))
    full = [i for i, a in enumerate(accs[:-1]) if a == 3]
    assert full, accs
    assert all(accs[i + 1] > 0 for i in full), accs


def test_draft_overrun_is_healed():
    """The draft writes k+1 rows a tick in place; the rows of rejected
    drafts stay in its cache. Each propose first rewrites the draft's
    pos to the committed position, which masks them: the draft always
    ends a propose at committed + k + 1."""
    jm, tm, jp, tp = tiny_pair()
    k = 3
    eng = ServeEngine(EngineConfig(max_slots=2, max_len=64, speculation_k=k),
                      tm, tp)                      # random draft: rejects
    seen = []
    propose = eng._propose

    def spy(params, toks, cache, pos):
        drafts, cache = propose(params, toks, cache, pos)
        seen.append((pos.clone(), cache.layers["attn"].pos.clone()))
        return drafts, cache
    eng._propose = spy
    run(eng, requests(3, [(9, 20), (14, 16)]))
    assert len(seen) > 3 and eng.stats["spec_tokens_accepted"] < \
        eng.stats["spec_tokens_proposed"]
    for pos, after in seen:
        assert torch.equal(after, (pos + k + 1).expand_as(after)), (pos, after)


def _one_slot(tm, tp, prompt_len, gen, k=3, seed=4):
    req = requests(seed, [(prompt_len, gen)])[0]
    ref = run(ServeEngine(EngineConfig(max_slots=1, max_len=64,
                                       kv_layout="dense"), tm, tp), [req])
    eng = ServeEngine(EngineConfig(max_slots=1, max_len=64,
                                   speculation_k=k), tm, tp)
    return eng, eng.submit(GenerationRequest(**req)), ref[0].tokens


def test_rollback_across_page_boundary():
    """Verify rows 15..18 straddle pages 0|1; the random draft is
    rejected wholesale, so the page claimed for the overhang goes back:
    table entry at trash, pool back to one page."""
    jm, tm, jp, tp = tiny_pair()
    eng, h, ref = _one_slot(tm, tp, prompt_len=15, gen=20)
    eng.step()
    slot = h.slot
    assert eng.stats["spec_ticks"] == 1
    assert eng.stats["spec_tokens_accepted"] == 0
    assert int(eng._tables[slot, 1]) == 0
    assert not eng._owned[slot, 1] and not eng._shared[slot, 1]
    assert eng._pool.pages_used == 1
    eng.drain()
    assert h.tokens == ref


def test_rollback_restores_cow_shared_page():
    """A SHARED page beyond the accept point: the claim copies it, the
    rejection releases the copy and restores the read-only original —
    same entry, same refcount, same tokens."""
    jm, tm, jp, tp = tiny_pair()
    eng, h, ref = _one_slot(tm, tp, prompt_len=15, gen=25)
    for _ in range(15):                # acceptance ~0: pos 15 -> 30
        eng.step()
    slot = h.slot
    assert int(eng._host_pos[slot]) == 30
    pid = eng._pool.alloc(1)[0]
    eng._pool.ref([pid])               # an external holder
    eng._tables[slot, 2] = pid
    eng._shared[slot, 2] = True
    eng._tables_dirty = True
    cows = eng.stats["cow_copies"]
    eng.step()                         # rows 30..33 straddle pages 1|2
    assert eng.stats["cow_copies"] == cows + 1
    assert int(eng._tables[slot, 2]) == pid
    assert eng._shared[slot, 2] and not eng._owned[slot, 2]
    assert eng._pool.refcount(pid) == 2
    eng.drain()
    eng._pool.release([pid])
    assert h.tokens == ref


def test_preempt_mid_speculation():
    """Pool pressure during spec growth preempts the youngest request;
    its re-admission re-prefills prompt + accepted in both caches, and
    the streams equal the unconstrained run."""
    jm, tm, jp, tp = tiny_pair()
    reqs = requests(5, [(20, 20), (25, 20), (18, 20)])
    kw = dict(max_slots=3, max_len=48, prefix_sharing=False,
              speculation_k=3, **SELF)
    full = run(ServeEngine(EngineConfig(**kw), tm, tp, draft_params=tp),
               reqs)
    eng = ServeEngine(EngineConfig(kv_pages=6, **kw), tm, tp,
                      draft_params=tp)
    tight = run(eng, reqs)
    assert eng.stats["preemptions"] >= 1
    assert eng.stats["draft_prefills"] > 3
    assert eng.throughput()["completed"] == 3
    assert_pin(tm, tp, reqs, [h.tokens for h in tight],
               [h.tokens for h in full])


def test_swa_stops_speculating_at_window():
    jm, tm, jp, tp = tiny_pair(sliding_window=16)
    reqs = requests(6, [(9, 16)])
    plain = run(ServeEngine(EngineConfig(max_slots=2, max_len=48), tm, tp),
                reqs)
    eng = ServeEngine(EngineConfig(max_slots=2, max_len=48, speculation_k=2,
                                   **SELF), tm, tp, draft_params=tp)
    spec = run(eng, reqs)
    assert [h.tokens for h in spec] == [h.tokens for h in plain]
    # 9 + 16 crosses the 16-row window: later ticks ran plain
    assert 0 < eng.stats["spec_ticks"] < eng.stats["decode_steps"]
    assert eng.stats["spec_tokens_accepted"] > 0


def test_sampled_requests_bypass_speculation():
    jm, tm, jp, tp = tiny_pair()
    mixed = (requests(2, [(9, 6)], temperature=0.8, seed=7)
             + requests(3, [(11, 6)]))
    plain = run(ServeEngine(EngineConfig(max_slots=2, max_len=48), tm, tp),
                mixed, stagger=0)
    eng = ServeEngine(EngineConfig(max_slots=2, max_len=48, speculation_k=2,
                                   **SELF), tm, tp, draft_params=tp)
    spec = run(eng, mixed, stagger=0)
    assert [h.tokens for h in spec] == [h.tokens for h in plain]
    assert eng.stats["spec_ticks"] == 0


def test_per_request_and_engine_counters_agree():
    jm, tm, jp, tp = tiny_pair()
    eng = ServeEngine(EngineConfig(max_slots=2, max_len=48, speculation_k=2,
                                   **SELF), tm, tp, draft_params=tp)
    handles = run(eng, requests(7, [(7, 8), (12, 6)]), stagger=0)
    assert sum(h.spec_proposed for h in handles) == \
        eng.stats["spec_tokens_proposed"] > 0
    assert sum(h.spec_accepted for h in handles) == \
        eng.stats["spec_tokens_accepted"] > 0
    tp_ = eng.throughput()
    assert tp_["spec_acceptance_rate"] == pytest.approx(
        eng.stats["spec_tokens_accepted"] / eng.stats["spec_tokens_proposed"])
    assert tp_["dispatches_per_token"] < 1.0
    assert tp_["ttft_mean_s"] > 0 and tp_["tpot_mean_s"] > 0
