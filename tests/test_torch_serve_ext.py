"""The serving extensions of the port (ROADMAP item 5) against the JAX
package, and their pins inside the port: the dense per-slot KV layout
and its decode step, the multi-token verify steps, recompute preemption
under a short page pool, the stepped (scan) prefill, the legacy
`ServeSession` loop, deadlines / drain / the pressure ladder, and
`ServeEngine.close`.

Everything runs in fp32 on the CPU with the JAX package's params carried
across by `repro_torch.bridge`. The building blocks are held to the JAX
functions within 1e-5 absolute. The engines are held to the JAX engines
on the same requests and arrivals: greedy tokens and every stat the
reference reports are equal.

Token pins inside the port (dense == paged, scan == parallel, preempted
== unpreempted) compare two paths that round differently where one
computes T rows at once and the other one row at a time (PyTorch's
matmul is not bitwise equal across M). Each pin therefore also states
the logit gap that backs it: along every stream, the smallest top-1 /
top-2 gap of the one-row decode logits must exceed the largest
difference between those and the T-row forward's logits.
"""
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import ModelConfig as JConfig
from repro.engine import EngineConfig as JEC
from repro.engine import GenerationRequest as JReq
from repro.engine import ServeEngine as JEngine
from repro.engine import ServeSession as JSession
from repro.engine.serving import scheduler as JS
from repro.models import attention as JA
from repro.models import build_model as jax_build
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.engine import (EngineConfig, GenerationRequest, ServeEngine,
                                ServeSession)
from repro_torch.engine.serving import PressureLadder
from repro_torch.engine.serving import scheduler as TS
from repro_torch.models import attention as TA
from repro_torch.models import build_model

TINY = dict(name="ext-tiny", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=257, head_dim=16)
ATOL = 1e-5


def tiny_pair(**over):
    """(JAX model, port model, JAX params, port params) of one tiny
    config, fp32 compute on both sides."""
    jcfg = JConfig(**dict(TINY, **over))
    tcfg = ModelConfig(**dict(TINY, **over))
    jm = jax_build(jcfg, compute_dtype=jnp.float32, attn_chunk=16)
    tm = build_model(tcfg, compute_dtype=torch.float32)
    jp = jm.init(jax.random.key(0))
    return jm, tm, jp, to_port(jp)


def to_port(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def requests(rng_seed, shapes, **kw):
    rng = np.random.RandomState(rng_seed)
    return [dict(prompt=rng.randint(0, TINY["vocab_size"], n),
                 max_new_tokens=g, **kw) for n, g in shapes]


def run(engine, reqs, stagger=1):
    """Submit `reqs` `stagger` ticks apart on either package's engine,
    drain; returns the handles."""
    Req = JReq if isinstance(engine, JEngine) else GenerationRequest
    handles = []
    for r in reqs:
        handles.append(engine.submit(Req(**r)))
        for _ in range(stagger):
            engine.step()
    engine.drain()
    return handles


def both(jm, tm, jp, tp, reqs, stagger=1, jdraft=None, **cfg):
    """The same workload on the JAX engine and the port's; returns
    (JAX engine, port engine, JAX handles, port handles)."""
    cfg.setdefault("max_slots", 2)
    cfg.setdefault("max_len", 48)
    je = JEngine(JEC(**cfg), jm, None, jp, draft_params=jdraft)
    te = ServeEngine(EngineConfig(**cfg), tm, tp, draft_params=(
        None if jdraft is None else to_port(jdraft)))
    return je, te, run(je, reqs, stagger), run(te, reqs, stagger)


# the stats both engines report; each must be equal
STAT_KEYS = ("completed", "generated_tokens", "prefill_calls",
             "decode_steps", "preemptions", "retries", "failed",
             "deadline_kills", "drained", "spec_ticks",
             "spec_tokens_proposed", "spec_tokens_accepted",
             "draft_prefills", "prefix_hits", "cow_copies",
             "kv_bytes_in_use", "peak_kv_bytes_in_use", "kv_pages_used")


def assert_same_run(je, te, jh, th):
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    assert [h.finish_reason for h in th] == [h.finish_reason for h in jh]
    for k in STAT_KEYS:
        assert te.stats[k] == je.stats[k], k
    assert te.leaked_pages() == je.leaked_pages() == 0


def gap_and_diff(model, params, prompt, tokens):
    """(smallest top-1/top-2 gap, largest |T-row forward - one-row
    decodes|) of the logits at the positions that produced `tokens`;
    also checks that `tokens` is the one-row decodes' greedy stream."""
    seq = torch.from_numpy(np.concatenate(
        [prompt, tokens[:-1]]).astype(np.int32))[None]
    with torch.no_grad():
        par = model.forward(params, seq)[0].float()
        cache = model.init_cache(params, 1, seq.shape[1] + 1)
        step = []
        for i in range(seq.shape[1]):
            lg, cache = model.decode_step(params, seq[:, i:i + 1], cache)
            step.append(lg[0, -1].float())
        step = torch.stack(step)
    rows = slice(len(prompt) - 1, seq.shape[1])
    assert step[rows].argmax(-1).tolist() == list(tokens)
    top2 = torch.topk(step[rows], 2, dim=-1).values
    return ((top2[:, 0] - top2[:, 1]).min().item(),
            (par[rows] - step[rows]).abs().max().item())


def assert_pin(model, params, reqs, got, want):
    """Token pin: equal streams, backed by a logit gap wider than the
    rounding between the paths (reported on failure)."""
    assert got == want
    for r, toks in zip(reqs, want):
        gap, diff = gap_and_diff(model, params, r["prompt"], toks)
        assert gap > diff, f"logit gap {gap:.3g} <= path difference {diff:.3g}"


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


# ------------------------------------------------------- building blocks
def _layer0(tree):
    return jax.tree.map(lambda x: x[0], tree)


@pytest.mark.parametrize("case", ["scalar", "per_slot", "swa"])
def test_gqa_decode_step_matches_reference(case):
    over = {"sliding_window": 8} if case == "swa" else {}
    jm, tm, jp, tp = tiny_pair(**over)
    ja = _layer0(jp["blocks"]["attn"])
    ta = to_port(ja)
    B, cap, KV, Dh = 3, (8 if case == "swa" else 24), 2, 16
    rng = np.random.RandomState(1)
    x = rng.randn(B, 1, 64).astype(np.float32)
    k = rng.randn(B, cap, KV, Dh).astype(np.float32)
    v = rng.randn(B, cap, KV, Dh).astype(np.float32)
    # past the window on the SWA case: rows wrap and mask by position
    pos = (np.int32(5) if case == "scalar" else
           np.asarray([3, 11, 20] if case == "swa" else [0, 9, 23],
                      np.int32))
    jout, jc = JA.gqa_decode_step(ja, jm.cfg, jnp.asarray(x), JA.KVCache(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)), jnp.float32)
    tc = TA.KVCache(torch.tensor(k), torch.tensor(v), torch.tensor(pos))
    tout, tc = TA.gqa_decode_step(ta, tm.cfg, torch.tensor(x), tc,
                                  torch.float32)
    _close(tout, jout)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


@pytest.mark.parametrize("case", ["dense", "dense_swa", "paged"])
def test_verify_steps_match_reference(case):
    over = {"sliding_window": 16} if case == "dense_swa" else {}
    jm, tm, jp, tp = tiny_pair(**over)
    ja = _layer0(jp["blocks"]["attn"])
    ta = to_port(ja)
    B, T, cap, KV, Dh, ps = 3, 4, 16, 2, 16, 4
    rng = np.random.RandomState(2)
    x = rng.randn(B, T, 64).astype(np.float32)
    pos = np.asarray([0, 5, 12], np.int32)          # pos + T - 1 < cap
    if case == "paged":
        NP = B * cap // ps + 1
        k = rng.randn(NP, ps, KV, Dh).astype(np.float32)
        v = rng.randn(NP, ps, KV, Dh).astype(np.float32)
        table = (rng.permutation(NP - 1)[:B * cap // ps] + 1).reshape(
            B, cap // ps).astype(np.int32)
        jc = JA.PagedKVCache(jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(table), jnp.asarray(pos))
        tc = TA.PagedKVCache(torch.tensor(k), torch.tensor(v),
                             torch.tensor(table), torch.tensor(pos))
        jout, jc = JA.gqa_paged_verify_step(ja, jm.cfg, jnp.asarray(x), jc,
                                            jnp.float32)
        tout, tc = TA.gqa_paged_verify_step(ta, tm.cfg, torch.tensor(x), tc,
                                            torch.float32)
    else:
        k = rng.randn(B, cap, KV, Dh).astype(np.float32)
        v = rng.randn(B, cap, KV, Dh).astype(np.float32)
        jc = JA.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
        tc = TA.KVCache(torch.tensor(k), torch.tensor(v), torch.tensor(pos))
        jout, jc = JA.gqa_verify_step(ja, jm.cfg, jnp.asarray(x), jc,
                                      jnp.float32)
        tout, tc = TA.gqa_verify_step(ta, tm.cfg, torch.tensor(x), tc,
                                      torch.float32)
    _close(tout, jout)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    np.testing.assert_array_equal(tc.pos.numpy(), pos)   # unchanged


# ------------------------------------------------------------ host pieces
LADDER_SEQ = [(1.0, 0), (0.3, 0), (0.2, 0), (0.2, 40), (0.05, 9),
              (0.01, 0), (0.03, 0), (0.2, 0), (0.3, 0), (0.4, 0),
              (0.5, 33), (0.5, 0), (0.0, 0), (1.0, 0)]


def test_pressure_ladder_matches_reference():
    mine, ref = PressureLadder(), JS.PressureLadder()
    for ff, q in LADDER_SEQ:
        assert mine.update(free_frac=ff, queue_len=q, max_slots=2) == \
            ref.update(free_frac=ff, queue_len=q, max_slots=2)
        assert (mine.name, mine.changes) == (ref.name, ref.changes)


def _sched_ops(S, Req):
    """One op sequence through a scheduler module -> observable trace."""
    sched = S.ContinuousBatchingScheduler(2, 64)
    hs = [S.RequestHandle(Req(prompt=np.arange(4) + i, max_new_tokens=4,
                              max_retries=r, deadline_s=d))
          for i, (r, d) in enumerate([(None, None), (0, None), (1, 0.5),
                                      (None, 2.0)])]
    for i, h in enumerate(hs):
        h.submitted_at = 100.0 + i
        sched.submit(h)

    def state():
        return ([(h.status, h.finish_reason, h.retries, h.slot, h.done,
                  h.failed, h.past_deadline(101.7)) for h in hs],
                [hs.index(h) for h in sched.queue], sorted(sched.active))
    trace = [[hs.index(h) for _, h in sched.admit()], state()]
    sched.preempt(1)                   # hs[1]: budget 0 -> fails
    trace.append(state())
    sched.admit()
    sched.preempt(0)                   # hs[0]: no budget -> queue front
    trace.append(state())
    trace.append([hs.index(h) for h in sched.expired(101.7)])
    sched.fail(hs[2], "deadline")      # running
    sched.fail(hs[3], "drained")       # queued
    sched.fail(hs[3], "again")         # idempotent
    trace.append(state())
    return trace


def test_scheduler_resilience_matches_reference():
    assert _sched_ops(TS, GenerationRequest) == _sched_ops(JS, JReq)


@pytest.mark.parametrize("kw", [dict(deadline_s=0.0), dict(max_retries=-1)])
def test_request_validation(kw):
    for Req in (GenerationRequest, JReq):
        with pytest.raises(ValueError, match=next(iter(kw))):
            Req(prompt=[1, 2], **kw)


# ------------------------------------------------ engines against JAX
@pytest.mark.parametrize("case", ["dense", "scan", "preempt", "drain",
                                  "deadline", "retries"])
def test_engine_matches_reference(case):
    jm, tm, jp, tp = tiny_pair()
    cfg, stagger = {}, 1
    reqs = requests(0, [(7, 6), (13, 9), (19, 4)])
    if case == "dense":
        cfg = dict(kv_layout="dense")
    elif case == "scan":
        cfg = dict(prefill_mode="scan")
    elif case in ("preempt", "retries"):
        reqs = requests(5, [(20, 20), (25, 20), (18, 20)])
        if case == "retries":
            reqs[1]["max_retries"] = 0  # the victim: fails on 'retries'

        cfg = dict(max_slots=3, prefix_sharing=False, kv_pages=6)
    elif case == "deadline":
        reqs[1]["deadline_s"] = 1e-6     # expired by its first tick
    if case == "drain":
        out = []
        for eng in (JEngine(JEC(max_slots=1, max_len=48), jm, None, jp),
                    ServeEngine(EngineConfig(max_slots=1, max_len=48), tm,
                                tp)):
            Req = JReq if isinstance(eng, JEngine) else GenerationRequest
            hs = [eng.submit(Req(**reqs[0]))]
            eng.step()
            hs.append(eng.submit(Req(**reqs[1])))
            eng.request_drain()
            eng.drain()
            out.append((eng, hs))
        (je, jh), (te, th) = out
    else:
        je, te, jh, th = both(jm, tm, jp, tp, reqs, stagger, **cfg)
    assert_same_run(je, te, jh, th)
    tt, jt = te.throughput(), je.throughput()
    for k in set(jt) & set(tt):
        if not k.endswith("_s") and k != "tok_s":
            assert tt[k] == jt[k], k
    if case in ("preempt", "retries"):
        assert te.stats["preemptions"] > 0
    if case == "retries":
        assert [h.finish_reason for h in th][1] == "retries"
    if case == "dense":
        assert te.kv_stats()["kv_layout"] == "dense"


@pytest.mark.parametrize("stepped", [True, False])
def test_legacy_session_matches_reference(stepped):
    jm, tm, jp, tp = tiny_pair()
    prompts = np.random.RandomState(3).randint(0, 257, (2, 9))
    cfg = dict(max_slots=2, max_len=32)
    want = JSession(JEC(**cfg), jm, None, jp).generate(
        jnp.asarray(prompts), 7, stepped_prefill=stepped)
    got = ServeSession(EngineConfig(**cfg), tm, tp).generate(
        prompts, 7, stepped_prefill=stepped)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------ pins in the port
def test_dense_equals_paged_tokens():
    jm, tm, jp, tp = tiny_pair(sliding_window=16)
    reqs = requests(0, [(7, 6), (13, 9), (19, 14)])
    streams = {}
    for layout in ("dense", "paged"):
        eng = ServeEngine(EngineConfig(max_slots=2, max_len=48,
                                       kv_layout=layout), tm, tp)
        streams[layout] = [h.tokens for h in run(eng, reqs)]
    assert_pin(tm, tp, reqs, streams["paged"], streams["dense"])


def test_scan_prefill_first_token_equals_parallel():
    jm, tm, jp, tp = tiny_pair()
    reqs = requests(4, [(5, 1), (11, 1), (16, 1)])
    first = {}
    for mode in ("scan", "parallel"):
        eng = ServeEngine(EngineConfig(max_slots=3, max_len=32,
                                       prefill_mode=mode), tm, tp)
        first[mode] = [h.tokens for h in run(eng, reqs, stagger=0)]
    assert_pin(tm, tp, reqs, first["scan"], first["parallel"])


def test_preempted_equals_unpreempted_tokens():
    """Recompute preemption (test_paged_kv.py:366): a starved arena
    preempts the youngest request; re-admission re-prefills prompt +
    generated, and the streams equal an unconstrained run."""
    jm, tm, jp, tp = tiny_pair()
    reqs = requests(5, [(20, 20), (25, 20), (18, 20)])
    out = {}
    for pages in (0, 6):
        eng = ServeEngine(EngineConfig(max_slots=3, max_len=48,
                                       prefix_sharing=False,
                                       kv_pages=pages), tm, tp)
        out[pages] = (eng, [h.tokens for h in run(eng, reqs)])
    assert out[6][0].stats["preemptions"] >= 1
    assert out[6][0].throughput()["completed"] == 3
    assert_pin(tm, tp, reqs, out[6][1], out[0][1])


def test_close_closes_checkpoint_manager(tmp_path):
    from repro_torch.checkpoint import (AsyncCheckpointManager,
                                        CheckpointManager)
    jm, tm, jp, tp = tiny_pair()
    mgr = AsyncCheckpointManager(str(tmp_path / "a"))
    eng = ServeEngine(EngineConfig(max_slots=1, max_len=16), tm, tp,
                      checkpoint=mgr)
    eng.close()
    assert mgr._pool._shutdown
    # a manager without close, and no manager at all, are fine
    ServeEngine(EngineConfig(max_slots=1, max_len=16), tm, tp,
                checkpoint=CheckpointManager(str(tmp_path / "b"))).close()
    ServeEngine(EngineConfig(max_slots=1, max_len=16), tm, tp).close()


def test_dense_hot_reload_keeps_each_version():
    """A transition tick on the dense layout: the later version decodes
    a copy of the rows, merged per slot; each request's tokens equal an
    engine serving its pinned version alone."""
    jm, tm, jp, tp = tiny_pair()
    new = to_port(jm.init(jax.random.key(7)))
    reqs = requests(6, [(9, 10), (6, 5)])
    eng = ServeEngine(EngineConfig(max_slots=2, max_len=32,
                                   kv_layout="dense"), tm, tp)
    h_old = eng.submit(GenerationRequest(**reqs[0]))
    eng.step()
    eng.swap_params(new)
    h_new = eng.submit(GenerationRequest(**reqs[1]))
    eng.drain()
    assert eng.stats["transition_ticks"] >= 1
    for params, r, h in ((tp, reqs[0], h_old), (new, reqs[1], h_new)):
        solo = ServeEngine(EngineConfig(max_slots=2, max_len=32,
                                        kv_layout="dense"), tm, params)
        assert run(solo, [r])[0].tokens == h.tokens


# --------------------------- resilience (tests/test_chaos.py:540-625)
def _engine(tm, tp, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 48)
    return ServeEngine(EngineConfig(**kw), tm, tp)


def _req(n=8, gen=8, **kw):
    return GenerationRequest(prompt=np.random.RandomState(3).randint(
        0, 257, n), max_new_tokens=gen, **kw)


def test_deadline_kills_are_terminal():
    jm, tm, jp, tp = tiny_pair()
    eng = _engine(tm, tp)
    prefill = eng._prefill

    def slow(*a):                      # a prefill slower than the deadline
        time.sleep(0.05)
        return prefill(*a)
    eng._prefill = slow
    h = eng.submit(_req(deadline_s=0.02))
    eng.drain()
    assert h.done and h.failed and h.finish_reason == "deadline"
    tp_ = eng.throughput()
    assert (tp_["deadline_kills"], tp_["failed"], tp_["completed"]) == \
        (1, 1, 0)
    assert eng.leaked_pages() == 0


def test_no_deadline_requests_unaffected():
    jm, tm, jp, tp = tiny_pair()
    eng = _engine(tm, tp)
    h = eng.submit(_req())
    eng.drain()
    assert h.done and not h.failed and h.finish_reason == "length"
    assert len(h.tokens) == 8


def test_retry_budget_bounds_preemption():
    jm, tm, jp, tp = tiny_pair()
    eng = _engine(tm, tp, page_size=8, kv_pages=7)
    a = eng.submit(_req(16, 24))
    eng.step()
    b = eng.submit(_req(16, 24, max_retries=0))
    eng.drain()
    assert a.done and not a.failed     # oldest ran to completion
    assert b.done
    tp_ = eng.throughput()
    assert tp_["preemptions"] >= 1
    if b.failed:                       # b was the preemption victim
        assert b.finish_reason == "retries" and tp_["failed"] >= 1
    assert eng.leaked_pages() == 0


@pytest.mark.parametrize("how", ["request_drain", "sigterm"])
def test_drain_terminates_queued_requests(how):
    jm, tm, jp, tp = tiny_pair()
    eng = _engine(tm, tp, max_slots=1)
    if how == "sigterm":
        old = signal.getsignal(signal.SIGTERM)
        eng.install_drain_handler()
    try:
        a = eng.submit(_req(8, 4))
        eng.step()                     # a in the slot
        b = eng.submit(_req(8, 4))     # b queued
        if how == "sigterm":
            signal.raise_signal(signal.SIGTERM)   # handled: drain, no exit
        else:
            eng.request_drain()
        assert eng.draining
        eng.drain()
    finally:
        if how == "sigterm":
            signal.signal(signal.SIGTERM, old)
    assert a.done and not a.failed
    assert b.done and b.failed and b.finish_reason == "drained"
    tp_ = eng.throughput()
    assert tp_["drained"] == 1 and tp_["failed"] == 1
    assert eng.leaked_pages() == 0
    eng.flush_prefix()
    assert eng._pool.pages_used == 0


def test_pressure_ladder_sheds_speculation_first():
    """Under a short pool the ladder leaves level 0, and no tick at
    level >= 1 speculates (a self-draft would speculate on every other
    tick)."""
    jm, tm, jp, tp = tiny_pair()
    eng = ServeEngine(EngineConfig(
        max_slots=2, max_len=48, page_size=8, kv_pages=9,
        pressure_ladder=True, speculation_k=2,
        draft_config={"name": "ext-self"}), tm, tp, draft_params=tp)
    ticks = []
    decode_tick = eng._decode_tick

    def watch():
        before = eng.stats["spec_ticks"]
        decode_tick()
        ticks.append((eng._ladder.level, eng.stats["spec_ticks"] - before))
    eng._decode_tick = watch
    a = eng.submit(_req(16, 20))
    b = eng.submit(_req(16, 20))
    eng.drain()
    assert eng.throughput()["degradation_changes"] >= 1
    assert any(lv >= 1 for lv, _ in ticks)
    assert all(n == 0 for lv, n in ticks if lv >= 1)
    assert any(n == 1 for lv, n in ticks if lv == 0)
    assert a.done and b.done and eng.leaked_pages() == 0


def test_ladder_off_keeps_behavior():
    jm, tm, jp, tp = tiny_pair()
    eng = _engine(tm, tp)
    assert "degradation_level" not in eng.throughput()
    assert eng._ladder is None


# ------------------------------ pool pressure (tests/test_paged_kv.py)
def test_cold_prefix_pages_evicted_under_pressure():
    jm, tm, jp, tp = tiny_pair()
    rng = np.random.RandomState(6)
    eng = _engine(tm, tp, max_slots=1, kv_pages=4)   # 3 pages: one slot
    eng.submit(GenerationRequest(rng.randint(0, 257, 20), max_new_tokens=4))
    eng.drain()
    assert len(eng._prefix) == 1
    h = eng.submit(GenerationRequest(rng.randint(0, 257, 30),
                                     max_new_tokens=4))
    eng.drain()                        # needs all 3 pages: evicts
    assert h.done and len(eng._prefix) <= 1


def test_forced_cow_preserves_tokens():
    jm, tm, jp, tp = tiny_pair()
    prompt = np.random.RandomState(7).randint(0, 257, 20)
    ref = run(_engine(tm, tp, kv_layout="dense"),
              [dict(prompt=prompt, max_new_tokens=20)])[0].tokens
    eng = _engine(tm, tp)
    h = eng.submit(GenerationRequest(prompt, max_new_tokens=20))
    eng.step()
    slot = h.slot
    lp = int(eng._host_pos[slot]) // eng._page_size
    pid = int(eng._tables[slot, lp])
    eng._pool.ref([pid])               # an external reader of the page
    eng._shared[slot, lp] = True
    eng._owned[slot, lp] = False
    cows = eng.stats["cow_copies"]
    eng.drain()
    assert eng.stats["cow_copies"] == cows + 1
    assert h.tokens == ref
    eng._pool.release([pid])
    assert eng.leaked_pages() == 0
