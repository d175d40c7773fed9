"""The port's elastic driver (`fit_elastic`) across gloo rank processes on
the CPU, with the reference's own assertions (tests/test_chaos.py
TestElasticRoundTrip, tests/test_pipeline.py's two-restart drill; 4 ranks
here where the reference takes 8 devices, so 4 -> 2 -> 4 and 4 -> 2 -> 1),
and the agreements the port needs because it runs one process a rank:
every rank takes the same decisions (elastic logs, LR, a straggler flag
on one rank restarts all of them), params are bitwise equal across the
active ranks after every step and bitwise equal to the same run composed
by hand from plain sessions; and the lane-state restore across a span
change: each rank's optimizer state and delayed carry after 4 -> 2 ranks
are the reference's `reshard_lanes` fold of the stored [4, ...] leaf
(the mean of its two old lanes), and after 2 -> 4 its repeat. One
process: dp is 1, so a loss re-raises after the boundary save and a
grow-back resumes as it is (the reference at dp=1).

The model is the reference control tests' tiny dense decoder
(`ModelConfig("ctl-tiny", "dense", 2, 64, 4, 2, 128, 257,
head_dim=16)`), fp32; weights from a seeded generator.
"""
import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.checkpoint.manager import reshard_lanes as j_reshard_lanes
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.engine import (EngineConfig, FailureInjectionCallback,
                                StragglerCallback, fit_elastic)
from repro_torch.models import build_model
from repro_torch.runtime import GrowBackSignal, NodeLossError, RestartSignal

from torch_dist_workers import launch

BASE = dict(lr=0.01, seq_len=32, global_batch=8, elastic=True, log_every=1,
            ckpt_every=0)
SPEC = {"arch": "tiny", "attn_chunk": 32, "seed": 3}
RUNS = {"adam": dict(BASE, optimizer="adam"),
        "delay": dict(BASE, optimizer="momentum", combine_delay=1)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread in this process: the tiny model's ops gain
    nothing from more, and in a run of several test workers the extra
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tmp, tag, world=4, rc=0, job="elastic", **kw):
    spec = dict(SPEC, dir=str(tmp / f"ck_{tag}"), **kw)
    return launch(world, job, spec, tmp, timeout=240, rc=rc)


# ------------------------------------------------- 4 -> 2 -> 4 round trip
@pytest.fixture(scope="module", params=sorted(RUNS))
def round_trip(request, tmp_path_factory):
    """Node loss at step 2 shrinks 4 -> 2; CapacityReturnCallback grows
    back 2 -> 4 after one step; then the same run composed by hand."""
    tmp = tmp_path_factory.mktemp(f"rt_{request.param}")
    cfg = RUNS[request.param]
    ranks = _run(tmp, "el", steps=6, config=cfg, fail_at=[2], grow_delay=1)
    lr1 = ranks[0]["log"]["plans"][-1]["new_lr"]
    composed = _run(tmp, "plain", job="compose", config=cfg, segments=[
        (4, 2, cfg["lr"]), (2, 3, cfg["lr"]), (4, 6, lr1)])
    return request.param, ranks, composed


def test_round_trip_resumes_contiguous(round_trip):
    """The reference's acceptance: 4 -> (loss at step 2) -> 2 ->
    (capacity back after step 2) -> 4; the stream is consumed once in
    order (step 2 recorded, aborted at its start, replayed once); the
    parked ranks rejoin at step 3."""
    _, ranks, _ = round_trip
    for r in ranks[:2]:
        assert r["dps"] == [(0, 4, 4), (2, 2, 2), (3, 4, 4)], r["dps"]
        assert r["seen"] == [0, 1, 2, 2, 3, 4, 5], r["seen"]
        assert r["hist"] == list(range(6))
    for r in ranks[2:]:                      # evicted at step 2
        assert r["dps"] == [(0, 4, 4), (3, 4, 4)], r["dps"]
        assert r["hist"] == [0, 1, 3, 4, 5]
    for r in ranks:
        assert np.isfinite(r["losses"]).all()
        assert r["dp"] == 4


def test_round_trip_logs_and_lr_agree(round_trip):
    """elastic_log, resilience and the LR are the same on every rank; the
    LR restarted at exactly the planned gain-rescaled value (gain 1
    without CombineStats, as under the delayed combine)."""
    tag, ranks, _ = round_trip
    log = ranks[0]["log"]
    assert log["restarts"] == 1 and log["grow_backs"] == 1
    assert [p["kind"] for p in log["plans"]] == ["shrink", "grow_back"]
    gb = log["plans"][-1]
    assert (gb["old_dp"], gb["new_dp"]) == (2, 4)
    assert 1.0 <= gb["gain"] <= 2.0 + 1e-6, gb
    if tag == "delay":
        assert gb["gain"] == 1.0
    for r in ranks:
        assert _decisions(r["log"]) == _decisions(log)
        assert r["lr"] == gb["new_lr"]
        assert r["resilience"] == {"restore_fallbacks": 0,
                                   "quarantined_steps": [], "restarts": 1,
                                   "grow_backs": 1}


def test_round_trip_bitwise_across_ranks_and_vs_plain_sessions(round_trip):
    """After every step the active ranks hold the same params bits; the
    replayed step fetched the same batch; the final params are bitwise
    the run composed by hand from plain sessions (restore, fit, save)."""
    _, ranks, composed = round_trip
    keys = set().union(*(r["digests"] for r in ranks))
    for key in keys:
        seen = {r["digests"][key] for r in ranks if key in r["digests"]}
        assert len(seen) == 1, key
    assert {k for k in ranks[0]["digests"]} == keys
    sums = {}
    for step, s in ranks[0]["sums"]:
        assert sums.setdefault(step, s) == s, step
    want = composed[0]["params"]
    for r in ranks:
        for a, b in zip(_leaves(r["params"]), _leaves(want)):
            np.testing.assert_array_equal(a, b)


def _decisions(log):
    """The log's decisions (its banked integrity counters differ by rank
    where a parked rank's final log holds rank 0's totals)."""
    return {k: log[k] for k in ("restarts", "grow_backs", "plans")}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# -------------------------------------- a corrupt boundary, SIGTERM, 4->2->1
def test_corrupt_boundary_checkpoint_restores_last_good(tmp_path):
    """make_chaos_on_restart bit-flips the boundary save at step 3 (rank 0
    writes it once): the rebuild quarantines it, falls back to the
    periodic step-2 save and replays step 2 — on every rank, whose
    counters and logs agree."""
    ranks = _run(tmp_path, "bad", steps=5, config=dict(
        BASE, optimizer="adam", ckpt_every=2), fail_at=[3],
        chaos=[(0, "ckpt_bitflip")])
    for r in ranks[:2]:
        assert r["seen"] == [0, 1, 2, 3, 2, 3, 4], r["seen"]
        assert r["hist"] == [0, 1, 2, 2, 3, 4], r["hist"]
    for r in ranks:
        assert r["resilience"]["restore_fallbacks"] == 1, r["resilience"]
        assert r["resilience"]["quarantined_steps"] == [3]
        assert r["pending"] == []
        assert _decisions(r["log"]) == _decisions(ranks[0]["log"])
    # the replayed step 2 fetched the first attempt's batch, bitwise
    sums = {}
    for step, s in ranks[0]["sums"]:
        assert sums.setdefault(step, s) == s, step
    assert (tmp_path / "ck_bad" / "step_00000003.bad").exists()


def test_sigterm_during_elastic_rebuild_window(tmp_path):
    """SIGTERM at the first step of the rebuilt 2-rank session: every rank
    exits 143 (the parked ones told by rank 0), and the checkpoint left
    behind validates."""
    logs = _run(tmp_path, "term", rc=143, steps=6, config=dict(
        BASE, optimizer="adam", async_checkpoint=True), fail_at=[2],
        term=(2, 4))
    assert "restarting at dp=2" in logs[0]
    mgr = CheckpointManager(tmp_path / "ck_term")
    latest = mgr.latest_step()
    assert latest == 2 and mgr.validate_step(latest) == [], latest


def test_two_restarts_one_rank_flagged(tmp_path):
    """The reference's two-restart drill on 4 ranks: node loss at step 3
    (4 -> 2), then rank 1's monitor alone flags a straggler after step 5
    — the flag is OR-reduced, so both ranks restart (2 -> 1); each resumes
    from the checkpointed step with no hyperparameter change, and the run
    ends on one rank's one-device path."""
    ranks = _run(tmp_path, "two", steps=7, config=dict(
        BASE, optimizer="momentum"), fail_at=[3], flag=(1, 5))
    assert ranks[0]["dps"] == [(0, 4, 4), (3, 2, 2), (6, 1, 1)]
    assert ranks[1]["dps"] == [(0, 4, 4), (3, 2, 2)]
    assert ranks[0]["hist"] == list(range(7))
    assert ranks[1]["hist"] == list(range(6))
    assert ranks[0]["dp"] == 1
    # parked at the end: the last session closed, its state dropped
    assert ranks[0]["params"] is not None
    assert all(r["params"] is None for r in ranks[1:])
    for r in ranks:
        assert r["lr"] == BASE["lr"]
        assert r["log"]["restarts"] == 2
        assert [p["new_dp"] for p in r["log"]["plans"]] == [2, 1]


# ----------------------------------------------- lane state, span change
@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lanes")
    cases = {k: {f: v for f, v in c.items()
                 if f not in ("elastic", "log_every", "ckpt_every")}
             for k, c in RUNS.items()}
    ranks = _run(tmp, "lanes", job="lanes", cases=cases)
    return tmp / "ck_lanes", ranks


def _lane_leaves(root, step, ranks, tag, part):
    """(stored [span, ...] leaf, each rank's restored leaf) for every
    lane leaf of the checkpoint at `step`: optimizer state and pending
    carry, the leaves stored with one more axis than each rank holds."""
    d = Path(root) / tag / f"step_{step:08d}"
    out = []
    for e in json.loads((d / "manifest.json").read_text())["leaves"]:
        if not e["path"].startswith(("['opt']['inner']", "['pending']")):
            continue
        keys = re.findall(r"\['([^']+)'\]", e["path"])
        got = []
        for r in ranks:
            node = r[tag][part]
            for k in keys:
                node = None if node is None else node[k]
            got.append(node)
        arr = np.load(d / e["file"])
        if arr.ndim == np.ndim(got[0]) + 1:
            out.append((e["path"], arr, got))
    return out


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_lane_state_folds_on_shrink(lanes, tag):
    """Saved at 4 ranks (one lane a rank: adam's state at the post point,
    the delayed carry), restored on 2: each rank holds the mean of its
    two old lanes — the reference's reshard_lanes of the full leaf, then
    the rank's row — not its old lane's row."""
    root, ranks = lanes
    leaves = _lane_leaves(root, 1, ranks[:2], tag, "folded")
    assert leaves
    for path, arr, got in leaves:
        assert arr.shape[0] == 4, path
        want = j_reshard_lanes(arr, (2,) + arr.shape[1:])
        for rank, g in enumerate(got):
            np.testing.assert_array_equal(g, want[rank], err_msg=path)


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_lane_state_repeats_on_grow(lanes, tag):
    """Saved at 2 ranks, restored on 4: no IndexError, each rank holds
    its lane's repeat (rank r the stored row r // 2)."""
    root, ranks = lanes
    leaves = _lane_leaves(root, 2, ranks, tag, "grown")
    assert leaves
    for path, arr, got in leaves:
        assert arr.shape[0] == 2, path
        want = j_reshard_lanes(arr, (4,) + arr.shape[1:])
        for rank, g in enumerate(got):
            np.testing.assert_array_equal(g, want[rank], err_msg=path)


# ------------------------------------------------------------ one process
def _tiny():
    return build_model(ModelConfig("ctl-tiny", "dense", 2, 64, 4, 2, 128,
                                   257, head_dim=16),
                       compute_dtype=torch.float32, attn_chunk=32)


def test_one_process_loss_reraises_after_boundary_save(tmp_path):
    """dp=1: plan_shrink has nothing to drop, so the driver saves the
    boundary and re-raises (the reference at dp=1); the next run resumes
    from it."""
    cfg = EngineConfig(**BASE, optimizer="momentum", span=2,
                       backend="gspmd_tree", ckpt_dir=str(tmp_path / "ck"))
    with pytest.raises(NodeLossError):
        fit_elastic(cfg, 4, callbacks=[FailureInjectionCallback([2])],
                    model=_tiny(), device="cpu")
    assert CheckpointManager(tmp_path / "ck").latest_step() == 2
    hist, sess = fit_elastic(cfg, 4, callbacks=[], model=_tiny(),
                             device="cpu")
    assert [h["step"] for h in hist] == [2, 3]
    assert sess.run_metadata()["resilience"]["restarts"] == 0
    sess.close()


def test_one_process_grow_back_and_straggler(tmp_path):
    """A grow-back at dp=1 has nowhere to grow: the driver saves and
    resumes as it is; a flagged straggler raises RestartSignal,
    re-raised at dp=1."""
    class GrowOnce:
        fired = False

        def on_fit_start(self, session, start): ...

        def on_step_start(self, session, step): ...

        def on_fit_end(self, session, history): ...

        def on_step_end(self, session, step, metrics, dt):
            if step == 1 and not self.fired:
                self.fired = True
                raise GrowBackSignal(step + 1)

    cfg = EngineConfig(**BASE, optimizer="momentum", span=2,
                       backend="gspmd_tree", ckpt_dir=str(tmp_path / "ck"))
    hist, sess = fit_elastic(cfg, 3, callbacks=[GrowOnce()], model=_tiny(),
                             device="cpu")
    assert [h["step"] for h in hist] == [0, 1, 2]
    # the reference logs only the grow-backs that grew
    assert sess.elastic_log["grow_backs"] == 0
    assert sess.elastic_log["plans"] == []
    sess.close()

    scb = StragglerCallback()

    class Flag:
        def on_fit_start(self, session, start): ...

        def on_step_start(self, session, step): ...

        def on_fit_end(self, session, history): ...

        def on_step_end(self, session, step, metrics, dt):
            scb.monitor.flagged = True

    cfg2 = EngineConfig(**BASE, optimizer="momentum", span=2,
                        backend="gspmd_tree",
                        ckpt_dir=str(tmp_path / "ck2"))
    with pytest.raises(RestartSignal) as ei:
        fit_elastic(cfg2, 3, callbacks=[scb, Flag()], model=_tiny(),
                    device="cpu")
    assert ei.value.step == 1 and [h["step"] for h in ei.value.history] \
        == [0]
    assert CheckpointManager(tmp_path / "ck2").latest_step() == 1


def test_fit_elastic_needs_ckpt_dir():
    with pytest.raises(ValueError, match="ckpt_dir"):
        fit_elastic(EngineConfig(), 1)


def test_lane_fold_of_bf16_state_is_by_value(tmp_path):
    """bf16 lane state (opt_state_dtype='bfloat16') is folded as values,
    not as its raw 16-bit payload: the stacked [2, ...] restore and a
    rank's row at span 2 of a stored [4, ...] leaf are bf16 of the fp32
    mean of each lane pair (the reference cannot read its own bf16
    checkpoints, ROADMAP queue 3)."""
    g = torch.Generator().manual_seed(0)
    lanes = torch.randn(4, 8, generator=g).to(torch.bfloat16)
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(1, {"opt": {"m": lanes}})
    want = lanes.float().reshape(2, 2, 8).mean(dim=1).to(torch.bfloat16)
    live = {"opt": {"m": torch.zeros(2, 8, dtype=torch.bfloat16)}}
    assert torch.equal(mgr.restore(live)["opt"]["m"], want)
    row = {"opt": {"m": torch.zeros(8, dtype=torch.bfloat16)}}
    got = mgr.restore(row, rows={"['opt']['m']": (1, 2)})["opt"]["m"]
    assert torch.equal(got, want[1])
