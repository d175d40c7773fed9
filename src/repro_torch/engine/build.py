"""Runtime construction (the port of `repro/engine/build.py`): the
training step, lanes stacked on one device or one lane per rank, and the
serve engine's decode steps.

train_step anatomy (paper Fig. 3 + §4), on one device:
  1. reshape the global batch to `span` lanes; one lane = one Adasum leaf;
  2. per-lane gradients, lane after lane in a Python loop (not vmap:
     activation memory stays that of one lane), summed over
     `accum_steps` microbatches;
  3. combine the lanes with Sum or Adasum (pre- or post-optimizer by
     the optimizer kind) — the fused bucketed tree by default, whose
     block passes run the CUDA kernels on a card;
  4. apply the combined delta (in place).

`local_steps > 1` reproduces §5.2: each lane takes k local optimizer
steps and the combined quantity is the model delta since the last sync.
Gradients and deltas are detached: the combine and the optimizer run
under `torch.no_grad()`, as in JAX where they sit outside
`value_and_grad`.

Across ranks (`build_runtime(..., comm=Comm of W > 1 ranks)`, one process
per rank, the reference's DP mesh with dp = W): every rank gets the whole
global batch and takes its own rows.
  * span == W: rank r computes lane r's gradient (rows [r·B/W,
    (r+1)·B/W), the reference's lane reshape) and `adasum-rvh` combines
    the lanes across ranks (the paper's Algorithm 1);
  * span < W (the reference's hierarchical gspmd_tree regime): a lane is
    g = W/span contiguous ranks, rank r holding the (r mod g)-th 1/g of
    lane r // g's rows. `lm_loss` is a masked token mean, so the lane
    gradient is the group's rank gradients weighted by mask count, summed
    by an all-reduce in the lane group; RVH then combines the lanes
    across the `span` ranks of equal position (r mod g). The g position
    groups compute the same result.
The optimizer steps at the pre point on replicated state, or at the post
point on each rank's own lane state; every rank ends the step with the
same parameters. Metrics are the lane means, the same on every rank.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch import tree as T
from repro_torch.control.noise import summarize_stats
from repro_torch.core.combine import COMBINE_IMPLS, CombineConfig
from repro_torch.core.dist_opt import DistributedOptimizer
from repro_torch.models.api import Model
from repro_torch.optim.optimizers import Optimizer, get_optimizer
from repro_torch.parallel.policy import RunPolicy
from .registry import make_combiner, registry_key

PyTree = Any


class EngineWarning(UserWarning):
    """Non-fatal engine degradations (e.g. backend fallback)."""


@dataclasses.dataclass
class Runtime:
    """Everything a training loop needs for one (arch, policy) setup on
    one device."""
    model: Model
    rpol: RunPolicy
    span: int
    dopt: DistributedOptimizer
    train_step: Callable        # (state, batch) -> (state, metrics)
    init_state: Callable        # (generator) -> state
    combine_path: str = ""      # the combiner implementation that runs
    combine_stats: bool = False # per-step CombineStats metrics emitted
    dp_total: int = 1
    comm: Any = None            # the ranks' Comm (None: one device)


def _resolve_combine_cfg(rpol: RunPolicy, span: int,
                         explicit: Optional[CombineConfig],
                         strict: bool, dp_total: int = 1) -> CombineConfig:
    """The CombineConfig, every policy knob plumbed through.

    Across ranks (dp_total > 1) the reference's rule (build.py:111-143):
    '' (auto) resolves to rvh at span == dp and to gspmd_tree below it;
    an explicit 'rvh' at span != dp warns and falls back (raises under
    strict). On one device the lanes are stacked, so '' resolves to
    gspmd_tree and an explicit 'rvh' with span > 1 warns and falls back
    (raises under strict); at span <= 1 nothing is exchanged, so 'rvh'
    runs the one-lane tree."""
    if dp_total > 1:
        return _resolve_ranked(rpol, span, dp_total, explicit, strict)
    if explicit is not None:
        ccfg = explicit
        requested = explicit.backend
    else:
        requested = rpol.backend or "gspmd_tree"
        ccfg = _policy_cfg(rpol, span, requested)
    if ccfg.op in ("sum", "mean") or requested != "rvh":
        return ccfg
    if span > 1:
        msg = (f"backend='rvh' needs one lane per DP rank (span={span}, "
               f"dp=1): the lanes sit stacked on one device; falling back "
               f"to 'gspmd_tree'")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, EngineWarning, stacklevel=3)
    return dataclasses.replace(ccfg, backend="gspmd_tree")


def _policy_cfg(rpol: RunPolicy, span: int, backend: str) -> CombineConfig:
    return CombineConfig(
        op=rpol.combine_op, point=rpol.combine_point, backend=backend,
        span=span, per_layer=rpol.per_layer, acc_dtype=rpol.acc_dtype,
        use_pallas=rpol.use_pallas, compress=rpol.compress,
        fused=rpol.fused_combine,
        fusion_threshold_mb=rpol.fusion_threshold_mb)


def _resolve_ranked(rpol, span, dp_total, explicit, strict):
    """The reference's resolution at dp > 1 (build.py:111-143)."""
    if explicit is not None:
        ccfg, requested = explicit, explicit.backend
    else:
        requested = rpol.backend or ("rvh" if span == dp_total
                                     else "gspmd_tree")
        ccfg = _policy_cfg(rpol, span, requested)
    if ccfg.op in ("sum", "mean"):
        return ccfg
    if requested == "rvh" and span != dp_total:
        msg = (f"backend='rvh' needs one lane per DP rank "
               f"(span={span}, dp={dp_total}); falling back to "
               f"'gspmd_tree'. Set span=0 (or span={dp_total}) for the "
               f"paper-faithful RVH reduction.")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, EngineWarning, stacklevel=4)
        ccfg = dataclasses.replace(ccfg, backend="gspmd_tree")
    return ccfg


def _value_and_grad(model: Model):
    """(params, batch) -> ((loss, metrics), grads), all detached."""
    def grad_fn(params, batch):
        leaves, td = T.flatten(params)
        req = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            total, mets = model.loss(T.unflatten(td, req), batch)
            grads = torch.autograd.grad(total, req)
        return ((total.detach(), {k: v.detach() for k, v in mets.items()}),
                T.unflatten(td, list(grads)))
    return grad_fn


def build_runtime(model: Model, rpol: RunPolicy, *, lr=1e-3,
                  combine: Optional[CombineConfig] = None,
                  optimizer: Optional[Optimizer] = None,
                  strict: bool = False,
                  combine_impl: str = "kernel", comm=None) -> Runtime:
    """The training runtime: lanes stacked on one device, or, with `comm`
    (a `repro_torch.parallel.comm.Comm` of more than one rank), one
    process per rank (see the module docstring). combine_impl='kernel'
    runs the combine's block passes through the kernel wrappers (the
    CUDA kernels on a card, their plain versions on the CPU); 'plain'
    runs the plain versions on any device — the on-card reference for
    the kernels, as `attn_impl` is for attention."""
    if combine_impl not in COMBINE_IMPLS:
        raise ValueError(f"combine_impl={combine_impl!r}; one of "
                         f"{COMBINE_IMPLS}")
    if comm is not None and comm.world > 1:
        return _build_ranked(model, rpol, comm, lr=lr, combine=combine,
                             optimizer=optimizer, strict=strict,
                             combine_impl=combine_impl)
    span = rpol.span or 1
    if span & (span - 1):
        raise ValueError(f"span={span} must be a power of two")
    ccfg = _resolve_combine_cfg(rpol, span, combine, strict)
    if rpol.combine_delay:
        from repro_torch.runtime import ITEM_SUBSYSTEMS, not_ported
        raise not_ported("the delayed combine (combine_delay > 0)",
                         ITEM_SUBSYSTEMS)
    # the runtime owns the stacked lane tensors it hands the combiner,
    # so the combiner may free them as it packs them
    combiner = make_combiner(ccfg, impl=combine_impl, donate=True)
    scombiner = None
    if rpol.combine_stats and span > 1:
        scombiner = make_combiner(ccfg, with_stats=True, impl=combine_impl,
                                  donate=True)
    opt = _make_opt(rpol, lr, optimizer)
    dopt = DistributedOptimizer(opt, ccfg, combiner, span)
    grad_fn = _value_and_grad(model)

    def init_state(generator: torch.Generator) -> Dict[str, Any]:
        params = model.init(generator)
        return {"params": params, "opt": dopt.init(params), "step": 0}

    def split_lanes(batch):
        return T.map(lambda x: x.reshape((span, x.shape[0] // span)
                                         + tuple(x.shape[1:])), batch)

    def lane_grads(params, lanes):
        """Stacked per-lane gradients [span, ...] and per-lane metrics.
        With accum_steps = A > 1 the lane batch runs in A microbatches
        and the lane gradient is their SUM, carried in accum_dtype
        (build.py:325-336) — A times the lane's mean gradient, as in the
        reference; the lane metrics are the microbatch means."""
        A = rpol.accum_steps
        G = None
        mets = []
        for i in range(span):
            lane = T.map(lambda x: x[i], lanes)
            micro = [lane] if A <= 1 else [
                T.map(lambda x: x.reshape((A, x.shape[0] // A)
                                          + tuple(x.shape[1:]))[j], lane)
                for j in range(A)]
            lane_mets = []
            for j, mb in enumerate(micro):
                (_, m), g = grad_fn(params, mb)
                lane_mets.append(m)
                if G is None:
                    acc_dt = (getattr(torch, rpol.accum_dtype) if A > 1
                              else None)
                    alloc = torch.zeros if A > 1 else torch.empty
                    G = T.map(lambda x: alloc(
                        (span,) + tuple(x.shape), dtype=acc_dt or x.dtype,
                        device=x.device), g)
                if A <= 1:
                    T.map(lambda out, x: out[i].copy_(x), G, g)
                else:
                    T.map(lambda out, x: out[i].copy_(out[i].float()
                                                      + x.float()), G, g)
                del g
            mets.append({k: torch.stack([m[k] for m in lane_mets]).mean()
                         for k in lane_mets[0]})
        return G, mets

    def stat_metrics(stats, batch):
        rows = T.leaves(batch)[0].shape[0]
        return summarize_stats(stats, span, rows // span)

    def _metrics(lane_mets):
        metrics = {k: torch.stack([m[k] for m in lane_mets]).mean()
                   for k in lane_mets[0]}
        metrics["grad_lanes"] = torch.tensor(span, dtype=torch.int32)
        return metrics

    def sync_step(state, batch):
        params = state["params"]
        G, lane_mets = lane_grads(params, split_lanes(batch))
        with torch.no_grad():
            if scombiner is not None:
                delta, opt_state, stats = dopt.update_stats(
                    G, state["opt"], params, scombiner)
            else:
                delta, opt_state = dopt.update(G, state["opt"], params)
                stats = None
            del G
            dopt.apply(params, delta)
        metrics = _metrics(lane_mets)
        if stats is not None:
            metrics.update(stat_metrics(stats, batch))
        return {"params": params, "opt": opt_state,
                "step": state["step"] + 1}, metrics

    def local_deltas(params, opt_state, batch):
        """Per-lane local optimizer deltas (paper §5.2): each lane takes
        k = local_steps optimizer steps on its own microbatches from the
        shared params. Returns (fp32 deltas [span, ...], new inner state,
        metrics)."""
        k = max(rpol.local_steps, 1)
        lanes = split_lanes(batch)
        rows = T.leaves(lanes)[0].shape[1]
        if rows % k or rows < k:
            raise ValueError(f"local_steps={k} needs global_batch >= "
                             f"span*k (got {rows} rows/lane)")
        per_lane_state = span > 1 and dopt.point == "post"
        deltas, inner, lane_mets = None, None, []
        for i in range(span):
            lane = T.map(lambda x: x[i], lanes)
            if per_lane_state:
                oi = T.map(lambda x: x[i], opt_state["inner"])
            else:      # every lane starts from the shared state
                oi = T.map(lambda x: x.clone(), opt_state["inner"])
            p = T.map(lambda x: x.clone(), params)
            mets = []
            for j in range(k):
                mb = T.map(lambda x: x.reshape((k, x.shape[0] // k)
                                               + tuple(x.shape[1:]))[j],
                           lane)
                (_, m), g = grad_fn(p, mb)
                mets.append(m)
                with torch.no_grad():
                    d, oi = dopt.opt.update(g, oi, p, opt_state["step"] + j)
                    dopt.apply(p, d)
                del g, d
            with torch.no_grad():
                if deltas is None:
                    deltas = T.map(lambda x: torch.empty(
                        (span,) + tuple(x.shape), dtype=torch.float32,
                        device=x.device), params)
                T.map(lambda out, e, s: out[i].copy_(e.float() - s.float()),
                      deltas, p, params)
            del p
            if i == 0:
                inner = oi
            lane_mets.append({n: torch.stack([m[n] for m in mets]).mean()
                              for n in mets[0]})
        if per_lane_state:
            inner = opt_state["inner"]
        return deltas, inner, _metrics(lane_mets)

    def local_sgd_step(state, batch):
        """Paper §5.2: k local optimizer steps, then Adasum of the deltas."""
        deltas, inner, metrics = local_deltas(state["params"], state["opt"],
                                              batch)
        with torch.no_grad():
            if scombiner is not None:
                delta, stats = scombiner(deltas)
                metrics.update(stat_metrics(stats, batch))
            else:
                delta = combiner(deltas)
            del deltas
            dopt.apply(state["params"], delta)
        return {"params": state["params"],
                "opt": {"inner": inner,
                        "step": state["opt"]["step"] + rpol.local_steps},
                "step": state["step"] + 1}, metrics

    step_fn = local_sgd_step if rpol.local_steps > 1 else sync_step
    return Runtime(model, rpol, span, dopt, step_fn, init_state,
                   combine_path=getattr(combiner, "combine_path", ""),
                   combine_stats=scombiner is not None)


def _make_opt(rpol: RunPolicy, lr, optimizer: Optional[Optimizer]):
    opt_kwargs = {}
    if rpol.optimizer in ("adam", "lamb"):
        opt_kwargs["state_dtype"] = getattr(torch, rpol.opt_state_dtype)
    return optimizer or get_optimizer(rpol.optimizer, lr, **opt_kwargs)


def _build_ranked(model: Model, rpol: RunPolicy, comm, *, lr, combine,
                  optimizer, strict, combine_impl) -> Runtime:
    """One process per rank; see the module docstring."""
    from repro_torch.runtime import (ITEM_MULTI_RANK, ITEM_SUBSYSTEMS,
                                     not_ported)
    W = comm.world
    span = rpol.span or W
    if span & (span - 1) or W % span:
        raise ValueError(f"span={span} must be a power of two dividing "
                         f"dp={W}")
    ccfg = _resolve_combine_cfg(rpol, span, combine, strict, dp_total=W)
    if rpol.combine_delay:
        raise not_ported("the delayed combine (combine_delay > 0)",
                         ITEM_SUBSYSTEMS)
    key = registry_key(ccfg.op, ccfg.backend)
    if key not in ("adasum-rvh", "adasum-gspmd", "adasum-fused"):
        raise not_ported(
            f"combiner {key!r} across ranks", ITEM_MULTI_RANK,
            "across ranks this slice runs the Adasum tree as RVH (op "
            "'adasum' with backend '', 'rvh', 'gspmd_tree' or 'fused', or "
            "'adasum-rvh')")
    g = W // span                      # ranks in a lane group
    if g > 1 and (rpol.accum_steps > 1 or rpol.local_steps > 1):
        raise not_ported(
            "accum_steps / local_steps at span < dp", ITEM_MULTI_RANK,
            "the composition of a lane's microbatches across the ranks of "
            "its lane group is not written yet")
    if ccfg.backend != "rvh" and g == 1 and span > 1:
        warnings.warn(
            f"backend={ccfg.backend!r} with one lane per rank (span == "
            f"dp={W}): the lanes' Adasum tree runs as RVH across the "
            f"ranks, the same function", EngineWarning, stacklevel=3)
    rvh_cfg = dataclasses.replace(ccfg, op="adasum", backend="rvh")
    if g > 1:     # both splits on every rank, in this order (collective)
        lane_comm = comm.split([list(range(l * g, (l + 1) * g))
                                for l in range(span)])
        rvh_comm = comm.split([list(range(q, W, g)) for q in range(g)])
    else:
        lane_comm, rvh_comm = None, comm
    combiner = make_combiner(rvh_cfg, impl=combine_impl, donate=True,
                             comm=rvh_comm)
    scombiner = None
    if rpol.combine_stats and span > 1:
        scombiner = make_combiner(rvh_cfg, with_stats=True,
                                  impl=combine_impl, donate=True,
                                  comm=rvh_comm)
    dopt = DistributedOptimizer(_make_opt(rpol, lr, optimizer), ccfg,
                                combiner, span, stacked=False)
    grad_fn = _value_and_grad(model)
    r = comm.rank

    def init_state(generator: torch.Generator) -> Dict[str, Any]:
        """Every rank draws from its generator; rank 0's params are then
        broadcast (Horovod's broadcast_parameters)."""
        params = model.init(generator)
        for x in T.leaves(params):
            comm.broadcast(x, 0)
        return {"params": params, "opt": dopt.init(params), "step": 0}

    def rank_rows(batch):
        """Rank r's rows of the global batch, [r·B/W, (r+1)·B/W): lane r's
        rows at span == W, the (r mod g)-th 1/g of lane r // g's rows
        below it. Returns (rows, the rank's weight in its lane)."""
        B = T.leaves(batch)[0].shape[0]
        if B % W:
            raise ValueError(f"global batch {B} not divisible by dp={W}")
        per = B // W
        mine = T.map(lambda x: x[r * per:(r + 1) * per], batch)
        if g == 1:
            return mine, 1.0
        # lm_loss is a token mean over labels >= 0: the lane gradient is
        # the ranks' gradients weighted by their share of the lane's tokens
        lane = (r // g) * (B // span)
        count = lambda x: float((x >= 0).sum())
        whole = count(batch["labels"][lane:lane + B // span])
        return mine, count(mine["labels"]) / max(whole, 1.0)

    def rank_grads(params, batch):
        """This rank's lane gradient (summed over accum_steps microbatches
        in accum_dtype, build.py:325-336; all-reduced over the lane group
        below span == W), its metrics and its lane weight."""
        mine, w = rank_rows(batch)
        A = rpol.accum_steps
        micro = [mine] if A <= 1 else [
            T.map(lambda x: x.reshape((A, x.shape[0] // A)
                                      + tuple(x.shape[1:]))[j], mine)
            for j in range(A)]
        G, mets = None, []
        for mb in micro:
            (_, m), gr = grad_fn(params, mb)
            mets.append(m)
            if A <= 1:
                G = gr
                continue
            if G is None:
                acc_dt = getattr(torch, rpol.accum_dtype)
                G = T.map(lambda x: torch.zeros(x.shape, dtype=acc_dt,
                                                device=x.device), gr)
            T.map(lambda out, x: out.copy_(out.float() + x.float()), G, gr)
            del gr
        if lane_comm is not None:
            with torch.no_grad():
                for x in T.leaves(G):
                    lane_comm.allreduce(x.mul_(w))
        return G, _mean(mets), w

    def _mean(mets):
        return {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}

    def lane_metrics(mets, w):
        """Mean over lanes of the lane metrics, the same bits on every
        rank: each rank's weighted share, summed in rank order."""
        keys = sorted(mets)
        v = torch.stack([mets[k].float() for k in keys]) * w
        tot = comm.group_sum(v, W) / span
        out = {k: tot[i] for i, k in enumerate(keys)}
        out["grad_lanes"] = torch.tensor(span, dtype=torch.int32)
        return out

    def stat_metrics(stats, batch):
        rows = T.leaves(batch)[0].shape[0]
        return summarize_stats(stats, span, rows // span)

    def sync_step(state, batch):
        params = state["params"]
        G, mets, w = rank_grads(params, batch)
        with torch.no_grad():
            if scombiner is not None:
                delta, opt_state, stats = dopt.update_stats(
                    G, state["opt"], params, scombiner)
            else:
                delta, opt_state = dopt.update(G, state["opt"], params)
                stats = None
            del G
            dopt.apply(params, delta)
        metrics = lane_metrics(mets, w)
        if stats is not None:
            metrics.update(stat_metrics(stats, batch))
        return {"params": params, "opt": opt_state,
                "step": state["step"] + 1}, metrics

    def local_sgd_step(state, batch):
        """Paper §5.2 at span == W: k local optimizer steps on this
        rank's lane, then Adasum of the deltas. At the post point each
        rank keeps its own state; at the pre point every lane starts from
        the shared state and lane 0's ends the step (build.py:399)."""
        k = rpol.local_steps
        params, opt_state = state["params"], state["opt"]
        mine, _ = rank_rows(batch)
        rows = T.leaves(mine)[0].shape[0]
        if rows % k or rows < k:
            raise ValueError(f"local_steps={k} needs global_batch >= "
                             f"span*k (got {rows} rows/lane)")
        post = dopt.point == "post"
        oi = opt_state["inner"]
        if not post:
            oi = T.map(lambda x: x.clone(), oi)
        p = T.map(lambda x: x.clone(), params)
        mets = []
        for j in range(k):
            mb = T.map(lambda x: x.reshape((k, x.shape[0] // k)
                                           + tuple(x.shape[1:]))[j], mine)
            (_, m), gr = grad_fn(p, mb)
            mets.append(m)
            with torch.no_grad():
                d, oi = dopt.opt.update(gr, oi, p, opt_state["step"] + j)
                dopt.apply(p, d)
            del gr, d
        metrics = lane_metrics(_mean(mets), 1.0)
        with torch.no_grad():
            delta = T.map(lambda e, s: e.float() - s.float(), p, params)
            del p
            if scombiner is not None:
                combined, stats = scombiner(delta)
                metrics.update(stat_metrics(stats, batch))
            else:
                combined = combiner(delta)
            del delta
            dopt.apply(params, combined)
            if not post:
                for x in T.leaves(oi):
                    comm.broadcast(x, 0)
        return {"params": params,
                "opt": {"inner": oi, "step": opt_state["step"] + k},
                "step": state["step"] + 1}, metrics

    step_fn = local_sgd_step if rpol.local_steps > 1 else sync_step
    return Runtime(model, rpol, span, dopt, step_fn, init_state,
                   combine_path="rvh" if g == 1 else "hier-rvh",
                   combine_stats=scombiner is not None, dp_total=W,
                   comm=comm)


def _row_generator(device: torch.device, seed: int,
                   pos: int) -> torch.Generator:
    """One generator per (request seed, token position): token t of a
    request is a pure function of (seed, t), whatever the batch."""
    key = ((int(seed) & 0xFFFFFFFF) << 32) | (int(pos) & 0xFFFFFFFF)
    return torch.Generator(device=device).manual_seed(key)


def sample_logits(logits: torch.Tensor, seeds: Sequence[int],
                  pos: Sequence[int], temperature: Sequence[float],
                  top_k: Sequence[int], top_p: Sequence[float]
                  ) -> torch.Tensor:
    """Per-row token sampling: [B, V] logits -> [B] int32 tokens.

    Rows with temperature <= 0 take the greedy argmax (first index on
    ties, as `jnp.argmax`). Sampled rows apply temperature, then top-k
    (k == 0 disables) and nucleus top-p (p >= 1 disables) truncation,
    then a Gumbel-max draw from a generator seeded by (seed, pos). The
    policy rows are host sequences of length B. The draws cannot match
    the reference's `jax.random` noise; they are deterministic in the
    port."""
    B, V = logits.shape
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    ranks = torch.arange(V, device=logits.device)
    for b in range(B):
        t = float(temperature[b])
        if t <= 0:
            continue
        lg = logits[b].float() / max(t, 1e-6)
        xs, order = torch.sort(lg, descending=True, stable=True)
        k = int(top_k[b])
        if k > 0:
            xs = torch.where(ranks >= k, float("-inf"), xs)
        probs = torch.softmax(xs, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs     # exclusive prefix mass
        tp = float(top_p[b])
        if tp < 1.0:
            xs = torch.where(cum < tp, xs, float("-inf"))
        u = torch.rand(V, generator=_row_generator(logits.device, seeds[b],
                                                   pos[b]),
                       device=logits.device, dtype=torch.float32)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
        out[b] = order[torch.argmax(xs + gumbel)].to(torch.int32)
    return out


def make_batched_decode_step(model: Model):
    """Slotted greedy decode step for continuous batching: the paged
    cache carries a per-slot position vector, so one call advances B
    requests sitting at different sequence lengths. Rows whose slot is
    free compute garbage through trash page 0 that the next admission
    overwrites. Returns (next tokens int32 [B,1], cache)."""
    def decode_step(params, tokens, cache):
        logits, cache = model.decode_step(params, tokens, cache)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], cache
    return decode_step


def make_sampling_decode_step(model: Model):
    """`make_batched_decode_step` with per-slot sampling policies (host
    rows of length B; greedy rows stay argmax via `sample_logits`)."""
    def decode_step(params, tokens, cache, seeds, pos, temperature, top_k,
                    top_p):
        logits, cache = model.decode_step(params, tokens, cache)
        nxt = sample_logits(logits[:, -1, :], seeds, pos, temperature,
                            top_k, top_p)
        return nxt[:, None], cache
    return decode_step


def make_serve_step(model: Model):
    """One greedy decode step of the legacy batch loop: tokens [B,1] ->
    (next tokens [B,1] in the tokens' dtype, cache)."""
    def serve_step(params, tokens, cache):
        logits, cache = model.decode_step(params, tokens, cache)
        nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(tokens.dtype)
        return nxt, cache
    return serve_step


def make_verify_step(model: Model):
    """Greedy speculative verification, ONE target forward per tick
    (build.py:558).

    tokens [B, k+1] = [last committed token, draft_1..draft_k]; the
    model's verify_step scores all k+1 positions (writing their K/V
    rows), then: per-slot greedy argmax g [B, k+1], acceptance = the
    longest prefix of drafts matching g, and the cache pos set to pos +
    accepted + 1 — which commits the accepted rows and rolls back the
    rejected ones. Returns (next feed token [B,1], g [B,k+1], accepted
    [B], cache); row b commits g[b, :accepted[b]+1]."""
    from .serving.slots import set_positions, slot_positions

    def verify(params, tokens, cache):
        pos = slot_positions(cache)
        logits, cache = model.verify_step(params, tokens, cache)
        g = torch.argmax(logits, dim=-1).to(torch.int32)         # [B,k+1]
        match = (g[:, :-1] == tokens[:, 1:]).to(torch.int32)
        acc = torch.cumprod(match, dim=1).sum(dim=1)             # [B] 0..k
        cache = set_positions(cache, pos + acc + 1)
        nxt = torch.gather(g, 1, acc[:, None].long())            # [B,1]
        return nxt, g, acc, cache
    return verify


def make_draft_propose(draft_model: Model, k: int):
    """k greedy draft tokens per slot from k+1 draft decode steps over
    the draft's dense per-slot cache (the reference's `lax.scan`,
    build.py:589, as a loop that never waits for the device: each
    argmax feeds the next step on the card). `pos` [B] (the committed
    position per slot) is written into the draft cache first — that
    rewrite heals last tick's overrun.

    tokens [B,1] = last committed token; returns (drafts [B,k], cache
    at pos + k + 1).

    k+1 steps, not k: step t writes the K/V row of its INPUT token, so k
    steps would leave d_k proposed but never fed — a hole at row pos+k.
    After a full-accept tick the target commits through d_k and the
    next propose would attend across that hole, and acceptance would
    collapse. The extra step feeds d_k (its output is discarded)."""
    from .serving.slots import set_positions

    def propose(params, tokens, cache, pos):
        cache = set_positions(cache, pos)
        tok, drafts = tokens, []
        for _ in range(k + 1):
            logits, cache = draft_model.decode_step(params, tok, cache)
            tok = torch.argmax(logits[:, -1, :], dim=-1).to(
                torch.int32)[:, None]
            drafts.append(tok)
        return torch.cat(drafts[:k], dim=1), cache               # [B,k]
    return propose
