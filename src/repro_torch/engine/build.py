"""Runtime construction (the port of `repro/engine/build.py`): the
one-device training step and the serve engine's decode steps.

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
from .registry import make_combiner

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


def _resolve_combine_cfg(rpol: RunPolicy, span: int,
                         explicit: Optional[CombineConfig],
                         strict: bool) -> CombineConfig:
    """The CombineConfig, every policy knob plumbed through. On one
    device the lanes are stacked, so '' (auto) resolves to gspmd_tree;
    an explicit 'rvh' with span > 1 warns and falls back (raises under
    strict), as the reference does for span != dp (build.py:111-143). At
    span <= 1 nothing is exchanged, so 'rvh' runs the one-lane tree."""
    if explicit is not None:
        ccfg = explicit
        requested = explicit.backend
    else:
        requested = rpol.backend or "gspmd_tree"
        ccfg = CombineConfig(
            op=rpol.combine_op, point=rpol.combine_point,
            backend=requested, span=span, per_layer=rpol.per_layer,
            acc_dtype=rpol.acc_dtype, use_pallas=rpol.use_pallas,
            compress=rpol.compress, fused=rpol.fused_combine,
            fusion_threshold_mb=rpol.fusion_threshold_mb)
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
                  combine_impl: str = "kernel") -> Runtime:
    """The one-device training runtime. combine_impl='kernel' runs the
    fused combine's block passes through the kernel wrappers (the CUDA
    kernels on a card, their plain versions on the CPU); 'plain' runs
    the plain versions on any device — the on-card reference for the
    kernels, as `attn_impl` is for attention."""
    if combine_impl not in COMBINE_IMPLS:
        raise ValueError(f"combine_impl={combine_impl!r}; one of "
                         f"{COMBINE_IMPLS}")
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
    opt_kwargs = {}
    if rpol.optimizer in ("adam", "lamb"):
        opt_kwargs["state_dtype"] = getattr(torch, rpol.opt_state_dtype)
    opt = optimizer or get_optimizer(rpol.optimizer, lr, **opt_kwargs)
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
