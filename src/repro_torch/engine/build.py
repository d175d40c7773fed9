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

`combine_delay = 1` (DaSGD-style, build.py:22-30 of the reference):
round i takes its lanes' local optimizer-step deltas, applies their lane
mean at once and parks them in `state["pending"]`; the correction of
round i-1's carry, `combine(pending) - lane_mean(pending)`, folds in at
the end of round i. Step 0 runs on a zero carry, whose correction is
exactly zero. The pieces are on the Runtime (`correction_fn`, `local_fn`,
`fold_fn`), so `runtime.delayed.DelayedCombineStream` can run the
correction beside the local step; `train_step` runs them one after the
other.

Across ranks (`build_runtime(..., comm=Comm of W > 1 ranks)`, one process
per rank, the reference's DP mesh with dp = W): every rank gets the whole
global batch and takes its own rows.
  * span == W: rank r computes lane r's gradient (rows [r·B/W,
    (r+1)·B/W), the reference's lane reshape) and `adasum-rvh` combines
    the lanes across ranks (the paper's Algorithm 1);
  * span < W (the reference's hierarchical gspmd_tree regime): a lane is
    g = W/span contiguous ranks, rank r holding the (r mod g)-th 1/g of
    every microbatch of lane r // g's rows (one microbatch, the whole
    lane, unless accum_steps or local_steps split it). Each rank's loss
    is its exact share of the microbatch's (`parallel.zero.TokenGroup`:
    the label count, and a MoE layer's capacity, slot order and
    load-balance statistics, are the whole microbatch's), so the lane
    group's gradients sum to the microbatch's; the combiner then reduces
    the lanes across the `span` ranks of equal position (r mod g).
The combiner is RVH for the Adasum tree (op 'adasum' with backend '',
'rvh', 'gspmd_tree' or 'fused'), else the registry's entry across ranks
(sum, mean, adasum-linear, adascale, or one registered). The optimizer
steps at the pre point, or at the post point on each rank's own lane
state; every rank ends the step with the same parameters. The data axis
is sharded as the reference's GSPMD shards it (`parallel.zero`),
whatever the combiner: the optimizer state ZeRO-1 (at the pre point,
and at the post point below span == dp), the lane gradients ZeRO-2
under `scatter_grads` below span == dp, the params under `fsdp`. Every
built-in combiner runs on those shards (`registry.py`); a registered
one gets its lane tree whole on the data axis. Metrics are
the lane means, the same on every rank. With
combine_delay the pending carry is this rank's lane delta, its lane mean
the cross-rank mean, and the correction runs on an exchange comm of its
own (a second process group over the same ranks).

The model axis (`model_size` M > 1; the dense, MoE and vision-frontend
decoders, GQA or MLA attention): the ranks
form a (data, model) grid, rank r = d·M + m (`launch.mesh`). A model
group (the M ranks of one data index) runs tensor-parallel forward and
backward passes over its shards (`parallel.tp`, the leaves' specs from
`sharding.param_specs`); a data group (the W ranks of one model index)
runs the synchronous ranked step above on the rank's model shards, data
index d in place of the rank: lanes and lane groups, ZeRO-1, ZeRO-2
and FSDP as the plan cuts them over both axes (`parallel.zero`), every
built-in combiner (RVH's, adasum-linear's and the probe's dots and
adascale's moments summed over the lane group, corrected for the leaves
the model axis does not shard and summed over the model group; sum and
mean element by element); accum_steps too. Every rank of a model group
takes the same rows.
Every sub-communicator is a split of the launch's comm, made on every
rank in one order: the model groups, the data groups, then each data
group's lane groups and RVH groups.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch import tree as T
from repro_torch.control.noise import summarize_stats
from repro_torch.core.combine import (COMBINE_IMPLS, CombineConfig,
                                      build_delayed_correction, lane_mean,
                                      rank_mean)
from repro_torch.core.dist_opt import DistributedOptimizer
from repro_torch.core.rvh import check_whole_model, replication_factors
from repro_torch.launch.mesh import Mesh
from repro_torch.models.api import Model
from repro_torch.optim.optimizers import Optimizer, get_optimizer
from repro_torch.parallel.policy import RunPolicy
from repro_torch.parallel.tp import TensorParallel
from repro_torch.parallel.zero import RankPlan, TokenGroup
from repro_torch.runtime import ITEM_SHARDING, not_ported
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
    # across ranks with the data axis sharded or a model axis: this
    # rank's layouts (`parallel.zero.RankPlan`; None: every leaf whole on
    # every rank — the synchronous step then runs on a plan that shards
    # nothing)
    plan: Any = None
    model_size: int = 1         # ranks of a model group
    model_comm: Any = None      # this rank's model group (M > 1)
    tp: Any = None              # its `parallel.tp.TensorParallel`
    # the delayed combine's pieces (combine_delay = 1 only): train_step
    # == fold(local_fn, correction_fn(pending)); DelayedCombineStream
    # runs correction_fn beside local_fn
    correction_fn: Optional[Callable] = None
    local_fn: Optional[Callable] = None
    fold_fn: Optional[Callable] = None


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


def _value_and_flat_grad(model: Model):
    """(params, batch, **loss kwargs) -> ((loss, metrics), [grad per leaf
    in flatten order]), all detached; a leaf whose gradient autograd does
    not get (an FSDP piece: its gradient goes to the step's store) has
    None."""
    def grad_fn(params, batch, **kw):
        leaves, td = T.flatten(params)
        req = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            total, mets = model.loss(T.unflatten(td, req), batch, **kw)
            grads = torch.autograd.grad(total, req, allow_unused=True)
        return ((total.detach(), {k: v.detach() for k, v in mets.items()}),
                list(grads))
    return grad_fn


def _value_and_grad(model: Model):
    """(params, batch, **loss kwargs) -> ((loss, metrics), grads), all
    detached."""
    flat = _value_and_flat_grad(model)

    def grad_fn(params, batch, **kw):
        out, grads = flat(params, batch, **kw)
        if any(x is None for x in grads):
            raise ValueError("a param leaf takes no part in the loss")
        return out, T.unflatten(T.flatten(params)[1], grads)
    return grad_fn


def build_runtime(model: Model, rpol: RunPolicy, *, lr=1e-3,
                  combine: Optional[CombineConfig] = None,
                  optimizer: Optional[Optimizer] = None,
                  strict: bool = False,
                  combine_impl: str = "kernel", comm=None,
                  model_size: int = 1) -> Runtime:
    """The training runtime: lanes stacked on one device, or, with `comm`
    (a `repro_torch.parallel.comm.Comm` of more than one rank), one
    process per rank (see the module docstring). combine_impl='kernel'
    runs the combine's block passes through the kernel wrappers (the
    CUDA kernels on a card, their plain versions on the CPU); 'plain'
    runs the plain versions on any device — the on-card reference for
    the kernels, as `attn_impl` is for attention. `model_size` > 1: the
    comm's ranks are a (data, model) grid with that many ranks a model
    group (see the module docstring)."""
    if combine_impl not in COMBINE_IMPLS:
        raise ValueError(f"combine_impl={combine_impl!r}; one of "
                         f"{COMBINE_IMPLS}")
    if model_size > 1 and (comm is None or comm.world % model_size):
        raise ValueError(f"model_size={model_size} needs a comm of a "
                         f"multiple of that many ranks")
    if comm is not None and comm.world > 1:
        return _build_ranked(model, rpol, comm, lr=lr, combine=combine,
                             optimizer=optimizer, strict=strict,
                             combine_impl=combine_impl,
                             model_size=model_size)
    span = rpol.span or 1
    if span & (span - 1):
        raise ValueError(f"span={span} must be a power of two")
    ccfg = _resolve_combine_cfg(rpol, span, combine, strict)
    delayed = _check_delay(rpol)
    # the runtime owns the stacked lane tensors it hands the combiner,
    # so the combiner may free them as it packs them
    combiner = make_combiner(ccfg, impl=combine_impl, donate=True)
    scombiner = None
    if rpol.combine_stats and span > 1 and not delayed:
        scombiner = make_combiner(ccfg, with_stats=True, impl=combine_impl,
                                  donate=True)
    opt = _make_opt(rpol, lr, optimizer)
    dopt = DistributedOptimizer(opt, ccfg, combiner, span)
    grad_fn = _value_and_grad(model)

    def init_state(generator: torch.Generator) -> Dict[str, Any]:
        params = model.init(generator)
        state = {"params": params, "opt": dopt.init(params), "step": 0}
        if delayed:
            state["pending"] = _zero_carry(params, span)
        return state

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
                    T.map(lambda out, x: _accumulate(out[i], x), G, g)
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
                    del g
                    dopt.apply(p, d)
                del d
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

    if delayed:
        def local_only_step(state, batch):
            """The compute half of a delayed round: k local optimizer
            steps a lane, the lane-mean delta applied at once, the
            stacked deltas parked as the next round's carry."""
            deltas, inner, metrics = local_deltas(state["params"],
                                                  state["opt"], batch)
            with torch.no_grad():
                dopt.apply(state["params"], lane_mean(deltas, ccfg.acc))
            return {"params": state["params"],
                    "opt": {"inner": inner, "step": state["opt"]["step"]
                            + max(rpol.local_steps, 1)},
                    "step": state["step"] + 1, "pending": deltas}, metrics

        correction = build_delayed_correction(ccfg, impl=combine_impl)
        return _delayed_runtime(
            Runtime(model, rpol, span, dopt, None, init_state,
                    combine_path=getattr(combiner, "combine_path", "")),
            correction, local_only_step)
    step_fn = local_sgd_step if rpol.local_steps > 1 else sync_step
    return Runtime(model, rpol, span, dopt, step_fn, init_state,
                   combine_path=getattr(combiner, "combine_path", ""),
                   combine_stats=scombiner is not None)


def _accumulate(out: torch.Tensor, x: torch.Tensor):
    """out <- out + x in fp32, cast to out's dtype (for fp32 out and x
    all in place, with no lane-sized temporary)."""
    return out.copy_(out.float().add_(x.float()))


def _check_delay(rpol: RunPolicy) -> bool:
    """Whether the runtime is a delayed one (combine_delay 1)."""
    if rpol.combine_delay not in (0, 1):
        raise ValueError(f"combine_delay must be 0 or 1, got "
                         f"{rpol.combine_delay}")
    if rpol.combine_delay and rpol.accum_steps > 1:
        raise ValueError(
            "combine_delay needs accum_steps == 1 (the delayed path "
            "combines per-lane optimizer-step deltas)")
    return bool(rpol.combine_delay)


def _zero_carry(params, span: int = 0):
    """The pending carry before the first round: fp32 zeros, [span, ...]
    stacked (span > 0) or one lane's (across ranks). Adasum and the lane
    mean of zeros are both zero, so the step-0 correction is exactly
    zero with no cold-start branch."""
    lead = (span,) if span else ()
    return T.map(lambda p: torch.zeros(lead + tuple(p.shape),
                                       dtype=torch.float32, device=p.device),
                 params)


def _delayed_runtime(rt: Runtime, correction, local_only_step) -> Runtime:
    """Fill a Runtime's delayed pieces and its single-program step: the
    correction of the pending carry (which the step consumes), the local
    step, then the fold (build.py:428-483)."""
    def delayed_local_step(state, batch):
        with torch.no_grad():
            corr = correction(state["pending"], donate=True)
        new_state, metrics = local_only_step(state, batch)
        with torch.no_grad():
            rt.dopt.apply(new_state["params"], corr)
        return new_state, metrics

    rt.train_step = delayed_local_step
    rt.correction_fn = correction
    rt.local_fn = local_only_step
    rt.fold_fn = rt.dopt.apply
    return rt


def _make_opt(rpol: RunPolicy, lr, optimizer: Optional[Optimizer]):
    opt_kwargs = {}
    if rpol.optimizer in ("adam", "lamb"):
        opt_kwargs["state_dtype"] = getattr(torch, rpol.opt_state_dtype)
    return optimizer or get_optimizer(rpol.optimizer, lr, **opt_kwargs)


def _param_shapes(cfg) -> PyTree:
    """The params tree as meta tensors (shapes only, nothing allocated)."""
    from repro_torch.models import transformer as TF

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return torch.empty(node[0], device="meta")
    return build(TF.param_spec(cfg))


_RVH_KEYS = ("adasum-rvh", "adasum-gspmd", "adasum-fused")
# the combiners that run on shards (every built-in; `registry.py`)
_SHARD_KEYS = _RVH_KEYS + ("sum", "mean", "adascale", "adasum-linear")


def _plan_sharding(rpol: RunPolicy, point: str, span: int, W: int,
                   sync: bool, stateful: bool) -> bool:
    """Whether the ranked runtime shards the data axis (else its plan
    holds every leaf whole), as the reference's GSPMD does
    (build.py:146-177, 258-285): `fsdp` and, at span < dp,
    `scatter_grads` ask for it; ZeRO-1 applies by itself on the
    synchronous step of an optimizer with state (`stateful`; sgd has
    none, so the reference's state plan shards nothing there) at the
    pre point, and at the post point below span == dp, whatever the
    combiner."""
    if rpol.fsdp or (rpol.scatter_grads and W > span):
        return True
    return sync and stateful and (point == "pre" or W > span)


def _check_regime(model: Model, rpol: RunPolicy, key: str, span: int,
                  W: int, M: int) -> None:
    """The combinations this port does not reach yet (ROADMAP item 7),
    refused before any collective: on a sharded data axis (`fsdp`, or
    `scatter_grads` below span == dp) or a model axis, the delayed
    combine and local steps; under fsdp the encoder-decoder's own
    training loop; on a model axis the SSM, hybrid and encoder-decoder
    families and a combiner the registry does not run on shards."""
    cfg = model.cfg
    model_axis = M > 1
    if not (model_axis or rpol.fsdp or (rpol.scatter_grads and W > span)):
        return
    why = None
    if model_axis and (cfg.family not in ("dense", "moe", "vlm")
                       or cfg.frontend not in ("none", "vision")
                       or cfg.is_encoder_decoder):
        why = f"{cfg.name} ({cfg.family} family, {cfg.attn_type} attention)"
    elif model_axis and key not in _SHARD_KEYS:
        why = f"the {key} combiner"
    elif rpol.combine_delay:
        why = "the delayed combine (combine_delay=1)"
    elif rpol.local_steps > 1:
        why = "local_steps > 1"
    elif rpol.fsdp and cfg.is_encoder_decoder:
        why = "the encoder-decoder's own training loop"
    if why:
        where = "a model axis" if model_axis else "fsdp / scatter_grads"
        raise not_ported(f"{where} with {why}", ITEM_SHARDING)


def _build_ranked(model: Model, rpol: RunPolicy, comm, *, lr, combine,
                  optimizer, strict, combine_impl,
                  model_size: int = 1) -> Runtime:
    """One process per rank; see the module docstring."""
    M = model_size
    wcomm, mcomm = comm, None
    grid = Mesh(("data", "model"), (comm.world // M, M))
    data_groups = grid.groups("data")    # global ranks, by data index
    if M > 1:
        # the grid's model groups, then its data groups (dist.new_group
        # is collective: every rank makes every split, in one order)
        mcomm = comm.split(grid.groups("model"))
        comm = comm.split(data_groups)
    W = comm.world
    span = rpol.span or W
    if span & (span - 1) or W % span:
        raise ValueError(f"span={span} must be a power of two dividing "
                         f"dp={W}")
    ccfg = _resolve_combine_cfg(rpol, span, combine, strict, dp_total=W)
    delayed = _check_delay(rpol)
    key = registry_key(ccfg.op, ccfg.backend)
    _check_regime(model, rpol, key, span, W, M)
    g = W // span                      # ranks in a lane group
    rvh = key in _RVH_KEYS
    if rvh:
        if ccfg.backend != "rvh" and g == 1 and span > 1:
            warnings.warn(
                f"backend={ccfg.backend!r} with one lane per rank (span == "
                f"dp={W}): the lanes' Adasum tree runs as RVH across the "
                f"ranks, the same function", EngineWarning, stacklevel=3)
        run_cfg = dataclasses.replace(ccfg, op="adasum", backend="rvh")
        path = "rvh" if g == 1 else "hier-rvh"
    else:
        run_cfg, path = ccfg, key
    opt = _make_opt(rpol, lr, optimizer)
    point = DistributedOptimizer(opt, ccfg, None, span).point
    post = point == "post"
    shapes = _param_shapes(model.cfg)
    sync = not delayed and rpol.local_steps <= 1
    sharded = _plan_sharding(rpol, point, span, W, sync,
                             stateful=bool(T.leaves(opt.init(shapes))))
    # the splits on every rank, in this order (dist.new_group is
    # collective over all ranks), of the launch's comm, each data group's
    # in turn: the lane groups, the ranks of equal position that the
    # combiner reduces across, and for the delayed combine the same again
    # as the exchange leg's own process groups
    position = [list(range(q, W, g)) for q in range(g)]

    def split(lists, **kw):
        """Each data group's sub-communicators of its data indices."""
        return wcomm.split([[grp[d] for d in lst] for grp in data_groups
                            for lst in lists], **kw)
    lane_comm = (split([list(range(l * g, (l + 1) * g))
                        for l in range(span)]) if g > 1 else None)
    rvh_comm = split(position) if g > 1 else comm
    # the synchronous step runs on a plan (every leaf whole where the
    # regime shards nothing); local steps and the delayed combine hold
    # every leaf whole and take none
    plan = None
    if sync:
        plan = RankPlan(model.cfg, shapes, comm, span,
                        fsdp=rpol.fsdp, scatter_grads=rpol.scatter_grads,
                        post=post, lane_comm=lane_comm, rvh_comm=rvh_comm,
                        shard=sharded, model_comm=mcomm)
        if rvh and not ccfg.per_layer and M > 1:   # before the first step
            check_whole_model(replication_factors(plan.mspecs, M))
    want_stats = rpol.combine_stats and span > 1 and not delayed
    shard, out_layout = {}, "whole"
    # a combiner the registry does not run on shards (a registered one)
    # gets its lane tree whole on the data axis
    whole_in = sharded and key not in _SHARD_KEYS
    if sharded and not whole_in:
        # the sharded leaves come back as this rank's piece where a piece
        # is what comes next (ZeRO-1's optimizer, an FSDP param), else
        # as the lane group's part; int8 keeps RVH's own (compressed)
        # allgather and cuts the piece from it, as the reference's
        # combine returns the dequantized gather
        keep_piece = (not post or rpol.fsdp) and not (
            rvh and ccfg.compress == "int8")
        out_layout = "piece" if keep_piece else "gshard"
        shard.update(shard_dims=plan.dims, shard_comm=lane_comm,
                     allgather_result=not keep_piece)
    if M > 1:
        # each rank's leaves are its model shards: the dots of a leaf
        # the model axis does not shard count once over the model group
        shard.update(leaf_specs=plan.mspecs, model_comm=mcomm)
    shard = shard or None
    tp = TensorParallel(mcomm, model.cfg, shapes) if M > 1 else None
    combiner = make_combiner(run_cfg, impl=combine_impl, donate=True,
                             comm=rvh_comm, shard=shard)
    scombiner = None
    if want_stats:
        scombiner = make_combiner(run_cfg, with_stats=True,
                                  impl=combine_impl, donate=True,
                                  comm=rvh_comm, shard=shard)
    dopt = DistributedOptimizer(opt, ccfg, combiner, span, stacked=False,
                                state_like=plan.state_like if sharded
                                else None)
    grad_fn = _value_and_grad(model)
    flat_grad_fn = _value_and_flat_grad(model)
    r = comm.rank
    # at span < W each rank's loss is its share of its microbatch's, so
    # the lane group's gradients sum to the microbatch's
    grp = TokenGroup(lane_comm) if lane_comm is not None else None

    def init_params(generator: torch.Generator) -> PyTree:
        """Every rank draws from its generator and rank 0's params are
        broadcast (Horovod's broadcast_parameters). With a plan, a leaf
        at a time in the draw's order (the values of the whole draw):
        each rank cuts its model shard, the first rank of its data group
        broadcasts it (a leaf the model axis does not shard goes out
        from rank 0 of the grid), and under fsdp each rank keeps its
        piece of it."""
        if plan is None:
            params = model.init(generator)
            for x in T.leaves(params):
                comm.broadcast(x, 0)
            return params
        leaves = [None] * len(plan.shapes)
        for path, x in model.init_leaves(generator):
            i = plan.index[path]
            y = plan.mshard(i, x)
            y = y.clone() if y is not x else y
            del x
            (wcomm if plan.mdims[i] is None else comm).broadcast(y, 0)
            if plan.fsdp and plan.dims[i] is not None:
                y = plan.piece(i, y).clone()
            leaves[i] = y
            del y
        return T.unflatten(plan.treedef, leaves)

    def init_state(generator: torch.Generator) -> Dict[str, Any]:
        params = init_params(generator)
        state = {"params": params, "opt": dopt.init(params), "step": 0}
        if delayed:
            state["pending"] = _zero_carry(params)
        return state

    def rank_micro(batch, A: int):
        """This rank's rows of each of its lane's A microbatches (the
        lane's rows [l·B/span, (l+1)·B/span) in A contiguous pieces,
        build.py:309-336); the g ranks of a lane group take contiguous
        1/g of each, in rank order. At A = 1 rank r takes rows [r·B/W,
        (r+1)·B/W)."""
        B = T.leaves(batch)[0].shape[0]
        if B % W:
            raise ValueError(f"global batch {B} not divisible by dp={W}")
        lane_rows = B // span
        if lane_rows % A or (lane_rows // A) % g:
            raise ValueError(
                f"a lane's {lane_rows} rows do not split into {A} "
                f"microbatch(es) of a multiple of {g} rows (the ranks of a "
                f"lane group)")
        mb = lane_rows // A
        per = mb // g
        out = []
        for j in range(A):
            s = (r // g) * lane_rows + j * mb + (r % g) * per
            out.append(T.map(lambda x: x[s:s + per], batch))
        return out

    def group_grad(gr):
        """The lane gradient from this rank's part, summed over the lane
        group: the same bits on its ranks. In place; nothing to do at
        span == W."""
        if lane_comm is not None:
            with torch.no_grad():
                for x in T.leaves(gr):
                    lane_comm.allreduce(x)
        return gr

    def metric_share(m):
        return {k: v.float() for k, v in m.items()}

    def rank_grads(params, batch):
        """This rank's lane gradient in the plan's grad layout: the sum
        over accum_steps microbatches (accum_dtype, build.py:325-336) of
        each one's lane gradient, each sharded leaf the lane group's sum
        reduce-scattered to this rank's part — under fsdp by the
        gather's backward, layer by layer, into `store`; under
        scatter_grads after each microbatch (ZeRO-2: the accumulator
        holds the part); else all-reduced once and cut — and each whole
        leaf all-reduced; and the rank's share of the lane metrics."""
        A = rpol.accum_steps
        acc_dt = getattr(torch, rpol.accum_dtype) if A > 1 else None
        leaves, td = T.flatten(params)
        fsdp = plan.fsdp
        early = [plan.scatter and lane_comm is not None and d is not None
                 for d in plan.dims]
        store = [None] * len(leaves)
        acc, mets = None, []
        for mb in rank_micro(batch, A):
            fs = plan.fsdp_step(store, acc_dt or leaves[0].dtype) \
                if fsdp else None
            kw = {"tp": tp} if tp is not None else {}
            (_, m), gl = flat_grad_fn(params, mb, fsdp=fs, token_group=grp,
                                      **kw)
            mets.append(metric_share(m))
            with torch.no_grad():
                gl = [plan.lane_reduce(i, x) if x is not None and early[i]
                      else x for i, x in enumerate(gl)]
                if A <= 1:
                    acc = gl
                    continue
                if acc is None:
                    acc = [None if x is None else torch.zeros(
                        x.shape, dtype=acc_dt, device=x.device) for x in gl]
                for out, x in zip(acc, gl):
                    if x is not None:
                        _accumulate(out, x)
            del gl
        if any(x is None and s is None for x, s in zip(acc, store)):
            raise ValueError("a param leaf takes no part in the loss")
        with torch.no_grad():
            G = [store[i] if store[i] is not None else acc[i] if early[i]
                 else plan.lane_reduce(i, acc[i]) for i in range(len(acc))]
        return T.unflatten(td, G), _mean(mets)

    def _mean(mets):
        return {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}

    def lane_metrics(mets):
        """Mean over lanes of the lane metrics, the same bits on every
        rank: the ranks' shares, summed in rank order."""
        keys = sorted(mets)
        tot = comm.group_sum(torch.stack([mets[k] for k in keys]), W) / span
        out = {k: tot[i] for i, k in enumerate(keys)}
        out["grad_lanes"] = torch.tensor(span, dtype=torch.int32)
        return out

    def stat_metrics(stats, batch):
        rows = T.leaves(batch)[0].shape[0]
        return summarize_stats(stats, span, rows // span)

    def sync_step(state, batch):
        """The synchronous step on the plan's layouts (module docstring
        of `parallel.zero`): the combine of the lane gradients (pre) or of
        the lanes' optimizer deltas (post), the optimizer on this rank's
        part of each leaf and its state, and the update applied to the
        rank's params — its pieces under fsdp, else every leaf whole
        again by an all-gather of the pieces."""
        params = state["params"]
        G, mets = rank_grads(params, batch)
        step, inner = state["opt"]["step"], state["opt"]["inner"]
        comb = scombiner if scombiner is not None else combiner
        if whole_in:
            comb = lambda tree, c=comb: c(_convert(tree, "gshard", "whole"))
        stats = None
        with torch.no_grad():
            if not post:
                out = comb(G)
                if scombiner is not None:
                    out, stats = out
                del G
                got = _convert(out, out_layout, "piece")
                del out
                delta, inner = opt.update(
                    got, inner, _params_as(params, "piece", got), step,
                    norm_sum=plan.norm_sums("piece"))
                layout = "piece"
            else:
                d, inner = opt.update(
                    G, inner, _params_as(params, "gshard", G), step,
                    norm_sum=plan.norm_sums("gshard"))
                del G
                delta = comb(d)
                if scombiner is not None:
                    delta, stats = delta
                del d
                layout = out_layout
            _apply(params, delta, layout)
            del delta
        metrics = lane_metrics(mets)
        if stats is not None:
            metrics.update(stat_metrics(stats, batch))
        return {"params": params, "opt": {"inner": inner, "step": step + 1},
                "step": state["step"] + 1}, metrics

    def _convert(tree, have: str, want: str):
        """Sharded leaves from layout `have` to `want` ('piece' or
        'gshard' from 'whole', 'gshard' or 'piece'; 'whole' from
        'gshard')."""
        leaves, td = T.flatten(tree)
        out = []
        for i, x in enumerate(leaves):
            if plan.dims[i] is not None and have != want:
                if want == "whole":
                    x = plan.whole_from_gshard(i, x)
                elif want == "piece":
                    x = plan.sub(i, x) if have == "gshard" else \
                        plan.piece(i, x)
                else:
                    x = plan.gshard(i, x)
            out.append(x)
        return T.unflatten(td, out)

    def _params_as(params, want: str, like):
        """The params in layout `want`, when the optimizer reads them
        (else `like`, a tree it ignores)."""
        if not opt.reads_params:
            return like
        if not plan.fsdp:
            return _convert(params, "whole", want)
        if want == "piece":
            return params
        leaves, td = T.flatten(params)
        return T.unflatten(td, [x if plan.dims[i] is None
                                else plan.gshard_from_pieces(i, x)
                                for i, x in enumerate(leaves)])

    def _apply(params, delta, layout: str) -> None:
        """params += delta, leaf by leaf: under fsdp onto this rank's
        pieces; else each sharded leaf's delta made whole first."""
        pl, dl = T.leaves(params), T.leaves(delta)
        for i, (p, d) in enumerate(zip(pl, dl)):
            if plan.dims[i] is not None:
                if plan.fsdp:
                    if layout != "piece":
                        d = plan.sub(i, d) if layout == "gshard" else \
                            plan.piece(i, d)
                elif layout == "piece":
                    d = plan.whole_from_pieces(i, d)
                elif layout == "gshard":
                    d = plan.whole_from_gshard(i, d)
            p.copy_(p.float().add_(d))
            del d

    def local_delta(params, opt_state, batch, k: int):
        """Paper §5.2 on this rank's lane: k optimizer steps from the
        shared params, each on its lane group's gradient of one of the
        lane's k microbatches (every rank of a group applies the same
        update). At the post point each rank keeps its own lane's state;
        at the pre point every lane starts from the shared state and
        lane 0's ends the step (build.py:399), broadcast from rank 0.
        Returns (fp32 delta, inner state, the rank's metric share)."""
        oi = opt_state["inner"]
        if not post:
            oi = T.map(lambda x: x.clone(), oi)
        p = T.map(lambda x: x.clone(), params)
        mets = []
        for j, mb in enumerate(rank_micro(batch, k)):
            (_, m), gr = grad_fn(p, mb, token_group=grp)
            mets.append(metric_share(m))
            with torch.no_grad():
                d, oi = dopt.opt.update(group_grad(gr), oi, p,
                                        opt_state["step"] + j)
                del gr
                dopt.apply(p, d)
            del d
        with torch.no_grad():     # in p's own memory where it is fp32
            delta = T.map(lambda e, s: e.float().sub_(s), p, params)
            del p
            if not post:
                for x in T.leaves(oi):
                    comm.broadcast(x, 0)
        return delta, oi, _mean(mets)

    def local_sgd_step(state, batch):
        """Paper §5.2: k local optimizer steps, then the combine of the
        deltas."""
        k = rpol.local_steps
        params, opt_state = state["params"], state["opt"]
        delta, oi, mets = local_delta(params, opt_state, batch, k)
        metrics = lane_metrics(mets)
        with torch.no_grad():
            if scombiner is not None:
                combined, stats = scombiner(delta)
                metrics.update(stat_metrics(stats, batch))
            else:
                combined = combiner(delta)
            del delta
            dopt.apply(params, combined)
        return {"params": params,
                "opt": {"inner": oi, "step": opt_state["step"] + k},
                "step": state["step"] + 1}, metrics

    rt = Runtime(model, rpol, span, dopt, None, init_state,
                 combine_path=path, combine_stats=scombiner is not None,
                 dp_total=W, comm=wcomm,
                 plan=plan if sharded or M > 1 else None, model_size=M,
                 model_comm=mcomm, tp=tp)
    if delayed:
        # the exchange leg's own process groups (trap: two threads on one
        # gloo group may issue its collectives in another order on
        # another rank)
        xcomm = comm.split(position, share_staging=False)

        def local_only_step(state, batch):
            """A delayed round's compute half on this rank's lane: its
            local delta, the cross-rank lane mean applied at once, the
            delta parked as the next round's carry."""
            k = max(rpol.local_steps, 1)
            params, opt_state = state["params"], state["opt"]
            delta, oi, mets = local_delta(params, opt_state, batch, k)
            metrics = lane_metrics(mets)
            with torch.no_grad():
                dopt.apply(params, rank_mean(delta, rvh_comm, ccfg.acc))
            return {"params": params,
                    "opt": {"inner": oi, "step": opt_state["step"] + k},
                    "step": state["step"] + 1, "pending": delta}, metrics

        correction = build_delayed_correction(run_cfg, impl=combine_impl,
                                              comm=xcomm)
        return _delayed_runtime(rt, correction, local_only_step)
    rt.train_step = sync_step if sync else local_sgd_step
    return rt


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
