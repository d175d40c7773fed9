"""String-keyed combiner registry (the port of `repro/engine/registry.py`).

Every combiner is a *factory*

    factory(cfg: CombineConfig, *, impl="kernel", donate=False,
            comm=None) -> combine

where `combine(stacked) -> combined` reduces a stacked pytree (leading
lane axis of length `cfg.span`), or, given a `comm` of more than one
rank (a `repro_torch.parallel.comm.Comm`, in place of the reference's
`mesh` and `dp_axes`, where GSPMD shards the lane axis), this rank's
lane tree (no lane axis) across the ranks of `comm`, the same bits on
every rank. `impl` and `donate` are the fused path's (see
`repro_torch.core.combine`); a factory may ignore them. Built-in
entries:

    sum            plain sum over lanes (synchronous-SGD baseline)
    mean           arithmetic mean over lanes
    adasum-gspmd   recursive tree on the lane axis: the fused bucketed
                   combine (cfg.fused, default), else the per-leaf tree
    adasum-fused   the fused bucketed combine, explicitly
    adasum-linear  ring-order recursion (paper §3.4) — ablation variant
    adasum-rvh     ADASUMRVH (paper Algorithm 1) across the ranks of
                   `comm`, one lane per rank (`repro_torch.core.rvh`)
    adascale       AdaScale's gain-scaled mean (Johnson et al., 2020)

Across ranks: sum and mean are one `Comm.allreduce` (mean over the
rank count); adascale takes the lane mean that way and sums each rank's
‖x_r − m‖² in rank order; adasum-linear runs the ring order on
rank-owned chunks (`core.adasum.adasum_linear_ranks`); adasum-gspmd is
RVH (the same function, warned); adasum-fused refuses, as the
reference's does when the lane axis is device-sharded.

On shards (`make_combiner(shard=...)`: a rank's lane tree holds its lane
group's part of some leaves, `shard_dims` / `shard_comm`, or its model
shards, `leaf_specs` / `model_comm`), every built-in combines what it
is given: sum and mean element by element, adascale's moments and
adasum-linear's and the probe's dot triples summed over the shards
(`core.rvh.shard_factors`, `core.adasum.shard_sums`), RVH as
`core.rvh.adasum_rvh_pytree` says; with allgather_result=False each
sharded leaf comes back as this rank's piece of it (sum and mean by a
reduce-scatter). A factory is called with these as keyword arguments;
one that takes them as `**_` sees whole leaves only. Register a new
combiner with

    @register_combiner("mine")
    def _mine(cfg, **_):
        return lambda stacked: ...
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tree as T
from repro_torch.core import adasum as A
from repro_torch.core.combine import (CombineConfig, _level_triple,
                                      build_fused_combiner, rank_sum,
                                      stack_stats, tree_combine_per_layer,
                                      tree_combine_whole)
from repro_torch.core.rvh import build_rvh_combiner, shard_factors

PyTree = Any
Combiner = Callable[[PyTree], PyTree]
CombinerFactory = Callable[..., Combiner]

_COMBINERS: Dict[str, CombinerFactory] = {}


def register_combiner(name: str, *, overwrite: bool = False):
    """Decorator: register `factory` under `name`."""
    def deco(factory: CombinerFactory) -> CombinerFactory:
        if name in _COMBINERS and not overwrite:
            raise KeyError(f"combiner {name!r} already registered "
                           f"(pass overwrite=True to replace)")
        _COMBINERS[name] = factory
        return factory
    return deco


def available_combiners() -> tuple:
    return tuple(sorted(_COMBINERS))


def get_combiner_factory(name: str) -> CombinerFactory:
    try:
        return _COMBINERS[name]
    except KeyError:
        raise KeyError(f"unknown combiner {name!r}; registered: "
                       f"{available_combiners()}") from None


def registry_key(op: str, backend: str = "") -> str:
    """Map (CombineConfig.op, CombineConfig.backend) to a registry name."""
    if op in ("sum", "mean"):
        return op
    if op == "adasum":
        return {"gspmd_tree": "adasum-gspmd", "rvh": "adasum-rvh",
                "fused": "adasum-fused", "linear": "adasum-linear",
                "": "adasum-gspmd"}.get(backend, backend)
    return op   # custom registry entries are addressed by op name directly


def _ranked(comm) -> bool:
    return comm is not None and comm.world > 1


def make_combiner(cfg: CombineConfig, *, with_stats: bool = False,
                  impl: str = "kernel", donate: bool = False,
                  comm=None, shard: Optional[dict] = None) -> Combiner:
    """The registry-dispatched combiner. Every returned combiner carries
    a `combine_path` naming the implementation that actually runs
    ('gspmd-fused' vs 'gspmd-reference', 'rvh'). with_stats=True returns
    a combiner yielding (combined, CombineStats) — see `stats_combiner`.
    `comm` is the group of ranks the combiner reduces across; `shard`
    how this rank's lane tree is cut (module docstring): its lane-group
    shards, `shard_dims`, `shard_comm` and `allgather_result` of
    `core.rvh.adasum_rvh_pytree`, and its model shards, `leaf_specs` and
    `model_comm`."""
    key = registry_key(cfg.op, cfg.backend)
    if with_stats:
        return stats_combiner(cfg, impl=impl, donate=donate, comm=comm,
                              shard=shard)
    factory = get_combiner_factory(key)
    combiner = factory(cfg, impl=impl, donate=donate, comm=comm,
                       **(shard or {}))
    if not hasattr(combiner, "combine_path"):
        try:
            combiner.combine_path = key
        except AttributeError:      # exotic callables (partial, C ext)
            pass
    return combiner


def probe_stats(stacked: PyTree, acc_dtype) -> dict:
    """Level-0 CombineStats probe for combiners that do not surface dot
    triples themselves: pair adjacent lanes once and total [dot, ‖a‖²,
    ‖b‖²] over all leaves. Returns {'levels': [1, 3]} ([0, 3] at span
    1)."""
    leaves = T.leaves(stacked)
    if not leaves or leaves[0].shape[0] < 2:
        return stack_stats([])
    return stack_stats([_level_triple(leaves, acc_dtype)])


def probe_stats_ranks(tree: PyTree, comm, acc_dtype, shard_dims=None,
                      shard_comm=None, leaf_specs=None, model_comm=None,
                      **_) -> dict:
    """`probe_stats` with one lane per rank: lanes 2i and 2i+1 (ranks 2i
    and 2i+1) swap half of each leaf, as RVH's round 0 does (the even
    rank keeps the first half and receives its partner's, the odd rank
    the second), each takes its half's [a·b, a·a, b·b] over every leaf,
    and the ranks' triples are summed in rank order. On shards (see
    `make_combiner`) each leaf's triple counts its `shard_factors`
    weight, and the sum goes on over the lane group, then the model
    group, as RVH's dots do: the level-0 triple of the whole leaves."""
    if comm.world < 2:
        return stack_stats([])
    n = len(T.leaves(tree))
    factors = shard_factors(n, shard_dims=shard_dims, shard_comm=shard_comm,
                            leaf_specs=leaf_specs, model_comm=model_comm) \
        or [1.0] * n
    even = comm.rank % 2 == 0
    keep, send, recv = [], [], []
    for x in T.leaves(tree):
        flat = x.reshape(-1)
        h = -(-flat.numel() // 2)
        lo, hi = flat[:h], flat[h:]
        keep.append(lo if even else hi)
        send.append(hi if even else lo)
        recv.append(torch.empty_like(keep[-1]))
    comm.exchange(send, comm.rank ^ 1, recvs=recv)
    tot = torch.zeros(3, dtype=acc_dtype, device=keep[0].device)
    for mine, theirs, f in zip(keep, recv, factors):
        a, b = (mine, theirs) if even else (theirs, mine)
        tot += f * torch.stack([A._flat_dot(a, b, acc_dtype),
                                A._flat_dot(a, a, acc_dtype),
                                A._flat_dot(b, b, acc_dtype)])
    tot = A.shard_sums(comm.group_sum(tot, comm.world), None, shard_comm,
                     model_comm)
    return stack_stats([tot])


def stats_combiner(cfg: CombineConfig, *, impl: str = "kernel",
                   donate: bool = False, comm=None,
                   shard: Optional[dict] = None) -> Combiner:
    """A combiner returning (combined, CombineStats). The adasum gspmd /
    fused paths surface their own per-level triples, and `adasum-rvh`
    the reference's level-0 probe from its round-0 dots (registry.py:
    113-125, :162-171, without exchanging the gradients again); every
    other combiner is wrapped with the level-0 `probe_stats` (across
    ranks `probe_stats_ranks`), taken before the combine, which may
    consume its input."""
    key = registry_key(cfg.op, cfg.backend)
    if key == "adasum-gspmd" and _ranked(comm):
        _warn_rvh()
        key = "adasum-rvh"
    if key == "adasum-rvh":
        return _adasum_rvh(cfg, impl=impl, donate=donate, comm=comm,
                           with_stats=True, **(shard or {}))
    if key in ("adasum-gspmd", "adasum-fused"):
        _stacked_only(key, comm)
        if cfg.fused:
            fused = build_fused_combiner(cfg, with_stats=True, impl=impl,
                                         donate=donate)
            fused.combine_path = "gspmd-fused"
            return fused
        fn = tree_combine_per_layer if cfg.per_layer else tree_combine_whole

        def ref(stacked):
            collect: list = []
            out = fn(stacked, cfg.acc, collect=collect)
            return out, stack_stats(collect)

        ref.combine_path = "gspmd-reference"
        return ref

    base = make_combiner(cfg, impl=impl, donate=donate, comm=comm,
                         shard=shard)

    def probed(stacked):
        stats = (probe_stats_ranks(stacked, comm, cfg.acc, **(shard or {}))
                 if _ranked(comm) else probe_stats(stacked, cfg.acc))
        return base(stacked), stats

    probed.combine_path = getattr(base, "combine_path", key)
    return probed


def _warn_rvh() -> None:
    import warnings
    from repro_torch.engine.build import EngineWarning
    warnings.warn(
        "adasum-gspmd with one lane per rank: the lanes' Adasum tree runs "
        "as RVH across the ranks, the same function", EngineWarning,
        stacklevel=4)


def _stacked_only(key: str, comm) -> None:
    """adasum-fused pairs lanes on one device (registry.py:212-225)."""
    if _ranked(comm):
        raise ValueError(
            f"{key}: the lanes are one per rank; use backend='rvh' (paper "
            f"Algorithm 1) or backend='gspmd_tree' there")


# --------------------------------------------------------------- built-ins
def _pieces(leaves, dims, comm):
    """Each leaf with a dim in `dims` -> this rank's piece of it (chunk
    `comm.rank` of `comm.world` along that dim), in its own memory."""
    if dims is None:
        return leaves
    out = []
    for x, d in zip(leaves, dims):
        if d is not None:
            n = x.shape[d] // comm.world
            x = x.narrow(d, comm.rank * n, n).clone()
        out.append(x)
    return out


@register_combiner("sum")
def _sum(cfg, *, donate=False, comm=None, shard_dims=None,
         allgather_result=True, **_):
    if _ranked(comm):
        dims = None if allgather_result else shard_dims
        return lambda tree: rank_sum(tree, comm, donate=donate, dims=dims)
    return lambda stacked: A.sum_reduce(stacked, mean=False)


@register_combiner("mean")
def _mean(cfg, *, donate=False, comm=None, **shard):
    if _ranked(comm):
        total = _sum(cfg, donate=donate, comm=comm, **shard)
        return lambda tree: T.map(lambda x: x.div_(comm.world), total(tree))
    return lambda stacked: A.sum_reduce(stacked, mean=True)


@register_combiner("adasum-gspmd")
def _adasum_gspmd(cfg, *, impl="kernel", donate=False, comm=None,
                  **shard):
    """Default backend: the fused bucketed combine (cfg.fused, default
    on), or the per-leaf reference tree when opted out. With the lanes
    one per rank, RVH: the reference falls back there, with a warning,
    to the per-leaf tree that GSPMD runs across the devices
    (registry.py:184-209), the same function."""
    if _ranked(comm):
        _warn_rvh()
        return _adasum_rvh(cfg, impl=impl, donate=donate, comm=comm,
                           **shard)
    if cfg.fused:
        fused = build_fused_combiner(cfg, impl=impl, donate=donate)
        fused.combine_path = "gspmd-fused"
        return fused
    fn = tree_combine_per_layer if cfg.per_layer else tree_combine_whole
    ref = lambda stacked: fn(stacked, cfg.acc)
    ref.combine_path = "gspmd-reference"
    return ref


@register_combiner("adasum-fused")
def _adasum_fused(cfg, *, impl="kernel", donate=False, comm=None, **_):
    """The fused bucketed combine, explicitly (backend='fused'), on
    stacked lanes."""
    _stacked_only("adasum-fused", comm)
    fused = build_fused_combiner(cfg, impl=impl, donate=donate)
    fused.combine_path = "gspmd-fused"
    return fused


@register_combiner("adasum-rvh")
def _adasum_rvh(cfg, *, impl="kernel", donate=False, comm=None,
                with_stats=False, **shard):
    """ADASUMRVH across the ranks of `comm`, one lane per rank (`shard`:
    on shards, see `make_combiner`)."""
    if comm is None:
        raise ValueError(
            "adasum-rvh combines across ranks: pass comm= (a repro_torch."
            "parallel.comm.Comm, one lane per rank); lanes stacked on one "
            "device take backend='gspmd_tree'")
    return build_rvh_combiner(cfg, comm, with_stats=with_stats, impl=impl,
                              donate=donate, **shard)


@register_combiner("adasum-linear")
def _adasum_linear(cfg, *, comm=None, donate=False, shard_dims=None,
                   shard_comm=None, allgather_result=True, leaf_specs=None,
                   model_comm=None, **_):
    if _ranked(comm):
        def lin(tree):
            factors = shard_factors(
                len(T.leaves(tree)), shard_dims=shard_dims,
                shard_comm=shard_comm, leaf_specs=leaf_specs,
                model_comm=model_comm)
            return A.adasum_linear_ranks(
                tree, comm, per_layer=cfg.per_layer, acc_dtype=cfg.acc,
                factors=factors, shard_comm=shard_comm,
                model_comm=model_comm, dims=shard_dims,
                gather=allgather_result, donate=donate)
        return lin

    def lin(stacked):
        n = T.leaves(stacked)[0].shape[0]
        lanes = [T.map(lambda x, i=i: x[i], stacked) for i in range(n)]
        return A.adasum_linear_reduce(lanes, per_layer=cfg.per_layer,
                                      acc_dtype=cfg.acc)
    return lin


@register_combiner("adascale")
def _adascale(cfg, *, comm=None, shard_dims=None, shard_comm=None,
              allgather_result=True, leaf_specs=None, model_comm=None,
              **_):
    """AdaScale SGD (Johnson et al., 2020) as a combiner (registry.py:
    241-289 of the reference): the lane mean scaled by the gain ratio

        r = (sigma^2 + mu^2) / (sigma^2 / S + mu^2)      in [1, S]

    (sigma^2: per-lane gradient variance, mu^2: squared mean norm,
    estimated from the S lanes). r -> 1 when lanes agree (combined ==
    mean) and r -> S when lanes are orthogonal (combined == sum).
    `cfg.per_layer` picks per-leaf vs whole-model gain; `cfg.acc` is the
    moment-accumulation dtype. Across ranks, two passes: the lane mean m
    (`rank_sum` in acc, over S), then each rank's ‖x_r − m‖² per leaf,
    summed over the ranks in rank order; ‖m‖² is the same on every
    rank. On shards both moments of a leaf are sums over its shards
    (`shard_sums`), so every rank forms the whole leaf's gain."""
    eps = 1e-20

    def gain(var, mu2, S):
        return torch.clamp((var + mu2) / (var / S + mu2 + eps), 1.0, S)

    def scaled(ms, var_leaf, msq_leaf, leaves, S):
        """The gained means, per leaf or with one whole-model gain."""
        if cfg.per_layer:
            mu2 = torch.clamp(msq_leaf - var_leaf / S, min=0.0)
            r = gain(var_leaf, mu2, S)
        else:
            var = var_leaf.sum()
            mu2 = torch.clamp(msq_leaf.sum() - var / S, min=0.0)
            r = gain(var, mu2, S).expand(len(ms))
        # in the means' own memory
        return [m.mul_(r[i]).to(x.dtype)
                for i, (m, x) in enumerate(zip(ms, leaves))]

    def sq_dev(x, m, piece=1 << 24):
        """‖x − m‖² in acc, a piece at a time (no lane-sized temporary)."""
        x, m = x.reshape(-1), m.reshape(-1)
        return sum(torch.square(x[i:i + piece].to(cfg.acc) - m[i:i + piece])
                   .sum() for i in range(0, x.numel(), piece))

    if _ranked(comm):
        def combine_ranks(tree):
            leaves, treedef = T.flatten(tree)
            S = comm.world
            ms = [m.div_(S) for m in T.leaves(
                rank_sum(leaves, comm, dtype=cfg.acc))]
            dev = torch.stack([sq_dev(x, m) for x, m in zip(leaves, ms)])
            msq = torch.stack([torch.square(m).sum() for m in ms])
            factors = shard_factors(
                len(leaves), shard_dims=shard_dims, shard_comm=shard_comm,
                leaf_specs=leaf_specs, model_comm=model_comm)
            tot = A.shard_sums(torch.stack([comm.group_sum(dev, S), msq], 1),
                               factors, shard_comm, model_comm)
            if not allgather_result:  # the pieces kept, cut before the gain
                ms = _pieces(ms, shard_dims, comm)
            return T.unflatten(treedef, scaled(
                ms, tot[:, 0] / max(S - 1, 1), tot[:, 1], leaves, S))
        return combine_ranks

    def combine(stacked):
        leaves, treedef = T.flatten(stacked)
        S = leaves[0].shape[0]
        ms = [x.to(cfg.acc).mean(dim=0) for x in leaves]
        var_leaf = torch.stack([sum(sq_dev(x[i], m) for i in range(S))
                                for x, m in zip(leaves, ms)]) / max(S - 1, 1)
        msq_leaf = torch.stack([torch.square(m).sum() for m in ms])
        return T.unflatten(treedef, scaled(ms, var_leaf, msq_leaf, leaves,
                                           S))

    return combine
