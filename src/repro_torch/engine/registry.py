"""String-keyed combiner registry (the port of `repro/engine/registry.py`).

Every combiner is a *factory*

    factory(cfg: CombineConfig, *, impl="kernel", donate=False,
            comm=None) -> combine

where `combine(stacked) -> combined` reduces a stacked pytree (leading
lane axis of length `cfg.span`), or, for `adasum-rvh`, this rank's lane
tree across the ranks of `comm` (a `repro_torch.parallel.comm.Comm`, in
place of the reference's `mesh` and `dp_axes`). `impl` and `donate` are
the fused path's (see `repro_torch.core.combine`); a factory may ignore
them. Built-in entries:

    sum            plain sum over lanes (synchronous-SGD baseline)
    mean           arithmetic mean over lanes
    adasum-gspmd   recursive tree on the lane axis: the fused bucketed
                   combine (cfg.fused, default), else the per-leaf tree
    adasum-fused   the fused bucketed combine, explicitly
    adasum-linear  ring-order recursion (paper §3.4) — ablation variant
    adasum-rvh     ADASUMRVH (paper Algorithm 1) across the ranks of
                   `comm`, one lane per rank (`repro_torch.core.rvh`)
    adascale       AdaScale's gain-scaled mean (Johnson et al., 2020)

Across ranks (a comm of more than one rank) only `adasum-rvh` runs; the
others are stacked-lane combiners. `dasgd` raises `NotImplementedError`
naming the ROADMAP item that brings it. Register a new combiner with

    @register_combiner("mine")
    def _mine(cfg, **_):
        return lambda stacked: ...
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch import tree as T
from repro_torch.core import adasum as A
from repro_torch.core.combine import (CombineConfig, _level_triple,
                                      build_fused_combiner, stack_stats,
                                      tree_combine_per_layer,
                                      tree_combine_whole)
from repro_torch.core.rvh import build_rvh_combiner
from repro_torch.runtime import (ITEM_MULTI_RANK, ITEM_SUBSYSTEMS,
                                 not_ported)

PyTree = Any
Combiner = Callable[[PyTree], PyTree]
CombinerFactory = Callable[..., Combiner]

_COMBINERS: Dict[str, CombinerFactory] = {}
# reference registry entries a later slice brings
LATER = {"dasgd": ITEM_SUBSYSTEMS}


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
    if name in LATER and name not in _COMBINERS:
        raise not_ported(f"combiner {name!r}", LATER[name])
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


def _check_ranks(key: str, comm) -> None:
    """Across ranks only the RVH combiner runs."""
    if comm is not None and comm.world > 1 and key != "adasum-rvh":
        raise not_ported(f"combiner {key!r} across ranks", ITEM_MULTI_RANK,
                         "across ranks this slice runs the Adasum tree as "
                         "RVH (op='adasum')")


def make_combiner(cfg: CombineConfig, *, with_stats: bool = False,
                  impl: str = "kernel", donate: bool = False,
                  comm=None) -> Combiner:
    """The registry-dispatched combiner. Every returned combiner carries
    a `combine_path` naming the implementation that actually runs
    ('gspmd-fused' vs 'gspmd-reference', 'rvh'). with_stats=True returns
    a combiner yielding (combined, CombineStats) — see `stats_combiner`.
    `comm` is the group of ranks `adasum-rvh` combines across."""
    if with_stats:
        return stats_combiner(cfg, impl=impl, donate=donate, comm=comm)
    key = registry_key(cfg.op, cfg.backend)
    factory = get_combiner_factory(key)
    _check_ranks(key, comm)
    combiner = factory(cfg, impl=impl, donate=donate, comm=comm)
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


def stats_combiner(cfg: CombineConfig, *, impl: str = "kernel",
                   donate: bool = False, comm=None) -> Combiner:
    """A combiner returning (combined, CombineStats). The adasum gspmd /
    fused paths surface their own per-level triples, and `adasum-rvh`
    the reference's level-0 probe from its round-0 dots (registry.py:
    113-125, :162-171, without exchanging the gradients again); every
    other combiner is wrapped with the level-0 `probe_stats` (taken
    before the combine, which may consume its input)."""
    key = registry_key(cfg.op, cfg.backend)
    _check_ranks(key, comm)
    if key == "adasum-rvh":
        return _adasum_rvh(cfg, impl=impl, donate=donate, comm=comm,
                           with_stats=True)
    if key in ("adasum-gspmd", "adasum-fused"):
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

    base = make_combiner(cfg, impl=impl, donate=donate)

    def probed(stacked):
        stats = probe_stats(stacked, cfg.acc)
        return base(stacked), stats

    probed.combine_path = getattr(base, "combine_path", key)
    return probed


# --------------------------------------------------------------- built-ins
@register_combiner("sum")
def _sum(cfg, **_):
    return lambda stacked: A.sum_reduce(stacked, mean=False)


@register_combiner("mean")
def _mean(cfg, **_):
    return lambda stacked: A.sum_reduce(stacked, mean=True)


@register_combiner("adasum-gspmd")
def _adasum_gspmd(cfg, *, impl="kernel", donate=False, **_):
    """Default backend: the fused bucketed combine (cfg.fused, default
    on), or the per-leaf reference tree when opted out."""
    if cfg.fused:
        fused = build_fused_combiner(cfg, impl=impl, donate=donate)
        fused.combine_path = "gspmd-fused"
        return fused
    fn = tree_combine_per_layer if cfg.per_layer else tree_combine_whole
    ref = lambda stacked: fn(stacked, cfg.acc)
    ref.combine_path = "gspmd-reference"
    return ref


@register_combiner("adasum-fused")
def _adasum_fused(cfg, *, impl="kernel", donate=False, **_):
    """The fused bucketed combine, explicitly (backend='fused'). On one
    device the lane axis is never device-sharded, so it always applies."""
    fused = build_fused_combiner(cfg, impl=impl, donate=donate)
    fused.combine_path = "gspmd-fused"
    return fused


@register_combiner("adasum-rvh")
def _adasum_rvh(cfg, *, impl="kernel", donate=False, comm=None,
                with_stats=False, **_):
    """ADASUMRVH across the ranks of `comm`, one lane per rank."""
    if comm is None:
        raise ValueError(
            "adasum-rvh combines across ranks: pass comm= (a repro_torch."
            "parallel.comm.Comm, one lane per rank); lanes stacked on one "
            "device take backend='gspmd_tree'")
    return build_rvh_combiner(cfg, comm, with_stats=with_stats, impl=impl,
                              donate=donate)


@register_combiner("adasum-linear")
def _adasum_linear(cfg, **_):
    def lin(stacked):
        n = T.leaves(stacked)[0].shape[0]
        lanes = [T.map(lambda x, i=i: x[i], stacked) for i in range(n)]
        return A.adasum_linear_reduce(lanes, per_layer=cfg.per_layer,
                                      acc_dtype=cfg.acc)
    return lin


@register_combiner("adascale")
def _adascale(cfg, **_):
    """AdaScale SGD (Johnson et al., 2020) as a combiner (registry.py:
    241-289 of the reference): the lane mean scaled by the gain ratio

        r = (sigma^2 + mu^2) / (sigma^2 / S + mu^2)      in [1, S]

    (sigma^2: per-lane gradient variance, mu^2: squared mean norm,
    estimated from the S lanes). r -> 1 when lanes agree (combined ==
    mean) and r -> S when lanes are orthogonal (combined == sum).
    `cfg.per_layer` picks per-leaf vs whole-model gain; `cfg.acc` is the
    moment-accumulation dtype."""
    eps = 1e-20

    def gain(var, mu2, S):
        return torch.clamp((var + mu2) / (var / S + mu2 + eps), 1.0, S)

    def moments(x, S):
        xa = x.to(cfg.acc)
        m = xa.mean(dim=0)
        var = torch.square(xa - m).sum() / max(S - 1, 1)
        return m, var, torch.square(m).sum()

    def combine(stacked):
        S = T.leaves(stacked)[0].shape[0]
        if cfg.per_layer:
            def per_leaf(x):
                m, var, msq = moments(x, S)
                mu2 = torch.clamp(msq - var / S, min=0.0)
                return (gain(var, mu2, S) * m).to(x.dtype)
            return T.map(per_leaf, stacked)
        leaves, treedef = T.flatten(stacked)
        mo = [moments(x, S) for x in leaves]
        var = sum(v for _, v, _ in mo)
        mu2 = torch.clamp(sum(m2 for _, _, m2 in mo) - var / S, min=0.0)
        r = gain(var, mu2, S)
        return T.unflatten(treedef, [(r * m).to(x.dtype)
                                     for (m, _, _), x in zip(mo, leaves)])

    return combine
