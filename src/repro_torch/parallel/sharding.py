"""Sharding rules: parameter-tree paths -> partition specs (the port's own
copy of `repro/parallel/sharding.py`; it imports nothing of it).

Policy (the reference's, rule for rule):
  * TP over the `model` axis: head-projection outputs (when head counts
    divide the axis), MLP hidden dims, expert dims (EP) or expert hidden
    (TP-in-expert), vocab (when divisible, else d_model).
  * When a head count does NOT divide the model axis, the projection
    falls back to contraction sharding (input dim over `model`).
  * FSDP over the `data` axis (optional): the first non-TP dim of every
    large matrix that the data axis divides (ZeRO-3).
  * Optimizer state: ZeRO-1 — the same rules with FSDP always on.
All rules respect divisibility: an axis that does not divide the dim is
dropped from the spec.

A spec is a tuple with one entry per dim: None (replicated), an axis
name, or a tuple of axis names (major to minor, as a PartitionSpec
entry). `shard` takes one device's piece of a full tensor under a spec,
`unshard` puts the pieces back together; `local_shape` is the piece's
shape; each takes "data", "model" and the ranks' own axis names alike.
`cache_specs` is the reference's serving-cache rule. Across ranks the port names the data axis after the ranks' two
coordinates (see `engine/build.py`): rank r = lane·g + member, and a
leaf the reference shards over `data` is split ("member", "lane") — its
1/g lane-group part (member-major) nests the rank's own 1/W piece.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree as T

PyTree = Any
Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    tp_axis: str = "model"
    fsdp_axis: Optional[str] = None      # e.g. "data" for ZeRO-3
    tp_size: int = 1
    fsdp_size: int = 1


def _fits(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, major to minor."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Optional[Spec]) -> Tuple[str, ...]:
    """The sorted set of axes a spec shards over (the reference's key
    for grouping leaves and summing their dots, sharding.py:48)."""
    return tuple(sorted({ax for e in (spec or ()) for ax in entry_axes(e)}))


def _spec2(shape, pol: ShardingPolicy, tp_dim: int, lead: int = 0) -> Spec:
    """Spec for a matrix whose dim `tp_dim` gets TP and the other big dim
    gets FSDP. `lead` leading dims (layer-stack) stay unsharded."""
    entries: List[Any] = [None] * len(shape)
    if _fits(shape[tp_dim], pol.tp_size):
        entries[tp_dim] = pol.tp_axis
    if pol.fsdp_axis:
        for d in range(lead, len(shape)):
            if d != tp_dim and entries[d] is None and \
                    _fits(shape[d], pol.fsdp_size):
                entries[d] = pol.fsdp_axis
                break
    return tuple(entries)


def _contraction_spec(shape, pol: ShardingPolicy, in_dim: int,
                      lead: int = 0) -> Spec:
    """Fallback: shard the contraction (input) dim over TP."""
    entries: List[Any] = [None] * len(shape)
    if _fits(shape[in_dim], pol.tp_size):
        entries[in_dim] = pol.tp_axis
    if pol.fsdp_axis:
        for d in range(lead, len(shape)):
            if d != in_dim and entries[d] is None and \
                    _fits(shape[d], pol.fsdp_size):
                entries[d] = pol.fsdp_axis
                break
    return tuple(entries)


def param_specs(cfg, shapes: PyTree, pol: ShardingPolicy) -> PyTree:
    """The spec tree matching a params tree (of tensors, meta tensors or
    anything with a `.shape`), by the reference's path rules
    (sharding.py:92-191). The rules read the leaf's path as
    `jax.tree_util.keystr` writes it, so they match where the
    reference's match and miss where its miss."""
    tp = pol.tp_size
    heads_ok = _fits(cfg.n_heads, tp) or cfg.n_heads == 0
    kv_ok = _fits(cfg.n_kv_heads, tp)
    rwkv_heads_ok = cfg.family == "ssm" and \
        _fits(cfg.d_model // max(cfg.rwkv_head_dim, 1), tp)
    ssm_ok = _fits(cfg.ssm_heads or cfg.n_heads, tp)

    def rule(name: str, shape) -> Spec:
        lead = 1 if (".blocks" in name or "dense_blocks" in name
                     or "enc_blocks" in name or "dec_blocks" in name) else 0
        nd = len(shape)
        last2 = (nd - 2, nd - 1)
        none = tuple([None] * nd)

        def out_spec():   # (in, out_headed): TP on output
            return _spec2(shape, pol, last2[1], lead)

        def in_spec():    # (headed, out): TP on input
            return _spec2(shape, pol, last2[0], lead)

        def contraction():
            return _contraction_spec(shape, pol, last2[0], lead)

        if nd - lead < 1:
            return none
        # ---- embeddings / heads ----
        if "embed" in name and "table" in name:
            if _fits(cfg.vocab_size, tp):
                return _spec2(shape, pol, 0)
            return _spec2(shape, pol, 1)
        if "lm_head" in name:
            if _fits(cfg.vocab_size, tp):
                return out_spec()
            return contraction()
        # ---- MoE ----
        if re.search(r"moe'?\]?\[?'?(w_gate|w_up)", name):
            tp_dim = 0 + lead if cfg.expert_partition == "expert" else nd - 1
            return _spec2(shape, pol, tp_dim, lead)
        if re.search(r"moe'?\]?\[?'?w_down", name):
            tp_dim = 0 + lead if cfg.expert_partition == "expert" else nd - 2
            return _spec2(shape, pol, tp_dim, lead)
        if "router" in name:
            return none
        # ---- rwkv ----
        if "'time'" in name or "time." in name:
            if "w_o" in name:
                return in_spec() if rwkv_heads_ok else contraction()
            if re.search(r"w_[rkvg]", name):
                return out_spec() if rwkv_heads_ok else contraction()
            if "decay_B" in name and rwkv_heads_ok:
                return out_spec()
            if "bonus" in name and rwkv_heads_ok:
                return _spec2(shape, pol, lead)
            return none
        if "'chan'" in name or "chan." in name:
            if "w_k" in name:
                return out_spec()
            if "w_v" in name:
                return in_spec()
            return none
        # ---- mamba (hybrid mixer) ----
        if "mamba" in name:
            if re.search(r"w_[xz]", name) or "conv_w" in name:
                return out_spec() if ssm_ok else none
            if "w_out" in name:
                return in_spec() if ssm_ok else contraction()
            return none
        # ---- attention ----
        if re.search(r"w[q]\b|'wq'", name):
            return out_spec() if heads_ok else contraction()
        if re.search(r"'w[kv]'", name):
            # cross-attention (enc-dec) uses full heads; GQA uses kv heads
            ok = heads_ok if "xattn" in name else kv_ok
            return out_spec() if ok else contraction()
        if "'wo'" in name:
            return in_spec() if heads_ok else out_spec()
        if "q_up" in name or "kv_up" in name:
            return out_spec() if heads_ok else contraction()
        if "q_down" in name:
            return out_spec() if _fits(cfg.q_lora_rank, tp) else contraction()
        if "kv_down" in name:
            return contraction()
        # ---- MLP ----
        if re.search(r"w_gate|w_up", name):
            return out_spec()
        if "w_down" in name:
            return in_spec()
        # ---- frontends ----
        if "projector" in name or "frontend_proj" in name:
            if "w1" in name or "frontend_proj" in name:
                return out_spec()
            return in_spec()
        return none

    pairs, td = T.flatten_with_path(shapes)
    return T.unflatten(td, [rule(T.keystr(p), tuple(x.shape))
                            for p, x in pairs])


def rename(spec: Spec, names: Dict[str, Any]) -> Spec:
    """The spec with each axis in `names` replaced by its value (a name,
    a tuple of names, or None to drop it)."""
    out = []
    for e in spec:
        axes: List[str] = []
        for ax in entry_axes(e):
            new = names.get(ax, ax)
            axes.extend(entry_axes(new))
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else tuple(axes))
    return tuple(out)


def only(spec: Spec, axis: str) -> Spec:
    """The part of a spec over one axis: every other axis dropped (a
    spec over ("data", "model") -> its data part or its model part)."""
    return tuple(axis if axis in entry_axes(e) else None for e in spec)


def _count(entry, sizes: Dict[str, int]) -> int:
    return math.prod(sizes[ax] for ax in entry_axes(entry))


def _index(entry, coords: Dict[str, int], sizes: Dict[str, int]) -> int:
    """The piece index along one dim: the entry's axes, major to minor."""
    i = 0
    for ax in entry_axes(entry):
        i = i * sizes[ax] + coords[ax]
    return i


def local_shape(shape: Sequence[int], spec: Optional[Spec],
                axis_sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The per-device shard shape of a global `shape` under `spec` on a
    mesh with the given axis sizes."""
    out = list(shape)
    for d, entry in enumerate(spec or ()):
        for ax in entry_axes(entry):
            out[d] //= axis_sizes[ax]
    return tuple(out)


def shard(x: torch.Tensor, spec: Optional[Spec], coords: Dict[str, int],
          sizes: Dict[str, int]) -> torch.Tensor:
    """The device at `coords` (axis -> index)'s piece of the full tensor
    `x` under `spec`: a view."""
    for d, entry in enumerate(spec or ()):
        if entry is not None:
            n = x.shape[d] // _count(entry, sizes)
            x = x.narrow(d, _index(entry, coords, sizes) * n, n)
    return x


def unshard(piece: Callable[[Dict[str, int]], torch.Tensor],
            spec: Optional[Spec], sizes: Dict[str, int]) -> torch.Tensor:
    """The full tensor from its pieces: `piece(coords)` is the piece of
    the device at `coords` (the inverse of `shard`; axes the spec does
    not name are taken at index 0)."""
    dims = [(d, e) for d, e in enumerate(spec or ()) if e is not None]

    def build(k: int, coords: Dict[str, int]) -> torch.Tensor:
        if k == len(dims):
            full = {ax: coords.get(ax, 0) for ax in sizes}
            return piece(full)
        d, entry = dims[k]
        axes = entry_axes(entry)
        parts = []
        for i in range(_count(entry, sizes)):
            c, rem = dict(coords), i
            for ax in reversed(axes):
                c[ax] = rem % sizes[ax]
                rem //= sizes[ax]
            parts.append(build(k + 1, c))
        return torch.cat(parts, dim=d)

    return build(0, {})


def sharded_dim(spec: Optional[Spec]) -> Optional[int]:
    """The one dim a data-axis spec shards (None: replicated)."""
    dims = [d for d, e in enumerate(spec or ()) if e is not None]
    if len(dims) > 1:
        raise ValueError(f"spec {spec} shards more than one dim")
    return dims[0] if dims else None


def spec_violations(specs: PyTree, shapes: PyTree,
                    axis_sizes: Dict[str, int]) -> list:
    """Static validity check of a spec tree against declared axis sizes:
    a spec naming an axis the mesh doesn't have, a sharded dim the axis
    sizes don't divide, and one axis used on two dims of the same leaf.
    Returns [(path, problem)] strings."""
    out = []
    for (path, spec), leaf in zip(_spec_pairs(specs), T.leaves(shapes)):
        if spec is None or leaf is None:
            continue
        name = T.keystr(path)
        shape = tuple(leaf.shape)
        seen: set = set()
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            if d >= len(shape):
                out.append((name, f"spec {spec} longer than shape {shape}"))
                break
            for ax in entry_axes(entry):
                if ax not in axis_sizes:
                    out.append((name, f"dim {d}: unknown mesh axis {ax!r} "
                                f"(mesh has {sorted(axis_sizes)})"))
                    continue
                if ax in seen:
                    out.append((name, f"mesh axis {ax!r} used on more than "
                                f"one dim of {spec}"))
                seen.add(ax)
                if shape[d] % axis_sizes[ax] != 0:
                    out.append((name, f"dim {d} ({shape[d]}) not divisible "
                                f"by axis {ax!r}={axis_sizes[ax]}"))
    return out


def _spec_pairs(specs: PyTree, path: tuple = ()) -> list:
    """(path, spec) in flatten order, a spec tuple being one leaf."""
    if isinstance(specs, dict):
        return [pair for k in sorted(specs)
                for pair in _spec_pairs(specs[k], path + (k,))]
    if isinstance(specs, list):
        return [pair for i, c in enumerate(specs)
                for pair in _spec_pairs(c, path + (i,))]
    return [(path, specs)]


def spec_leaves(specs: PyTree) -> list:
    """The specs of a spec tree in the params' flatten order."""
    return [s for _, s in _spec_pairs(specs)]


def cache_specs(cache_shapes: PyTree, cfg, pol: ShardingPolicy,
                dp_axes: Sequence[str], batch: int, dp_total: int) -> list:
    """KV-cache / state specs for serving (sharding.py:271-289 of the
    reference), one per leaf of `cache_shapes` (anything with a
    `.shape`) in flatten order: the batch dim over DP when it divides;
    the capacity / sequence dim (dim 2) over TP when it divides, else
    dim 3; each leaf falls back on its own."""
    dp = tuple(dp_axes)
    out = []
    for leaf in T.leaves(cache_shapes):
        shape = tuple(leaf.shape)
        entries: List[Any] = [None] * len(shape)
        # [L, B, S, ...] for kv caches; [L, B, H, ...] for states
        if len(shape) >= 2 and _fits(batch, dp_total) and shape[1] == batch:
            # one axis is the axis itself, as a PartitionSpec writes it
            entries[1] = dp[0] if len(dp) == 1 else dp
        if len(shape) >= 3:
            if _fits(shape[2], pol.tp_size):
                entries[2] = pol.tp_axis
            elif len(shape) >= 4 and _fits(shape[3], pol.tp_size):
                entries[3] = pol.tp_axis
        out.append(tuple(entries))
    return out
