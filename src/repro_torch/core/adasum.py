"""Adasum: the paper's adaptive gradient combiner (Section 3) — the port
of `repro/core/adasum.py`.

Pairwise op, reference recursive-tree reduction, and per-layer pytree
application: the reference (non-distributed) forms the fused combine is
held against, and the ring-order recursion across ranks
(`adasum_linear_ranks`). Dot products and norms accumulate in
`acc_dtype` (fp32, or the paper's fp64, §4.4.1).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Union

import torch

from repro_torch import tree as T

# Guard against division by zero for all-zero gradients (e.g. untouched
# MoE experts). With EPS in the denominator the combiner degrades to a
# plain sum, which is the correct limit: a zero gradient is orthogonal
# to everything.
EPS = 1e-30

PyTree = Any


def _flat_dot(a: torch.Tensor, b: torch.Tensor, acc_dtype) -> torch.Tensor:
    """Dot product of two equally-shaped tensors, accumulated in acc_dtype."""
    return torch.dot(a.to(acc_dtype).reshape(-1), b.to(acc_dtype).reshape(-1))


def adasum_scalars(dot, n1sq, n2sq):
    """The two Adasum coefficients given dot = g1·g2, n1sq = ‖g1‖²,
    n2sq = ‖g2‖²: Adasum(g1,g2) = s1*g1 + s2*g2 with
        s1 = 1 - dot / (2‖g1‖²),   s2 = 1 - dot / (2‖g2‖²)."""
    s1 = 1.0 - dot / (2.0 * n1sq + EPS)
    s2 = 1.0 - dot / (2.0 * n2sq + EPS)
    return s1, s2


def adasum_segment_scalars(v: torch.Tensor):
    """`adasum_scalars` over stacked per-segment dot triples v [..., 3]
    ([g1·g2, ‖g1‖², ‖g2‖²], the layout `block_dots` emits). All-zero rows
    (padding segments) yield s1 = s2 = 1, the plain-sum limit."""
    return adasum_scalars(v[..., 0], v[..., 1], v[..., 2])


def adasum_pair(g1: torch.Tensor, g2: torch.Tensor, *,
                acc_dtype=torch.float32) -> torch.Tensor:
    """Adasum of two gradient tensors (whole-tensor granularity)."""
    dot = _flat_dot(g1, g2, acc_dtype)
    n1 = _flat_dot(g1, g1, acc_dtype)
    n2 = _flat_dot(g2, g2, acc_dtype)
    s1, s2 = adasum_scalars(dot, n1, n2)
    return s1.to(g1.dtype) * g1 + s2.to(g2.dtype) * g2


def adasum_pair_pytree(t1: PyTree, t2: PyTree, *, per_layer: bool = True,
                       acc_dtype=torch.float32) -> PyTree:
    """Adasum of two gradient pytrees. per_layer=True (paper §3.6): each
    leaf gets its own dot/norms. per_layer=False: one dot/norm over the
    concatenation of all leaves (whole-model granularity)."""
    if per_layer:
        return T.map(lambda a, b: adasum_pair(a, b, acc_dtype=acc_dtype),
                     t1, t2)
    l1, treedef = T.flatten(t1)
    l2 = T.leaves(t2)
    dot = sum(_flat_dot(a, b, acc_dtype) for a, b in zip(l1, l2))
    n1 = sum(_flat_dot(a, a, acc_dtype) for a in l1)
    n2 = sum(_flat_dot(b, b, acc_dtype) for b in l2)
    s1, s2 = adasum_scalars(dot, n1, n2)
    return T.unflatten(treedef, [s1.to(a.dtype) * a + s2.to(b.dtype) * b
                                 for a, b in zip(l1, l2)])


def _as_lanes(grads: Union[Sequence[PyTree], PyTree]) -> list:
    if isinstance(grads, (list, tuple)):
        return list(grads)
    n = T.leaves(grads)[0].shape[0]
    return [T.map(lambda x, i=i: x[i], grads) for i in range(n)]


def adasum_tree_reduce(grads, *, per_layer: bool = True,
                       acc_dtype=torch.float32) -> PyTree:
    """Reference recursive binary-tree Adasum over N gradients (§3.4).

    `grads` is a list of pytrees or one pytree whose leaves carry a
    leading axis of (power-of-two) length N. Adjacent leaves pair at the
    bottom of the tree — the tree shape ADASUMRVH builds."""
    grads = _as_lanes(grads)
    n = len(grads)
    if n & (n - 1):
        raise ValueError(f"Adasum tree reduce needs power-of-two inputs, "
                         f"got {n}")
    while len(grads) > 1:
        grads = [adasum_pair_pytree(grads[2 * i], grads[2 * i + 1],
                                    per_layer=per_layer, acc_dtype=acc_dtype)
                 for i in range(len(grads) // 2)]
    return grads[0]


def adasum_linear_reduce(grads: Sequence[PyTree], *, per_layer: bool = True,
                         acc_dtype=torch.float32) -> PyTree:
    """Ring-order recursion (§3.4 first form):
    Adasum(g[0,n+1]) = Adasum(Adasum(g[0,n]), g[n+1])."""
    acc = grads[0]
    for g in grads[1:]:
        acc = adasum_pair_pytree(acc, g, per_layer=per_layer,
                                 acc_dtype=acc_dtype)
    return acc


def sum_reduce(grads, mean: bool = False) -> PyTree:
    """Baseline synchronous-SGD combiner (Horovod Sum/Average)."""
    if not isinstance(grads, (list, tuple)):
        op = (lambda x: x.mean(dim=0)) if mean else (lambda x: x.sum(dim=0))
        return T.map(op, grads)
    acc = T.map(lambda *xs: sum(xs[1:], xs[0]), *grads)
    if mean:
        acc = T.map(lambda x: x / len(grads), acc)
    return acc


def _chunks(n: int, world: int):
    """Rank q's range of an n-element leaf: [q·c, min((q+1)·c, n)), c =
    ceil(n / world)."""
    c = -(-n // world)
    return [(min(q * c, n), min((q + 1) * c, n)) for q in range(world)]


def shard_sums(v: torch.Tensor, factors: Optional[Sequence[float]] = None,
               shard_comm=None, model_comm=None) -> torch.Tensor:
    """v [n_leaves, ...]: this rank's partial sums of whole-leaf
    quantities over its shards -> the whole leaves' sums, the same bits
    on every rank of both groups: each row scaled by its factor
    (`core.rvh.shard_factors`), then summed over the lane group and over
    the model group, each in rank order."""
    if factors is not None:
        f = torch.tensor(factors, dtype=v.dtype, device=v.device)
        v = v * f.reshape((-1,) + (1,) * (v.dim() - 1))
    for c in (shard_comm, model_comm):
        if c is not None:
            v = c.group_sum(v, c.world)
    return v


def adasum_linear_ranks(tree: PyTree, comm, *, per_layer: bool = True,
                        acc_dtype=torch.float32,
                        factors: Optional[Sequence[float]] = None,
                        shard_comm=None, model_comm=None,
                        dims: Optional[Sequence[Optional[int]]] = None,
                        gather: bool = True,
                        donate: bool = False) -> PyTree:
    """`adasum_linear_reduce` over the lanes of the ranks of `comm`, one
    lane (this rank's `tree`) per rank: the combined tree, the same bits
    on every rank.

    Each rank owns a 1/W chunk of every leaf and receives that chunk of
    every rank's lane (one `all_to_all`), so it holds about two lanes,
    not W. The recursion runs on the chunks in ring order, lane 0 with
    lane 1, then the result with lane 2, ...; at each step each leaf's
    partial [acc·x, acc·acc, x·x] (summed over leaves when not
    per_layer) is summed over the ranks in rank order (`group_sum`), so
    every rank forms the same scalars. The combined chunks then go to
    every rank (a second `all_to_all`).

    On shards (the leaves a lane group's parts, `shard_comm`, or a model
    group's shards, `model_comm`) each step's triples are then scaled
    by `factors` and summed over both groups (`shard_sums`), so the
    scalars are those of the whole leaves. `dims` (one entry per leaf):
    a leaf with a dim d is cut along d, chunk q being rank q's piece of
    it, and with gather=False comes back as this rank's piece (no second
    `all_to_all` for it); the others are cut into flat chunks. donate=
    True frees the input leaves once they are sent."""
    leaves, treedef = T.flatten(tree)
    W, me = comm.world, comm.rank
    if W == 1 or not leaves:
        return tree
    dims = list(dims) if dims is not None else [None] * len(leaves)

    def cut(x, d):
        """The W chunks of leaf x (views)."""
        if d is None:
            flat = x.reshape(-1)
            return [flat[lo:hi] for lo, hi in _chunks(flat.numel(), W)]
        n = x.shape[d] // W
        return [x.narrow(d, q * n, n) for q in range(W)]
    shapes = [tuple(x.shape) for x in leaves]
    cuts = [cut(x, d) for x, d in zip(leaves, dims)]
    lanes = [[torch.empty(c[me].shape, dtype=x.dtype, device=x.device)
              for x, c in zip(leaves, cuts)] for _ in range(W)]
    comm.all_to_all([[c[q] for c in cuts] for q in range(W)], lanes)
    del cuts
    if donate:
        for x in leaves:
            if x.untyped_storage().resizable():
                x.untyped_storage().resize_(0)
    acc = lanes[0]
    for q in range(1, W):
        x = lanes[q]
        v = torch.stack([torch.stack([_flat_dot(a, b, acc_dtype),
                                      _flat_dot(a, a, acc_dtype),
                                      _flat_dot(b, b, acc_dtype)])
                         for a, b in zip(acc, x)])
        v = shard_sums(comm.group_sum(v, W), factors, shard_comm,
                       model_comm)
        if not per_layer:
            v = v.sum(dim=0, keepdim=True).expand(len(acc), 3)
        s1, s2 = adasum_segment_scalars(v)
        # s1·a + s2·b, rounded as written, in acc's own memory
        acc = [a.mul_(s1[i].to(a.dtype)).add_(s2[i].to(b.dtype) * b)
               for i, (a, b) in enumerate(zip(acc, x))]
        lanes[q] = None
    del lanes
    keep = [d is not None and not gather for d in dims]
    out = [a if k else None for a, k in zip(acc, keep)]
    rest = [i for i, k in enumerate(keep) if not k]
    if rest:
        # the combined chunks to every rank: flat chunks straight into the
        # leaf's memory, pieces received apart and put together along d
        flat = {i: torch.empty(math.prod(shapes[i]), dtype=acc[i].dtype,
                               device=acc[i].device)
                for i in rest if dims[i] is None}
        parts = [[cut(flat[i].view(shapes[i]), None)[q] if i in flat
                  else torch.empty_like(acc[i]) for i in rest]
                 for q in range(W)]
        comm.all_to_all([[acc[i] for i in rest]] * W, parts)
        for j, i in enumerate(rest):
            out[i] = flat[i].view(shapes[i]) if i in flat else \
                torch.cat([parts[q][j] for q in range(W)], dim=dims[i])
    return T.unflatten(treedef, out)
