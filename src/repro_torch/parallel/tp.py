"""The model axis: tensor parallelism across the ranks of a model group,
Megatron style (the reference has no such module: GSPMD partitions its
forward and backward passes from `sharding.param_specs`). The port
follows the same specs leaf for leaf, and each layer picks its
collective from its leaf's spec:

  column       the output dim sharded: `copy(x) @ w`, the output stays
               sharded (q/k/v heads, the MLP's gate and up, a
               vocab-sharded head);
  row          the input dim sharded on a sharded input: `reduce(x @ w)`
               (wo over local heads, the MLP's down);
  contraction  the input dim sharded on a whole input (the reference's
               `_contraction_spec`, a head count that the axis does not
               divide): `reduce(scatter(x) @ w)`, the whole output on
               every rank;
  d-split out  the output dim of `wo` sharded when heads do not divide:
               `gather(copy(x) @ w)`.

Four autograd Functions carry it: `copy` (identity forward, all-reduce
backward), `reduce` (all-reduce forward, identity backward), `gather`
(all-gather forward, the rank's slice backward) and `scatter` (the
rank's slice forward, all-gather backward). Every whole activation is
then bitwise equal on the ranks of a model group, and so is every
gradient of a leaf the axis does not shard (a replicated leaf used on a
sharded activation, qk-norm's scales on local heads, goes through
`copy` itself). All-reduces run in fp32 and cast back.

A block leaf's spec is looked up under its stack: `blocks`, or a MoE
config's dense prefix `dense_blocks` (`TensorParallel.at`). The bytes
of every collective are counted by kind in `TensorParallel.bytes`; a
MoE block's one all-reduce of its partial output counts under
`"moe_allreduce"` (and is timed under that name on the comm), the rest
under `"allreduce"` and `"all_gather"`.
"""
from __future__ import annotations

import copy as _copy
from typing import Any, Dict, Optional

import torch

from repro_torch import tree as T
from .sharding import ShardingPolicy, param_specs, spec_leaves

PyTree = Any


def model_specs(cfg, shapes: PyTree, size: int) -> PyTree:
    """The model-axis specs of every leaf (`param_specs` with TP over
    `size` ranks and no data axis)."""
    return param_specs(cfg, shapes, ShardingPolicy(tp_size=size))


def model_dim(spec) -> Optional[int]:
    """The dim a spec shards over "model" (None: the leaf is whole)."""
    for d, e in enumerate(spec or ()):
        if e == "model" or (isinstance(e, tuple) and "model" in e):
            return d
    return None


def model_shard(x, spec, size: int, index: int):
    """Model rank `index`'s shard of a whole leaf `x` (a tensor or a
    numpy array) under `spec`, of `size` ranks: a view."""
    d = model_dim(spec)
    if d is None:
        return x
    n = x.shape[d] // size
    index_ = [slice(None)] * x.ndim
    index_[d] = slice(index * n, (index + 1) * n)
    return x[tuple(index_)]


class TensorParallel:
    """One rank's model group for a forward and backward pass: `comm`
    (the M ranks of this rank's data index), the spec of every param
    leaf by path, and counters of the collectives' bytes."""

    def __init__(self, comm, cfg, shapes: PyTree):
        self.comm = comm
        self.size, self.index = comm.world, comm.rank
        pairs, _ = T.flatten_with_path(shapes)
        specs = spec_leaves(model_specs(cfg, shapes, self.size))
        self.specs: Dict[tuple, Any] = {p: s for (p, _), s in
                                        zip(pairs, specs)}
        self.layers: Dict[str, int] = {p[0]: x.shape[0] for p, x in pairs
                                       if p[0] in ("blocks", "dense_blocks")}
        self.bytes: Dict[str, int] = {}
        self.stack = "blocks"

    def at(self, stack: str) -> "TensorParallel":
        """This group with block leaves looked up under `stack` (the
        same comm and byte counters)."""
        if stack == self.stack:
            return self
        out = _copy.copy(self)
        out.stack = stack
        return out

    # ---------------------------------------------------------- specs
    def dim(self, *path: str) -> Optional[int]:
        """The sharded dim of a leaf; a block leaf (`"attn", "wq"`, no
        stack key) of this group's stack, without its layer axis: -1
        where the axis cuts the layer axis itself (`layer`)."""
        if path in self.specs:
            return model_dim(self.specs[path])
        d = model_dim(self.specs[(self.stack,) + path])
        return None if d is None else d - 1

    def layer(self, blocks: PyTree, l: int) -> PyTree:
        """Layer l of this rank's shards of a stacked [L, ...] subtree of
        this group's stack, as views. A leaf whose layer axis the model
        axis cuts (the reference's rule for expert-partition stacks in
        `blocks`, whose layer axis it does not exempt) holds L/M layers
        a rank: layer l there where this rank holds it, else an empty
        stand-in (its first layer cut to nothing on the next dim)."""
        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, path + (k,)) for k, v in node.items()}
            if model_dim(self.specs[(self.stack,) + path]) != 0:
                return node[l]
            per = self.layers[self.stack] // self.size
            mine = l // per == self.index
            return node[l - self.index * per] if mine else node[0][:0]
        return walk(blocks, ())

    # ---------------------------------------------------- collectives
    def _count(self, kind: str, x: torch.Tensor) -> None:
        self.bytes[kind] = (self.bytes.get(kind, 0)
                            + x.numel() * x.element_size())

    def _allreduce(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        y = x.detach().float().contiguous()
        self._count(kind, y)
        if kind == "allreduce":
            return self.comm.allreduce(y).to(x.dtype)
        with self.comm.timed(kind):
            return self.comm.allreduce(y).to(x.dtype)

    def _allgather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        x = x.detach().contiguous()
        self._count("all_gather", x)
        return torch.cat(self.comm.all_gather(x), dim=dim)

    def _slice(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n).contiguous()

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward, all-reduce backward."""
        return _Copy.apply(x, self) if self.size > 1 else x

    def reduce(self, x: torch.Tensor, kind: str = "allreduce"
               ) -> torch.Tensor:
        """All-reduce forward (counted under `kind`), identity
        backward."""
        return _Reduce.apply(x, self, kind) if self.size > 1 else x

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """All-gather along `dim` forward, the rank's slice backward."""
        return _Gather.apply(x, self, dim % x.dim()) if self.size > 1 \
            else x

    def scatter(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The rank's slice along `dim` forward, all-gather backward."""
        return _Scatter.apply(x, self, dim % x.dim()) if self.size > 1 \
            else x

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """Element-wise maximum over the group (no gradient)."""
        y = x.detach().float().contiguous()
        self._count("allreduce", y)
        return self.comm.allreduce(y, op="max").to(x.dtype)

    # --------------------------------------------------------- layers
    def linear(self, x: torch.Tensor, w: torch.Tensor, dim: Optional[int],
               *, sharded_in: bool = False, gather_out: bool = False
               ) -> torch.Tensor:
        """x @ w, with w this rank's piece sharded on `dim` (0: input,
        1: output, None: whole). `sharded_in`: x holds this rank's
        features already (a row-parallel layer); `gather_out`: a
        column-parallel output is gathered whole (d-split out)."""
        if dim is None:
            if sharded_in:
                raise ValueError("a whole weight on a sharded input")
            return x @ w
        if dim == 1:
            y = self.copy(x) @ w
            return self.gather(y, -1) if gather_out else y
        if not sharded_in:
            x = self.scatter(x, -1)
        return self.reduce(x @ w)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._allreduce(g, "allreduce"), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, kind):
        return tp._allreduce(x, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp._allgather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._slice(g, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp._slice(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._allgather(g, ctx.dim), None, None
