"""The data axis sharded across ranks: ZeRO-1 optimizer state, ZeRO-2
lane gradients and FSDP (ZeRO-3) params, one process a rank (the port
of what the reference's GSPMD does with `param_specs` over `data`,
`plan_lane_specs` and its ZeRO-1 state plan, build.py:146-177, 261-284).

Ranks and pieces. W ranks hold `span` lanes, g = W / span ranks a lane
(a lane group); rank r = lane·g + member. A leaf the reference shards
over `data` (`sharding.param_specs` with FSDP over W) splits along that
dim into W pieces ordered ("member", "lane"): rank r holds piece
member·span + lane, and the member's 1/g lane-group part (`gshard`) is
the span pieces member·span .. member·span + span-1, contiguous. A leaf
the data axis does not divide stays whole on every rank, as in the
reference. Each tensor of a step is in one layout a leaf:

  params     the piece under `fsdp`, else whole;
  lane grad  the gshard (whole at g == 1): the lane group's sum,
             reduce-scattered (`scatter_grads`, or `fsdp`'s backward)
             or all-reduced and cut, whatever the combiner;
  state      the piece at the pre point (ZeRO-1); the gshard of the
             rank's own lane at the post point (whole at g == 1, the
             reference's per-lane state at span == dp).

The combiner reduces the gshards across the span ranks of one member
position (`engine/registry.py` on shards): sum and mean element by
element, RVH, adasum-linear and adascale with their dots and moments
summed over the lane group; each keeps the piece (allgather_result=
False) where the piece is what comes next.

FSDP: `RankPlan.fsdp_step` gives the object the step hands the model's
loss (`fsdp=`), whose forward gathers each layer's pieces just before
the layer runs (`models/transformer.py`), through `_Gather`, an autograd
Function: inside the layer's checkpoint, so the recompute gathers again
and no whole layer outlives it. Its backward never sums across lanes: it
adds the layer's gradient (of the rank's share of the loss,
`TokenGroup`, handed to the loss as `token_group=`) into this rank's
lane gradient store — whole at g == 1 (each rank keeps its own lane's
gradient), reduce-scattered over the lane group at g > 1 — and hands
autograd nothing.

The model axis (`model_comm`, the M ranks of one data index; `comm` is
then this rank's data group, of W = world / M ranks): one policy over
both axes gives each leaf its spec (`param_specs` with TP over M and
FSDP over W, as the reference's `build_runtime` on a (data, model)
mesh), and the plan splits it into its model part (`mspecs`) and its
data part (`specs`). A leaf is cut model first: this rank's model shard
(whole where the spec shards nothing on the model axis), and every
layout above is then that shard's, with the data piece cut on the
spec's data dim. The data dim is chosen on the whole leaf's shape and
is never the model dim, so the order gives the reference's
`local_shape` over both axes. FSDP gathers a layer's pieces over the
data group, which gives the rank's model shard of the layer for
`parallel.tp`; LAMB's norms sum over the data ranks holding other
pieces, then over the model group; a checkpoint puts each model
group's shards together on its first rank, then the data pieces (and
the lanes) on rank 0, and a restore cuts the model shard, then the
piece. Without a model axis M = 1 and the plan is the data axis's
alone, as above.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as T
from .sharding import (ShardingPolicy, entry_axes, local_shape, only,
                       param_specs, rename, shard, sharded_dim, spec_leaves,
                       unshard)
from .tp import model_dim, model_shard

PyTree = Any


class TokenGroup:
    """The g ranks of a lane group, each holding a contiguous 1/g of the
    rows of one microbatch (member order). The loss a rank computes is
    its exact share of the microbatch's loss: the label count it divides
    by and the MoE capacity, slot order and load-balance statistics are
    the whole microbatch's (the reference computes each microbatch in
    one call), so the shares' gradients sum to the microbatch's."""

    def __init__(self, comm):
        self.comm = comm
        self.size = comm.world
        self.index = comm.rank

    def sum(self, v: torch.Tensor) -> torch.Tensor:
        """v summed over the members, in rank order (no gradient)."""
        return self.comm.group_sum(v.detach(), self.size)

    def before(self, v: torch.Tensor) -> torch.Tensor:
        """v summed over the members before this one (no gradient)."""
        parts = self.comm.all_gather(v.detach().contiguous())
        out = torch.zeros_like(v)
        for p in parts[:self.index]:
            out += p.to(v.device)
        return out


ADD_PIECE = 1 << 24      # elements `_add` takes at a time


def _add(out: torch.Tensor, x: torch.Tensor) -> None:
    """out += x in fp32, cast to out's dtype (in place for fp32). A bf16
    `out` of more than ADD_PIECE elements goes a slice at a time: the
    fp32 copies of a whole leaf's part (1.45 GiB each for qwen3-32b's
    embedding on a lane group of two) would double the gradient's memory
    at the step's peak. Each element's sum and rounding are the same."""
    if (out.dtype == torch.float32 or out.numel() <= ADD_PIECE
            or out.shape != x.shape or not out.is_contiguous()):
        out.copy_(out.float().add_(x.float()))
        return
    o, v = out.view(-1), x.reshape(-1)
    for s in range(0, o.numel(), ADD_PIECE):
        part = o[s:s + ADD_PIECE]
        part.copy_(part.float().add_(v[s:s + ADD_PIECE].float()))


class RankPlan:
    """This rank's layout of every param leaf (flatten order), and the
    moves between layouts. `comm`: the W ranks of this rank's data group
    (every rank without a model axis); `lane_comm`: its lane group (None
    at g == 1); `rvh_comm`: the span ranks of its member position;
    `model_comm`: its model group (None without a model axis)."""

    def __init__(self, cfg, shapes: PyTree, comm, span: int, *, fsdp: bool,
                 scatter_grads: bool, post: bool,
                 lane_comm=None, rvh_comm=None, shard: bool,
                 model_comm=None):
        W = comm.world
        self.comm, self.lane_comm, self.rvh_comm = comm, lane_comm, rvh_comm
        self.span, self.g = span, W // span
        self.fsdp, self.scatter, self.post = fsdp, scatter_grads, post
        self.sizes = {"lane": span, "member": self.g}
        self.coords = {"lane": comm.rank // self.g,
                       "member": comm.rank % self.g}
        pairs, self.treedef = T.flatten_with_path(shapes)
        self.index = {p: i for i, (p, _) in enumerate(pairs)}
        self.shapes = [tuple(x.shape) for _, x in pairs]      # whole leaves
        self.model_comm = model_comm
        self.msize = model_comm.world if model_comm is not None else 1
        self.mindex = model_comm.rank if model_comm is not None else 0
        # one policy over both axes; shard=False: nothing on the data axis
        # (a regime that shards nothing)
        both = spec_leaves(param_specs(cfg, shapes, ShardingPolicy(
            tp_size=self.msize, fsdp_axis="data",
            fsdp_size=W if shard else 1)))
        self.specs = [only(s, "data") for s in both]
        self.dims = [sharded_dim(s) for s in self.specs]
        self.mspecs = [only(s, "model") for s in both] \
            if self.msize > 1 else [None] * len(self.shapes)
        self.mdims = [model_dim(s) for s in self.mspecs]
        # this rank's model shard of each leaf: what the data layouts cut
        self.mshapes = [local_shape(s, m, {"model": self.msize})
                        for s, m in zip(self.shapes, self.mspecs)]
        self.grad_shapes = self.local_shapes("grads")

    # ------------------------------------------------------------ specs
    def piece_spec(self, i: int):
        return rename(self.specs[i], {"data": ("member", "lane")})

    def gshard_spec(self, i: int):
        return rename(self.specs[i], {"data": "member"})

    def state_spec(self, i: int):
        return self.gshard_spec(i) if self.post else self.piece_spec(i)

    def param_spec(self, i: int):
        return self.piece_spec(i) if self.fsdp else \
            rename(self.specs[i], {"data": None})

    def local_shapes(self, which: str) -> List[Tuple[int, ...]]:
        """This rank's shape of each leaf of `which` ('params', 'state',
        'grads'), by `sharding.local_shape` of its spec."""
        spec = {"params": self.param_spec, "state": self.state_spec,
                "grads": self.gshard_spec}[which]
        return [local_shape(local_shape(s, spec(i), self.sizes),
                            self.mspecs[i], {"model": self.msize})
                for i, s in enumerate(self.shapes)]

    def rank_of(self, coords: Dict[str, int]) -> int:
        return coords["lane"] * self.g + coords["member"]

    # ---------------------------------------------------------- layouts
    # below, "whole" is the data axis's: with a model axis, a whole leaf
    # is this rank's model shard of it (`mshard`)
    def piece(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """A whole leaf -> this rank's piece (a view)."""
        return shard(x, self.piece_spec(i), self.coords, self.sizes)

    def gshard(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """A whole leaf -> this rank's lane-group part (a view)."""
        return shard(x, self.gshard_spec(i), self.coords, self.sizes)

    def sub(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """A gshard -> this rank's piece of it (a view)."""
        d = self.dims[i]
        n = x.shape[d] // self.span
        return x.narrow(d, self.coords["lane"] * n, n)

    def whole_from_pieces(self, i: int, x: torch.Tensor,
                          layer: bool = False) -> torch.Tensor:
        """Every rank's piece -> the whole leaf (all-gather over W); with
        `layer`, of one layer of a stacked leaf sharded within the layer.
        Where the pieces are contiguous slices of the whole (no dim of
        size > 1 before the sharded one) they are received in place."""
        spec = self.piece_spec(i)[1 if layer else 0:]
        shape = self.mshapes[i][1 if layer else 0:]
        d = sharded_dim(spec)
        if all(n == 1 for n in shape[:d]):
            out = torch.empty(shape, dtype=x.dtype, device=x.device)
            n = shape[d] // self.comm.world
            piece = lambda r: (r % self.g) * self.span + r // self.g
            self.comm.all_gather(x, outs=[
                out.narrow(d, piece(r) * n, n)
                for r in range(self.comm.world)])
            return out
        parts = self.comm.all_gather(x)
        return unshard(lambda c: parts[self.rank_of(c)], spec, self.sizes)

    def gshard_from_pieces(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """The member's pieces -> its gshard (all-gather over the span
        ranks of its position, in lane order)."""
        return torch.cat(self.rvh_comm.all_gather(x), dim=self.dims[i])

    def whole_from_gshard(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """The lane group's gshards -> the whole leaf (member order)."""
        if self.lane_comm is None:
            return x
        return torch.cat(self.lane_comm.all_gather(x), dim=self.dims[i])

    def mshard(self, i: int, x):
        """A whole leaf (a tensor or a numpy array) -> this rank's model
        shard of it (a view)."""
        return model_shard(x, self.mspecs[i], self.msize, self.mindex)

    def cut(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """A whole leaf -> this rank's params of it: its model shard, and
        under fsdp that shard's piece, in its own memory (`x` itself
        where the plan cuts nothing)."""
        y = self.mshard(i, x)
        if self.fsdp and self.dims[i] is not None:
            y = self.piece(i, y)
        return x if y is x else y.clone()

    def shard_params(self, params: PyTree) -> PyTree:
        """Whole params -> this rank's (`cut` of every leaf)."""
        leaves, td = T.flatten(params)
        return T.unflatten(td, [self.cut(i, x) for i, x in enumerate(leaves)])

    def state_like(self, params: PyTree) -> PyTree:
        """Stand-ins with this rank's state shapes, on the params'
        device (`DistributedOptimizer.state_like`)."""
        leaves, td = T.flatten(params)
        return T.unflatten(td, [
            torch.empty((), device=x.device).expand(shape)
            for x, shape in zip(leaves, self.local_shapes("state"))])

    def norm_sums(self, layout: str) -> PyTree:
        """Per leaf, the sum of a shard's squared norms over the ranks
        holding the leaf's other shards: first over the data ranks
        holding its other pieces ('piece': the W ranks of the data group;
        'gshard': the lane group), then over the model group where the
        model axis shards it, each in rank order; identity for whole
        leaves."""
        data = self.comm if layout == "piece" else self.lane_comm

        def fn(i):
            comms = [c for c, d in ((data, self.dims[i]),
                                    (self.model_comm, self.mdims[i]))
                     if c is not None and d is not None]

            def total(v):
                for c in comms:
                    v = c.group_sum(v, c.world)
                return v
            return total
        return T.unflatten(self.treedef, [fn(i)
                                          for i in range(len(self.shapes))])

    # ------------------------------------------------------ checkpoints
    def _layout(self, i: int, which: str) -> str:
        if self.dims[i] is None:
            return "whole"
        if which == "params":
            return "piece" if self.fsdp else "whole"
        return "gshard" if self.post else "piece"

    def lanes(self, which: str) -> bool:
        """Whether `which` holds one lane a rank (the checkpoint's
        [span, ...] leaves): the post point's state above one lane."""
        return which == "state" and self.post and self.span > 1

    def gather_tree(self, tree: PyTree, which: str) -> Optional[PyTree]:
        """`which` ('params' or 'state') as the reference's full leaves
        in rank 0's host memory, one leaf at a time (None on the other
        ranks): each model group's shards put together on its first
        rank, then, among those ranks (the data group of model index 0),
        pieces put together, a lane's gshards put together, the lanes
        stacked [span, ...] where each rank holds one. Collective."""
        leaves, td = T.flatten(tree)
        out = []
        for i, x in enumerate(leaves):
            if self.mdims[i] is not None:
                mc = self.model_comm
                rows = mc.gather_to_host(x, list(range(mc.world)))
                x = None if rows is None else \
                    torch.cat(list(rows), self.mdims[i])
                if x is not None and self.comm.backend == "nccl":
                    x = x.to(leaves[i].device)
            out.append(None if self.mindex else self._gather_data(i, x,
                                                                  which))
        top = self.comm.rank == 0 and self.mindex == 0
        return T.unflatten(td, out) if top else None

    def _gather_data(self, i: int, x: torch.Tensor, which: str):
        """`gather_tree` of one leaf over the data group: `x` holds this
        rank's data part of the whole leaf (or of its model shard)."""
        W, g = self.comm.world, self.g
        lanes = self.lanes(which)
        lay = self._layout(i, which)
        if lay == "whole" and not lanes:
            return x
        srcs = ([l * g for l in range(self.span)] if lay == "whole"
                else list(range(W)))
        rows = self.comm.gather_to_host(x, srcs)
        if rows is None or lay == "whole":
            return rows
        if lay == "piece":
            return unshard(lambda c: rows[self.rank_of(c)],
                           self.piece_spec(i), self.sizes)
        one = [torch.cat([rows[l * g + m] for m in range(g)],
                         dim=self.dims[i])
               for l in range(self.span)]
        return torch.stack(one) if lanes else one[0]

    def take(self, i: int, full, which: str):
        """A full leaf (a numpy array or a tensor; one lane's where
        `lanes`) -> this rank's part of it under the plan (a view): its
        model shard, then its data part."""
        full = self.mshard(i, full)
        lay = self._layout(i, which)
        if lay == "whole":
            return full
        spec = self.piece_spec(i) if lay == "piece" else self.gshard_spec(i)
        d = self.dims[i]
        n = full.shape[d] // math.prod(self.sizes[a] for a in
                                       entry_axes(spec[d]))
        k = 0
        for ax in entry_axes(spec[d]):
            k = k * self.sizes[ax] + self.coords[ax]
        index = [slice(None)] * full.ndim
        index[d] = slice(k * n, (k + 1) * n)
        return full[tuple(index)]

    # ------------------------------------------------------- lane grads
    def lane_reduce(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of a lane gradient leaf (whole, weighted) ->
        the lane group's sum in the grad layout."""
        if self.lane_comm is None:
            return x
        d = self.dims[i]
        if d is None:
            return self.lane_comm.allreduce(x)
        if not self.scatter:
            return self.gshard(i, self.lane_comm.allreduce(x))
        n = x.shape[d] // self.g
        return self.lane_comm.reduce_scatter(
            [x.narrow(d, q * n, n) for q in range(self.g)])

    def fsdp_step(self, store: List[Optional[torch.Tensor]], dtype):
        """The `fsdp=` of one gradient call: the model's forward gathers
        the sharded params through it; their gradients go into `store`
        (this rank's lane gradient per sharded leaf, in the grad layout,
        `dtype`), added to what it holds; a leaf's slot is made at its
        first gradient."""
        return _FSDPStep(self, store, dtype)


class _FSDPStep:
    """One rank's FSDP forward/backward: what `transformer.forward`
    calls to gather a subtree or a layer."""

    def __init__(self, plan: RankPlan, store, dtype):
        self.plan = plan
        self.store = store
        self.dtype = dtype

    def _slot(self, i: int, grad: torch.Tensor, whole: bool):
        """Leaf i's store, made now if this is its first gradient: the
        gradient itself where it is the whole slot in its dtype and owns
        its memory (at g == 1), else zeros. Returns (slot, whether grad
        is in it)."""
        if self.store[i] is not None:
            return self.store[i], False
        if whole and grad.dtype == self.dtype and grad._base is None \
                and grad.is_contiguous():
            self.store[i] = grad
            return grad, True
        self.store[i] = torch.zeros(self.plan.grad_shapes[i],
                                    dtype=self.dtype, device=grad.device)
        return self.store[i], False

    def tree(self, node, path: tuple):
        """A subtree of whole leaves (the embedding, lm_head, the
        projector): sharded leaves gathered."""
        if isinstance(node, dict):
            return {k: self.tree(v, path + (k,)) for k, v in node.items()}
        i = self.plan.index[path]
        if self.plan.dims[i] is None:
            return node
        return _Gather.apply(node, (self, i, None))

    def layer(self, blocks, key: str, l: int):
        """Layer l of a stacked [L, ...] block subtree, whole on the data
        axis. A leaf whose layer axis the model axis cuts holds the
        model rank's own layers: layer l at its index there where the
        rank holds it (the whole data group does, or none of it), else
        an empty stand-in, as `TensorParallel.layer`."""
        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, path + (k,)) for k, v in node.items()}
            i = self.plan.index[path]
            d = self.plan.dims[i]
            k = l
            if self.plan.mdims[i] == 0:
                per = self.plan.mshapes[i][0]
                if l // per != self.plan.mindex:
                    return node[0][:0]
                k = l - self.plan.mindex * per
            if d is None:
                return node[k]
            if d > 0:
                return _Gather.apply(node[k], (self, i, k))
            per = node.shape[0]            # layers a piece holds
            mine = self._layer_owner(i, l, per) == self.plan.comm.rank
            local = node[l % per] if mine else node[:0]
            return _Gather.apply(local, (self, i, l))
        return walk(blocks, (key,))

    def _layer_owner(self, i: int, l: int, per: int) -> int:
        p = l // per                       # the piece holding layer l
        return self.plan.rank_of({"member": p // self.plan.span,
                                  "lane": p % self.plan.span})

    # the two halves of `_Gather`
    def gather(self, x: torch.Tensor, i: int, l: Optional[int]):
        plan = self.plan
        d = plan.dims[i]
        if l is None or d > 0:
            return plan.whole_from_pieces(i, x, layer=l is not None)
        shape = plan.mshapes[i][1:]
        owner = self._layer_owner(i, l, plan.mshapes[i][0] // plan.comm.world)
        parts = plan.comm.all_gather(
            x, [shape if r == owner else (0,) + shape[1:]
                for r in range(plan.comm.world)])
        return parts[owner]

    def reduce(self, grad: torch.Tensor, i: int, l: Optional[int]) -> None:
        plan = self.plan
        if plan.lane_comm is None:               # g == 1: the whole lane
            out, done = self._slot(i, grad, l is None)
            if not done:
                _add(out if l is None else out[l], grad)
            return
        g, q = plan.g, plan.coords["member"]
        d = plan.dims[i]
        if l is None or d > 0:
            d = d if l is None else d - 1
            n = grad.shape[d] // g
            got = plan.lane_comm.reduce_scatter(
                [grad.narrow(d, m * n, n) for m in range(g)])
            out, _ = self._slot(i, got, False)
            _add(out if l is None else out[l], got)
            return
        per = plan.mshapes[i][0] // g            # layers a gshard holds
        owner = l // per
        empty = grad[:0]
        got = plan.lane_comm.reduce_scatter(
            [grad if m == owner else empty for m in range(g)])
        out, _ = self._slot(i, got, False)
        if q == owner:
            _add(out[l - owner * per], got)


class _Gather(torch.autograd.Function):
    """Forward: this rank's piece of a leaf (or of one layer of it) ->
    the whole, gathered from every rank. Backward: the gradient goes
    into the step's lane-gradient store (see the module docstring);
    autograd gets None for the piece."""

    @staticmethod
    def forward(ctx, x, where):
        step, i, l = where
        ctx.where = where
        return step.gather(x.detach(), i, l)

    @staticmethod
    def backward(ctx, grad):
        step, i, l = ctx.where
        step.reduce(grad, i, l)
        return None, None
