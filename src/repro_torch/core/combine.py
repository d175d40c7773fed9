"""Gradient-combination primitives: Sum / Mean / Adasum over stacked lanes
(the port of `repro/core/combine.py`), the sums and means across ranks,
and the delayed combine's correction.

All combiners operate on a *stacked* gradient pytree — leaves carry a
leading lane axis of length `span` (one lane per Adasum leaf). Dispatch
lives in `repro_torch.engine.registry`. This module keeps
`CombineConfig`, the per-leaf reference trees, and the fused bucketed
path the `gspmd_tree` backend runs by default:

  * leaves are grouped by dtype and packed into Horovod-style buckets of
    `fusion_threshold_mb`, each leaf starting at a kernel-block boundary;
  * per tree level, each bucket runs one `block_dots` pass over its lane
    pairs (both halves read once), an order-fixed block->segment sum for
    the §3.6 per-layer coefficients, and one `block_combine` write.

On one device there is no mesh: the reference's psum-free branch
(`psum=False`, combine.py:458-464) is the whole path, and `fused_plan`
groups by dtype alone. `impl="kernel"` sends the block passes through
the kernel wrappers (CUDA kernels on a card, their plain versions on the
CPU); `impl="plain"` asks the same wrappers for their plain versions on
any device (the on-card reference `chip_smoke.py` holds the kernels
to).

Accumulation (`cfg.acc_dtype`, fp32 or the paper's fp64, §4.4.1): every
dot, segment sum and Adasum scalar is taken in it. The block passes
follow the reference's two arms: impl='kernel' casts the kernel's fp32
block partials, impl='plain' accumulates in acc_dtype throughout; the
scalars then go to `block_combine` as they are (the kernel reads them
as fp32, its plain arm by the rule `use_pallas` names).

Memory: a level's buffer is dropped once the next level is written, and
with `donate=True` the stacked input leaves are released (their storage
freed) as soon as they are packed, as XLA reuses donated buffers in the
reference. The caller must not read a donated tree again.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.kernels import adasum as K
from . import adasum as A
from . import fusion

PyTree = Any
COMBINE_IMPLS = ("kernel", "plain")


@dataclasses.dataclass(frozen=True)
class CombineConfig:
    op: str = "adasum"            # 'sum' | 'mean' | 'adasum'
    point: str = "auto"           # 'pre' | 'post' | 'auto'
    backend: str = "gspmd_tree"   # 'gspmd_tree' | 'rvh' | 'fused' | 'linear'
    span: int = 0                 # #lanes; 0 => one lane per DP rank
    per_layer: bool = True        # paper §3.6
    acc_dtype: str = "float32"    # paper §4.4.1 (fp64 there)
    use_pallas: bool = False      # kernel granule (1024) and fp32 combine
                                  # math on the CPU arm; see fused_plan
    hierarchical: bool = False    # sum inside pod, Adasum across pods (§4.2.2)
    compress: str = "none"        # 'int8': quantized RVH wire payloads
    fused: bool = True            # bucketed single-pass gspmd_tree hot path
    fusion_threshold_mb: int = 64 # Horovod-style per-bucket packing budget

    @property
    def acc(self) -> torch.dtype:
        return getattr(torch, self.acc_dtype)

    @property
    def fusion_bytes(self) -> int:
        return max(int(self.fusion_threshold_mb * (1 << 20)), 1 << 10)


def _split_lanes(x: torch.Tensor):
    """[n, *shape] -> a, b = even/odd lanes [n//2, *shape] (views)."""
    n = x.shape[0]
    y = x.reshape((n // 2, 2) + tuple(x.shape[1:]))
    return y[:, 0], y[:, 1]


def _pair_dots(a: torch.Tensor, b: torch.Tensor, acc_dtype):
    af, bf = a.to(acc_dtype), b.to(acc_dtype)
    if a.dim() == 1:                      # scalar leaves: nothing to sum
        return af * bf, af * af, bf * bf
    dims = tuple(range(1, a.dim()))
    return ((af * bf).sum(dims), (af * af).sum(dims), (bf * bf).sum(dims))


def _bcast(s: torch.Tensor, ndim: int) -> torch.Tensor:
    return s.reshape(tuple(s.shape) + (1,) * (ndim - 1))


def _pair_combine_stacked(x: torch.Tensor, acc_dtype) -> torch.Tensor:
    """One tree level on a stacked leaf [n, *shape] -> [n//2, *shape],
    pairing adjacent lanes, per-leaf (= per-layer) dots."""
    a, b = _split_lanes(x)
    dot, na, nb = _pair_dots(a, b, acc_dtype)
    s1, s2 = A.adasum_scalars(dot, na, nb)
    return (_bcast(s1, a.dim()).to(x.dtype) * a
            + _bcast(s2, b.dim()).to(x.dtype) * b)


def _level_triple(leaves, acc_dtype) -> torch.Tensor:
    """Total [dot, ‖a‖², ‖b‖²] of one tree level, summed over every leaf
    and lane pair — the CombineStats payload."""
    tot = torch.zeros((3,), dtype=acc_dtype, device=leaves[0].device)
    for l in leaves:
        a, b = _split_lanes(l)
        dot, na, nb = _pair_dots(a, b, acc_dtype)
        tot = tot + torch.stack([dot.sum(), na.sum(), nb.sum()]).to(acc_dtype)
    return tot


def tree_combine_per_layer(stacked: PyTree, acc_dtype,
                           collect: Optional[list] = None) -> PyTree:
    n = T.leaves(stacked)[0].shape[0]
    while n > 1:
        if collect is not None:
            collect.append(_level_triple(T.leaves(stacked), acc_dtype))
        stacked = T.map(lambda x: _pair_combine_stacked(x, acc_dtype),
                        stacked)
        n //= 2
    return T.map(lambda x: x[0], stacked)


def tree_combine_whole(stacked: PyTree, acc_dtype,
                       collect: Optional[list] = None) -> PyTree:
    """Whole-model granularity: dots accumulated across all leaves."""
    n = T.leaves(stacked)[0].shape[0]
    while n > 1:
        leaves, treedef = T.flatten(stacked)
        pairs = [_split_lanes(l) for l in leaves]
        dots = [_pair_dots(a, b, acc_dtype) for a, b in pairs]
        dot = sum(d[0] for d in dots)
        na = sum(d[1] for d in dots)
        nb = sum(d[2] for d in dots)
        if collect is not None:
            collect.append(torch.stack([dot.sum(), na.sum(), nb.sum()]))
        s1, s2 = A.adasum_scalars(dot, na, nb)
        out = [(_bcast(s1, a.dim()).to(l.dtype) * a
                + _bcast(s2, b.dim()).to(l.dtype) * b)
               for (a, b), l in zip(pairs, leaves)]
        stacked = T.unflatten(treedef, out)
        n //= 2
    return T.map(lambda x: x[0], stacked)


def stack_stats(collect: list) -> dict:
    """CombineStats from collected per-level triples: {'levels': f32
    [num_levels, 3]} with rows [Σ dot, Σ ‖a‖², Σ ‖b‖²]; [0, 3] when
    nothing was paired (span 1)."""
    if not collect:
        return {"levels": torch.zeros((0, 3), dtype=torch.float32)}
    return {"levels": torch.stack(collect).float()}


# --------------------------------------------------------------- fused path
def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).rsplit(".", 1)[-1]


def fused_plan(leaves, cfg: CombineConfig):
    """Static bucketing of stacked leaves: group by dtype, split groups at
    the fusion threshold, pick a kernel block + layout per bucket.
    Returns [(leaf_idxs, layout, block_elems, psum_axes)] — all host
    ints, equal to the reference's `fused_plan(..., psum=False)`; the
    psum axes are always () on one device."""
    groups = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(((), _dtype_name(leaf.dtype)), []).append(i)
    plan = []
    # block granule: 1024 (the TPU kernels' fp32 tile) when the config
    # names the kernels, 256 otherwise; the CUDA kernels take either
    unit = 1024 if cfg.use_pallas else 256
    for (axes, _dt), idxs in sorted(groups.items()):
        payload = [fusion.Spec(tuple(leaves[i].shape[1:]), leaves[i].dtype)
                   for i in idxs]
        sizes = [int(np.prod(p.shape)) if p.shape else 1 for p in payload]
        nbytes = [s * p.dtype.itemsize for s, p in zip(sizes, payload)]
        for s, e in fusion.bucketize_sizes(nbytes, cfg.fusion_bytes):
            block = fusion.select_block_elems(sizes[s:e], unit=unit)
            layout = fusion.make_layout(tuple(payload[s:e]),
                                        leaf_align=block)
            plan.append((tuple(idxs[s:e]), layout, block, axes))
    return plan


def plan_summary(plan) -> List[dict]:
    """Host-readable description of a fused plan, one dict per bucket."""
    return [{
        "leaves": len(idxs),
        "axes": list(axes),
        "dtype": _dtype_name(layout.dtypes[0]),
        "block_elems": int(block),
        "padded_elems": int(layout.padded_len),
        "payload_bytes": int(fusion.layout_bytes(layout)),
    } for idxs, layout, block, axes in plan]


@dataclasses.dataclass(frozen=True)
class _Meta:
    """One bucket's static pieces: its layout and block, the block ->
    segment map (+ the padding segment) and its order-fixed sum."""
    layout: fusion.FusionLayout
    block: int
    nblk: int
    block_seg: torch.Tensor       # int64 [nblk]
    seg_sum: K.SegmentSum


def block_partials(a, b, block: int, acc_dtype, impl: str):
    """Per-block dot triples in acc_dtype, by the reference's two arms
    (combine.py:233-240): the kernel's fp32 partials cast to acc_dtype
    (impl='kernel'), or the plain version accumulating in acc_dtype
    throughout (impl='plain')."""
    if impl == "plain":
        return K.block_dots(a, b, block_elems=block, plain=True,
                            acc_dtype=acc_dtype)
    return K.block_dots(a, b, block_elems=block).to(acc_dtype)


def _bucket_dots(a, b, meta: _Meta, acc_dtype, impl: str):
    """Single-pass per-(pair, segment) dot triples for one bucket level:
    [p, L] lane halves -> [p, nseg1, 3] via per-block partials and the
    order-fixed segment sum."""
    blocks = block_partials(a, b, meta.block, acc_dtype, impl)
    return meta.seg_sum(blocks.reshape(a.shape[0], meta.nblk, 3))


def _bucket_combine(a, b, s1b, s2b, block: int, use_pallas: bool,
                    impl: str):
    """[p, L] halves, [p * nblk] scalars -> [p, L]. The plain arm follows
    the rule `use_pallas` names (combine.py:244-249)."""
    return K.block_combine(a, b, s1b, s2b, block_elems=block,
                           fp32_math=use_pallas, plain=impl == "plain")


def _release(t: torch.Tensor) -> None:
    """Free a donated tensor's storage now (its Python object may still
    be referenced by the caller, who must not read it again). A storage
    shared with numpy (`.numpy()` was called on it) cannot be resized
    and is left to its last reference."""
    storage = t.untyped_storage()
    if storage.resizable():
        storage.resize_(0)


def _block_segments(layout: fusion.FusionLayout, block: int) -> np.ndarray:
    """`layout.segment_ids()[::block]` (the segment of each block's first
    element) without the element-level array, which for the embedding
    bucket would be a 3 GB host array every step. Exact because every
    leaf starts on a block boundary."""
    seg = np.full((layout.padded_len // block,), layout.num_segments,
                  dtype=np.int64)
    for i, (off, sz) in enumerate(zip(layout.offsets, layout.sizes)):
        seg[off // block:(off + sz + block - 1) // block] = i
    return seg


def _bucket_metas(plan, device) -> List[_Meta]:
    """Each bucket's block -> segment map and its order-fixed sum."""
    metas = []
    for _idxs, layout, block, _axes in plan:
        block_seg = _block_segments(layout, block)
        metas.append(_Meta(layout, block, len(block_seg),
                           torch.as_tensor(block_seg, device=device),
                           K.SegmentSum(block_seg, layout.num_segments + 1,
                                        device)))
    return metas


def _pack_buckets(leaves, plan, donate: bool = False):
    """Pack stacked leaves into the plan's fusion buffers, once; every
    tree level then reads each buffer exactly once."""
    packed = []
    for idxs, layout, _block, _axes in plan:
        packed.append(fusion.pack_stacked([leaves[i] for i in idxs], layout))
        if donate:
            for i in idxs:
                _release(leaves[i])
    return packed


def _bucket_level_dots(buf, meta: _Meta, cfg: CombineConfig, impl: str):
    """One tree level's dot triples for one bucket buffer [n, L]: lane
    pair i is rows (2i, 2i+1), read in place as [p, L] views."""
    p, L = buf.shape[0] // 2, buf.shape[1]
    y = buf.view(p, 2, L)
    a, b = y[:, 0], y[:, 1]
    return (a, b), _bucket_dots(a, b, meta, cfg.acc, impl)


def _bucket_chain(buf, meta: _Meta, cfg: CombineConfig, impl: str,
                  collect: Optional[list] = None):
    """Full per-layer tree reduction of ONE bucket [n, L] -> [1, L]. Each
    level's buffer is dropped once the next one is written. `collect`
    (one [3] entry per level, shared across buckets) receives the
    level's dot triples."""
    n = buf.shape[0]
    level = 0
    while n > 1:
        (a, b), v = _bucket_level_dots(buf, meta, cfg, impl)
        if collect is not None:
            collect[level] = collect[level] + v.sum(dim=(0, 1))
        s1, s2 = A.adasum_segment_scalars(v)            # [p, nseg1]
        s1b = s1[:, meta.block_seg].reshape(-1)
        s2b = s2[:, meta.block_seg].reshape(-1)
        out = _bucket_combine(a, b, s1b, s2b, meta.block, cfg.use_pallas,
                              impl)
        del a, b
        buf = out
        n //= 2
        level += 1
    return buf


def _whole_model_levels(packed, metas, cfg: CombineConfig, impl: str,
                        collect: Optional[list] = None):
    """Level-major reduction at whole-model granularity (§3.6 off): each
    level's triples are summed across ALL buckets before the scalars
    form."""
    n = packed[0].shape[0]
    while n > 1:
        p = n // 2
        halves, dots = [], []
        for buf, meta in zip(packed, metas):
            h, v = _bucket_level_dots(buf, meta, cfg, impl)
            halves.append(h)
            dots.append(v)
        packed = None
        level_v = sum(v.sum(dim=1) for v in dots)          # [p, 3]
        if collect is not None:
            collect.append(level_v.sum(dim=0))
        s1w, s2w = A.adasum_segment_scalars(level_v)
        new = []
        for (a, b), meta in zip(halves, metas):
            new.append(_bucket_combine(
                a, b, s1w.repeat_interleave(meta.nblk),
                s2w.repeat_interleave(meta.nblk), meta.block,
                cfg.use_pallas, impl))
        halves = None
        packed = new
        n = p
    return packed


def _unpack_buffers(bufs, plan, n_leaves: int, treedef):
    out_leaves: List[Any] = [None] * n_leaves
    for buf, (idxs, layout, _b, _a) in zip(bufs, plan):
        for i, r in zip(idxs, T.leaves(fusion.unpack(buf.reshape(-1),
                                                     layout))):
            out_leaves[i] = r
    return T.unflatten(treedef, out_leaves)


def _cached_plan(leaves, cfg: CombineConfig, cache: Optional[dict]):
    """The fused plan and bucket maps of these leaves, from `cache` (keyed
    by leaf shapes, dtypes and device) when it holds them."""
    key = (tuple((tuple(x.shape), x.dtype) for x in leaves),
           leaves[0].device)
    if cache is not None and key in cache:
        return cache[key]
    plan = fused_plan(leaves, cfg)
    metas = _bucket_metas(plan, leaves[0].device)
    if cache is not None:
        cache[key] = plan, metas
    return plan, metas


def fused_combine_tree(stacked: PyTree, cfg: CombineConfig,
                       collect: Optional[list] = None, *,
                       impl: str = "kernel", donate: bool = False,
                       cache: Optional[dict] = None) -> PyTree:
    """Bucketed single-pass Adasum tree reduction on stacked leaves
    [n, *shape] -> [*shape]. With per-layer granularity each bucket
    reduces as an independent chain. `collect`, when given, receives one
    [3] dot triple per tree level (summed over buckets and pairs).
    `cache`, when given, keeps the static plan and bucket maps by leaf
    shapes, dtypes and device, so a later call with the same leaves only
    packs and launches (the reference builds them once, at trace
    time)."""
    if impl not in COMBINE_IMPLS:
        raise ValueError(f"impl={impl!r}; one of {COMBINE_IMPLS}")
    leaves, treedef = T.flatten(stacked)
    if not leaves:
        return stacked
    n = leaves[0].shape[0]
    if n == 1:
        return T.map(lambda x: x[0], stacked)
    if n & (n - 1):
        raise ValueError(f"fused combine needs a power-of-two lane count, "
                         f"got {n}")
    plan, metas = _cached_plan(leaves, cfg, cache)
    n_leaves = len(leaves)
    packed = _pack_buckets(leaves, plan, donate)
    del leaves
    if cfg.per_layer:
        acc = None
        if collect is not None:
            acc = [torch.zeros((3,), dtype=cfg.acc, device=packed[0].device)
                   for _ in range(n.bit_length() - 1)]
        out = []
        for meta in metas:       # pop: each bucket's level-0 buffer dies
            out.append(_bucket_chain(packed.pop(0), meta, cfg, impl,
                                     collect=acc))
        if collect is not None:
            collect.extend(acc)
    else:
        out = _whole_model_levels(packed, metas, cfg, impl, collect=collect)
    return _unpack_buffers(out, plan, n_leaves, treedef)


def build_fused_combiner(cfg: CombineConfig, *, with_stats: bool = False,
                         impl: str = "kernel", donate: bool = False
                         ) -> Callable[[PyTree], PyTree]:
    """The fused bucketed combine for the gspmd_tree backend (the
    `mesh=None` branch of the reference's `_build_fused`). On one device
    the lane axis is never device-sharded, so it always applies.

    with_stats=True: the combiner returns (combined, CombineStats) read
    from the dot triples the combine already computes. The static plan
    is built on the first call and kept for later calls on leaves of the
    same shapes."""
    cache: dict = {}

    def run(stacked: PyTree):
        kw = dict(impl=impl, donate=donate, cache=cache)
        if with_stats:
            collect: list = []
            out = fused_combine_tree(stacked, cfg, collect, **kw)
            return out, stack_stats(collect)
        return fused_combine_tree(stacked, cfg, **kw)
    return run


def _mean_rows(x: torch.Tensor, acc_dtype) -> torch.Tensor:
    """Mean over the leading axis of x [n, ...], summed in acc_dtype lane
    after lane (one lane's worth of acc_dtype memory): the same function
    on a leaf or on a packed bucket buffer, element by element."""
    s = x[0].to(acc_dtype, copy=True)
    for i in range(1, x.shape[0]):
        s += x[i]
    return s.div_(x.shape[0]).to(x.dtype)


def lane_mean(stacked: PyTree, acc_dtype=torch.float32) -> PyTree:
    """Mean over the leading lane axis, accumulated in acc_dtype — the
    delayed mode's immediate local estimate, the same bits as the mean
    the correction subtracts (combine.py:517-524)."""
    return T.map(lambda x: _mean_rows(x, acc_dtype), stacked)


def rank_sum(tree: PyTree, comm, *, dtype=None, donate: bool = False,
             dims: Optional[List[Optional[int]]] = None) -> PyTree:
    """Each leaf of this rank's `tree` summed over the ranks of `comm`
    (`Comm.allreduce`: every rank holds the bits of the one reduction),
    in `dtype` (default: the leaf's). donate=True reduces the leaves in
    place where no cast is asked for. `dims` (one entry per leaf in
    flatten order): a leaf with a dim d comes back as this rank's piece
    of the sum, its chunk `comm.rank` of `comm.world` along d, by one
    `Comm.reduce_scatter` (no whole sum is made)."""
    leaves, td = T.flatten(tree)

    def one(x, d):
        dt = dtype or x.dtype
        t = x if donate and dt == x.dtype else x.to(dt, copy=True)
        if d is None:
            return comm.allreduce(t)
        n = t.shape[d] // comm.world
        got = comm.reduce_scatter([t.narrow(d, q * n, n)
                                   for q in range(comm.world)])
        return got.clone() if got._base is not None else got
    return T.unflatten(td, [one(x, d) for x, d in zip(
        leaves, dims or [None] * len(leaves))])


def rank_mean(tree: PyTree, comm, acc_dtype=torch.float32) -> PyTree:
    """`lane_mean` across ranks, one lane per rank: the sum over `comm`
    in acc_dtype, over the rank count, in each leaf's dtype. The same
    bits on every rank."""
    sums = rank_sum(tree, comm, dtype=acc_dtype)
    return T.map(lambda t, x: t.div_(comm.world).to(x.dtype), sums, tree)


# ------------------------------------------------------- delayed correction
def fused_correction_tree(stacked: PyTree, cfg: CombineConfig, *,
                          impl: str = "kernel", donate: bool = False,
                          cache: Optional[dict] = None) -> PyTree:
    """The delayed combine's correction on the pending carry [n, ...]
    (combine.py:398-432):

        correction = Adasum(deltas) - lane_mean(deltas)

    from one packing: each bucket's lane mean is taken from its packed
    buffer just before the bucket's tree chain consumes it, so each
    pending buffer is read by both. n == 1 gives zeros (a lane combines
    to itself). `donate` releases the pending leaves as they are packed."""
    leaves, treedef = T.flatten(stacked)
    if not leaves:
        return stacked
    n = leaves[0].shape[0]
    if n == 1:
        return T.map(lambda x: torch.zeros(x.shape[1:], dtype=x.dtype,
                                           device=x.device), stacked)
    if n & (n - 1):
        raise ValueError(f"fused correction needs a power-of-two lane "
                         f"count, got {n}")
    plan, metas = _cached_plan(leaves, cfg, cache)
    n_leaves = len(leaves)
    packed = _pack_buckets(leaves, plan, donate)
    del leaves
    if cfg.per_layer:
        out = []
        for meta in metas:      # pop: each bucket's level-0 buffer dies
            mean = _mean_rows(packed[0], cfg.acc)
            out.append(_bucket_chain(packed.pop(0), meta, cfg, impl)
                       .sub_(mean))
            del mean
    else:
        means = [_mean_rows(buf, cfg.acc) for buf in packed]
        out = [c.sub_(m) for c, m in zip(
            _whole_model_levels(packed, metas, cfg, impl), means)]
    return _unpack_buffers(out, plan, n_leaves, treedef)


def build_delayed_correction(cfg: CombineConfig, *, impl: str = "kernel",
                             comm=None) -> Callable:
    """The delayed-combine exchange (combine.py:535-559):
    correction(pending, donate=False) = combine(pending) -
    lane_mean(pending), the same bits on every call.

    On stacked lanes an adasum gspmd / fused config takes
    `fused_correction_tree` (one packing, the block kernels); any other
    config wraps the combiner the registry resolves. With `comm` (one
    lane per rank) the combiner reduces across its ranks and the mean is
    `rank_mean` over them: the reference's span == dp fallback, which
    in the port is RVH minus the cross-rank mean. donate=True lets the
    call consume `pending` (the caller reads it no more)."""
    from repro_torch.engine.registry import make_combiner
    ranked = comm is not None and comm.world > 1
    if (not ranked and cfg.op == "adasum" and cfg.fused
            and cfg.backend in ("", "gspmd_tree", "fused")):
        cache: dict = {}

        def fused(pending: PyTree, donate: bool = False) -> PyTree:
            return fused_correction_tree(pending, cfg, impl=impl,
                                         donate=donate, cache=cache)
        return fused
    combiners = {d: make_combiner(cfg, impl=impl, donate=d, comm=comm)
                 for d in (False, True)}

    def correction(pending: PyTree, donate: bool = False) -> PyTree:
        local = (rank_mean(pending, comm, cfg.acc) if ranked
                 else lane_mean(pending, cfg.acc))
        combined = combiners[donate](pending)
        return T.map(lambda c, m: c.sub_(m), combined, local)

    correction.combine_path = getattr(combiners[False], "combine_path", "")
    return correction
