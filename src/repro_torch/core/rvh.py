"""ADASUMRVH — the paper's Algorithm 1 (recursive vector halving with
Adasum) across ranks, one process and one lane per rank: the port of
`repro/core/rvh.py`.

Mapping from the reference (shard_map over the DP mesh axes):
  * SEND/RECV of the buffer halves with the partner at distance d
        `lax.ppermute` -> `Comm.exchange` (isend + irecv);
  * ALLREDUCE of the partial dots over the 2d-rank group (line 17)
        `lax.psum(axis_index_groups)` -> `Comm.group_sum` (rank order);
  * per-layer dots on the fused buffer (§3.6 + §4.4.3)
        `block_dots` + an order-fixed block -> segment sum, then
        `block_combine` (the CUDA kernels on a card, their plain versions
        on the CPU or with impl="plain").

Multi-axis meshes flatten: with the reference's pod-major lane index
(rvh.py:266) the rounds over [('data', D), ('pod', P)] are flat RVH over
D·P ranks — partner rank ^ d, left when (rank // d) % 2 == 0, dots summed
over the contiguous block of 2d ranks — so one flat schedule serves both.

Layout: every leaf starts on a BLOCK_ELEMS (8192) boundary and the buffer
is padded to world x 8192, so every half at every round is whole kernel
blocks (the reference aligns so only under `use_pallas`; the alignment
moves padding and summation order, not the function). Segment ids are
kept per block, not per element: each round's block -> segment map is a
contiguous slice of the bucket's, and its `SegmentSum` is built once per
bucket layout.

int8 wire compression (`compress="int8"`, rvh.py:84-105): per-128-element
absmax scales, round half to even. In the reduce phase only the received
half is dequantized, as in the reference. In the allgather phase the
reference keeps a rank's own chunk exact while the other ranks hold it
dequantized, so its replicas differ; here the owner quantizes its chunk
once, every rank forwards those int8 payloads, and every rank (the owner
too) dequantizes every chunk the same way: the result is replicated
bitwise. That is the value every rank but the owner holds in the
reference.

ZeRO-1 (`allgather_result=False`): the allgather phase is skipped and
each rank keeps the chunk it owns (rvh.py:183-184), bitwise that chunk
of the full result. For that chunk to be the rank's own piece of every
leaf, `adasum_rvh_pytree` takes lane-group shards (`shard_dims`) in
buckets laid out chunk-major (`ShardLayout`): chunk c holds, leaf after
leaf, the 1/world sub-piece of each shard that the rank owning chunk c
keeps. Adasum per layer does not depend on where a layer's elements sit
in the buffer, only on the dots, so the layout moves summation order,
not the function. When the shards are 1/g of a leaf (the hierarchical
regime, g ranks a lane group), each round's per-layer dot triples are
also summed over the lane group (`shard_comm`), in rank order: without
that sum the Adasum scalars would be those of a fragment of the layer.

Tensor-parallel shards (rvh.py:120-199, 250-320): with `leaf_specs`
naming the model axis, each rank's leaves are its model shards and RVH
runs across its data group. Each round's per-segment dots are scaled by
`seg_scale` — 1/M for a leaf the model axis does not shard (its M
replicas would each add the whole layer), 1 for a sharded one — then
summed over the data group as always and, last, over the model group
(`model_comm`, in rank order), so every rank of a model group takes the
whole layer's scalars. Whole-model Adasum (per_layer=False) needs one
factor for every leaf, as the reference asserts.

Whole-model Adasum on lane-group shards: the shards and the whole leaves
sit in buckets of their own, so the two run their rounds in lockstep
(`adasum_rvh_lockstep`): each round's triples are added over both
before the sums over the lane group, the round's pair group and the
model group, and both combine with the one pair of scalars. Every rank
of a lane group holds the whole leaves alike, so their triples count
1/g before the lane group's sum.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.kernels import adasum as K
from repro_torch.parallel.sharding import spec_axes, spec_leaves
from . import fusion
from .adasum import adasum_segment_scalars
from .combine import COMBINE_IMPLS, CombineConfig, _block_segments, \
    _release, block_partials, stack_stats

PyTree = Any
QBLOCK = 128                # int8 scale granule (rvh.py:81)
QCHUNK = 1 << 24            # elements a (de)quantize pass handles at once


# ------------------------------------------------------------ dots, combine
@dataclasses.dataclass(frozen=True)
class RoundMeta:
    """One round of one bucket on this rank: the kept half's block ->
    segment map and its order-fixed segment sum."""
    block: int
    block_seg: torch.Tensor       # int64 [blocks of the half]
    seg_sum: K.SegmentSum


def segment_dots(a: torch.Tensor, b: torch.Tensor, meta: RoundMeta,
                 acc_dtype=torch.float32, impl: str = "kernel"
                 ) -> torch.Tensor:
    """Per-segment [a·b, a·a, b·b] -> [num_segments + 1, 3] in acc_dtype:
    block partials (the kernel's fp32 ones cast, or the plain arm's in
    acc_dtype throughout: `block_partials`) summed per segment in a
    fixed order (rvh.py:41-56)."""
    return meta.seg_sum(block_partials(a, b, meta.block, acc_dtype, impl))


def combine_halves(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor,
                   meta: RoundMeta, fp32_math: bool = False,
                   impl: str = "kernel") -> torch.Tensor:
    """x' = s1·a + s2·b with per-segment scalars from the dot triples
    (Algorithm 1 line 18, per layer per §3.6; rvh.py:59-67). The plain
    arm computes in fp32 when `fp32_math` (the reference's Pallas rule)
    and in the buffer dtype otherwise."""
    s1, s2 = adasum_segment_scalars(v)
    return K.block_combine(a, b, s1[meta.block_seg], s2[meta.block_seg],
                           block_elems=meta.block, fp32_math=fp32_math,
                           plain=impl == "plain")


# --------------------------------------------------- wire compression (int8)
def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n] (n % 128 == 0) -> int8 [n] and fp32 scales [n // 128]: scale =
    absmax / 127 + 1e-30, q = clip(round(x / scale), -127, 127), rounding
    half to even (rvh.py:84-90). Worked in pieces of QCHUNK elements."""
    n = x.shape[0]
    if n % QBLOCK:
        raise ValueError(f"quantize: n={n} is not a multiple of {QBLOCK}")
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    scale = torch.empty(n // QBLOCK, dtype=torch.float32, device=x.device)
    for s in range(0, n, QCHUNK):
        xb = x[s:s + QCHUNK].reshape(-1, QBLOCK).float()
        sc = xb.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-30
        t = torch.round(xb / sc).clamp_(-127, 127)
        q[s:s + QCHUNK] = t.reshape(-1).to(torch.int8)
        scale[s // QBLOCK:(s + xb.numel()) // QBLOCK] = sc[:, 0]
        del xb, t
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """q * scale per 128-element block, cast to dtype (rvh.py:93-96)."""
    n = q.shape[0]
    out = torch.empty(n, dtype=dtype, device=q.device)
    for s in range(0, n, QCHUNK):
        qb = q[s:s + QCHUNK].reshape(-1, QBLOCK).float()
        sc = scale[s // QBLOCK:(s + qb.numel()) // QBLOCK]
        out[s:s + qb.numel()] = (qb * sc[:, None]).reshape(-1).to(dtype)
    return out


def _exchange(comm, send: torch.Tensor, partner: int,
              compress: str) -> torch.Tensor:
    """The partner's half (rvh.py:99-105): int8 payloads and scales when
    compressed, dequantized on arrival."""
    if compress == "int8":
        q, s = quantize(send)
        rq, rs = comm.exchange([q, s], partner)
        del q, s
        return dequantize(rq, rs, send.dtype)
    return comm.exchange([send], partner)[0]


# ----------------------------------------------------------------- rounds
def round_distances(world: int) -> List[int]:
    """The partner distance of each reduce round: 1, 2, 4, ... < world
    (`_round_schedule` of rvh.py:108-116 on the flattened lane index)."""
    if world < 1 or world & (world - 1):
        raise ValueError(f"RVH needs a power-of-two rank count, got {world}")
    return [1 << j for j in range(world.bit_length() - 1)]


def _round_metas(block_seg: np.ndarray, num_segments: int, block: int,
                 rank: int, world: int, device) -> List[RoundMeta]:
    """This rank's kept half at every round, as block ranges of the
    bucket (the reference halves `seg` with the buffer, rvh.py:157-161)."""
    metas, lo, hi = [], 0, len(block_seg)
    for d in round_distances(world):
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if (rank // d) % 2 == 0 else (mid, hi)
        seg = block_seg[lo:hi]
        metas.append(RoundMeta(block, torch.as_tensor(seg, device=device),
                               K.SegmentSum(seg, num_segments, device)))
    return metas


def owned_chunk(rank: int, world: int) -> int:
    """The 1/world chunk of a bucket that `rank` holds after the reduce
    phase (the halves it keeps, round after round)."""
    lo, n = 0, world
    for d in round_distances(world):
        n //= 2
        if (rank // d) % 2:
            lo += n
    return lo


def adasum_rvh_local(buf: torch.Tensor, metas: Sequence[RoundMeta], comm, *,
                     acc_dtype=torch.float32, fp32_math: bool = False,
                     compress: str = "none", impl: str = "kernel",
                     allgather_result: bool = True,
                     probe: Optional[list] = None,
                     shard_comm=None,
                     seg_scale: Optional[torch.Tensor] = None,
                     model_comm=None) -> torch.Tensor:
    """Algorithm 1 on this rank's fused bucket `buf` [padded_len]
    (padding zeroed, padded_len a multiple of world x block), with
    `metas` from `_round_metas` for this rank. Returns the combined
    bucket, the same on every rank; with allgather_result=False only
    the chunk this rank owns (`owned_chunk`), bitwise that chunk of the
    full result. `shard_comm`, when given, holds the other shards of the
    bucket's layers: each round's dot triples are summed over it first.
    `seg_scale` ([num_segments + 1]) scales each segment's triples
    before any sum, and `model_comm` sums them last, over the model
    group (tensor-parallel shards). `probe`, when given, receives round
    0's per-segment triples (scaled) before the pair sum.

    Memory: each round's input dies once its output is written, so a
    caller that hands `buf` over without keeping a reference (e.g.
    `adasum_rvh_local(bufs.pop(), ...)`) holds at most the bucket plus
    one half at a time."""
    bufs = [buf]
    del buf
    return adasum_rvh_lockstep(
        bufs, [metas], comm, acc_dtype=acc_dtype, fp32_math=fp32_math,
        compress=compress, impl=impl, gathers=[allgather_result],
        probe=probe, shard_comm=shard_comm, seg_scales=[seg_scale],
        model_comm=model_comm)[0]


def adasum_rvh_lockstep(bufs: List[torch.Tensor],
                        metas: Sequence[Sequence[RoundMeta]], comm, *,
                        acc_dtype=torch.float32, fp32_math: bool = False,
                        compress: str = "none", impl: str = "kernel",
                        gathers: Sequence[bool],
                        probe: Optional[list] = None, shard_comm=None,
                        seg_scales: Sequence[Optional[torch.Tensor]],
                        model_comm=None) -> List[torch.Tensor]:
    """`adasum_rvh_local` on several buckets whose rounds share one set
    of dot triples (whole-model Adasum over buckets of shards and of
    whole leaves): each round's triples, each bucket's scaled by its
    `seg_scales` entry, are added over the buckets before the sums over
    `shard_comm`, the round's pair group and `model_comm`, and every
    bucket combines with the same scalars. With one bucket this is
    `adasum_rvh_local`. `gathers[i]`: whether bucket i runs the
    allgather phase. Takes `bufs` over (its entries are replaced round
    after round)."""
    world, rank = comm.world, comm.rank
    if world == 1:
        return bufs
    for buf, m in zip(bufs, metas):
        if buf.shape[0] % (world * m[0].block):
            raise ValueError(f"bucket of {buf.shape[0]} elements is not a "
                             f"multiple of world x block = {world} x "
                             f"{m[0].block}")
    sizes = [buf.shape[0] for buf in bufs]
    offs, trace = [0] * len(bufs), []
    # ---- reduce-scatter + combine phase (lines 2-21) ----
    for r, d in enumerate(round_distances(world)):
        is_left = (rank // d) % 2 == 0
        halves, v = [], None
        for i in range(len(bufs)):
            buf, bufs[i] = bufs[i], None
            n = buf.shape[0]
            mid = n // 2
            keep, send = (buf[:mid], buf[mid:]) if is_left else \
                (buf[mid:], buf[:mid])
            del buf
            recv = _exchange(comm, send, rank ^ d,
                             compress if n % (2 * QBLOCK) == 0 else "none")
            del send
            halves.append((keep, recv) if is_left else (recv, keep))
            del keep, recv
            with comm.timed("kernels"):
                vi = segment_dots(*halves[i], metas[i][r], acc_dtype, impl)
            if seg_scales[i] is not None:
                vi = vi * seg_scales[i][:, None].to(vi)
            v = vi if v is None else v + vi
            if not is_left:
                offs[i] += mid
        if shard_comm is not None:
            v = shard_comm.group_sum(v, shard_comm.world)
        if probe is not None and r == 0:
            probe.append(v)
        v = comm.group_sum(v, 2 * d)             # finish the dots (line 17)
        if model_comm is not None:
            v = model_comm.group_sum(v, model_comm.world)
        for i in range(len(bufs)):
            with comm.timed("kernels"):
                bufs[i] = combine_halves(*halves[i], v, metas[i][r],
                                         fp32_math, impl)
            halves[i] = None
        trace.append((d, is_left))
    return [_allgather(buf, off, size, trace, comm, compress) if gather
            else buf for buf, off, size, gather in zip(bufs, offs, sizes,
                                                       gathers)]


def _allgather(buf: torch.Tensor, off: int, n: int, trace, comm,
               compress: str) -> torch.Tensor:
    """Lines 22-24: every rank's chunk into one [n] buffer, the rounds in
    reverse, each exchanging the span it holds for its partner's,
    received in place. Compressed, the int8 payloads travel and each
    rank dequantizes every chunk once at the end."""
    length = buf.shape[0]
    if length % QBLOCK:
        compress = "none"
    dtype, dev = buf.dtype, buf.device
    if compress == "int8":
        q, s = quantize(buf)
        full = torch.empty(n, dtype=torch.int8, device=dev)
        scales = torch.empty(n // QBLOCK, dtype=torch.float32, device=dev)
        full[off:off + length] = q
        scales[off // QBLOCK:(off + length) // QBLOCK] = s
        del q, s
        bufs = [(full, 1), (scales, QBLOCK)]
    else:
        full = torch.empty(n, dtype=dtype, device=dev)
        full[off:off + length] = buf
        bufs = [(full, 1)]
    del buf
    for d, is_left in reversed(trace):
        poff = off + length if is_left else off - length
        view = lambda o: [b[o // g:(o + length) // g] for b, g in bufs]
        comm.exchange(view(off), comm.rank ^ d, recvs=view(poff))
        off = min(off, poff)
        length *= 2
    if compress == "int8":
        return dequantize(full, scales, dtype)
    return full


# ------------------------------------------------------------------ pytree
@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """A bucket of shards laid out chunk-major: the buffer is `world`
    chunks of `chunk_len`, and chunk c holds, leaf after leaf (each on a
    block boundary), sub-piece `owners[c]` of every shard along its
    sharded dim — the piece the rank owning chunk c keeps."""
    shapes: Tuple[Tuple[int, ...], ...]   # the shards' shapes
    dims: Tuple[int, ...]                 # each shard's sharded dim
    offsets: Tuple[int, ...]              # within a chunk
    sizes: Tuple[int, ...]                # a sub-piece's elements
    chunk_len: int
    owners: Tuple[int, ...]               # chunk c -> the rank owning it
    dtypes: Tuple[torch.dtype, ...]       # each shard's dtype

    @property
    def dtype(self) -> torch.dtype:
        """The buffer's dtype."""
        return fusion._result_type(self.dtypes)

    @property
    def padded_len(self) -> int:
        return len(self.owners) * self.chunk_len

    def piece_shape(self, i: int) -> Tuple[int, ...]:
        shape = list(self.shapes[i])
        shape[self.dims[i]] //= len(self.owners)
        return tuple(shape)

    def block_segments(self, block: int) -> np.ndarray:
        seg = np.full((self.padded_len // block,), len(self.shapes),
                      dtype=np.int64)
        for c in range(len(self.owners)):
            for i, (off, sz) in enumerate(zip(self.offsets, self.sizes)):
                lo = c * self.chunk_len + off
                seg[lo // block:(lo + sz + block - 1) // block] = i
        return seg


def shard_layout(leaves: Sequence[Any], dims: Sequence[int], world: int,
                 block: int) -> ShardLayout:
    sizes = [int(np.prod(x.shape)) // world for x in leaves]
    offsets, off = [], 0
    for n in sizes:
        offsets.append(off)
        off += -(-n // block) * block
    owners = [0] * world
    for r in range(world):
        owners[owned_chunk(r, world)] = r
    return ShardLayout(tuple(tuple(x.shape) for x in leaves), tuple(dims),
                       tuple(offsets), tuple(sizes), max(off, block),
                       tuple(owners), tuple(x.dtype for x in leaves))


def _sub(x: torch.Tensor, dim: int, j: int, world: int) -> torch.Tensor:
    n = x.shape[dim] // world
    return x.narrow(dim, j * n, n)


def pack_shards(leaves: Sequence[torch.Tensor], lay: ShardLayout
                ) -> torch.Tensor:
    buf = torch.zeros(lay.padded_len, dtype=lay.dtype,
                      device=leaves[0].device)
    view = buf.view(len(lay.owners), lay.chunk_len)
    for c, j in enumerate(lay.owners):
        for i, x in enumerate(leaves):
            sub = _sub(x, lay.dims[i], j, len(lay.owners))
            view[c, lay.offsets[i]:lay.offsets[i] + lay.sizes[i]].view(
                sub.shape).copy_(sub)
    return buf


def unpack_pieces(chunk: torch.Tensor, lay: ShardLayout
                  ) -> List[torch.Tensor]:
    """The owned chunk -> this rank's piece of each shard (views)."""
    return [chunk[o:o + n].view(lay.piece_shape(i)).to(lay.dtypes[i])
            for i, (o, n) in enumerate(zip(lay.offsets, lay.sizes))]


def unpack_shards(buf: torch.Tensor, lay: ShardLayout) -> List[torch.Tensor]:
    """The whole combined bucket -> each shard, its sub-pieces in place."""
    view = buf.view(len(lay.owners), lay.chunk_len)
    out = []
    for i, shape in enumerate(lay.shapes):
        x = torch.empty(shape, dtype=lay.dtypes[i], device=buf.device)
        for c, j in enumerate(lay.owners):
            sub = _sub(x, lay.dims[i], j, len(lay.owners))
            sub.copy_(view[c, lay.offsets[i]:lay.offsets[i]
                           + lay.sizes[i]].view(sub.shape))
        out.append(x)
    return out


@dataclasses.dataclass(frozen=True)
class _Bucket:
    """One bucket's static pieces on this rank: its leaves (indices in
    flatten order), its layout — a `fusion.FusionLayout` of whole
    leaves, or a `ShardLayout` of shards — and its rounds."""
    idxs: Tuple[int, ...]
    layout: Any
    metas: Tuple[RoundMeta, ...]
    scale: Optional[torch.Tensor] = None     # seg_scale (TP shards)

    @property
    def sharded(self) -> bool:
        return isinstance(self.layout, ShardLayout)


def rvh_plan(leaves: Sequence[Any], world: int, rank: int, *,
             per_layer: bool = True, bucket_bytes: Optional[int] = None,
             block: int = K.BLOCK_ELEMS, device=None,
             shard_dims: Optional[Sequence[Optional[int]]] = None,
             factors: Optional[Sequence[float]] = None,
             lane_group: int = 1) -> List[_Bucket]:
    """The buckets of `adasum_rvh_pytree` (rvh.py:276-315): per-bucket
    chains at `bucket_bytes` when per_layer and there is more than one
    leaf, else one bucket; per_layer=False collapses every leaf into one
    segment (the padding tail is segment 1). With `shard_dims`, the
    leaves with a dim (shards) and those without (whole leaves) are
    bucketed apart, the shards chunk-major (`ShardLayout`). `factors`
    (one per leaf, tensor-parallel shards): each bucket's seg_scale.
    Whole-model Adasum over shards of lane groups of `lane_group` ranks
    runs its two buckets in lockstep (`adasum_rvh_lockstep`), the
    triples summed over the lane group: the whole leaves, which every
    rank of a lane group holds, count 1/lane_group there."""
    dims = list(shard_dims) if shard_dims is not None else \
        [None] * len(leaves)
    if not per_layer:
        check_whole_model(factors)
    spread = not per_layer and lane_group > 1 and \
        any(d is not None for d in dims)
    plan = []
    for sharded in (False, True):
        idxs = [i for i, d in enumerate(dims) if (d is not None) == sharded]
        if not idxs:
            continue
        sub = [leaves[i] for i in idxs]
        if per_layer and bucket_bytes and len(sub) > 1:
            nbytes = [(int(np.prod(x.shape)) if len(x.shape) else 1)
                      * x.dtype.itemsize for x in sub]
            ranges = fusion.bucketize_sizes(nbytes, bucket_bytes)
        else:
            ranges = [(0, len(sub))]
        for lo, hi in ranges:
            part = idxs[lo:hi]
            if sharded:
                layout = shard_layout([leaves[i] for i in part],
                                      [dims[i] for i in part], world, block)
                seg, nseg = layout.block_segments(block), len(part)
                if not per_layer:          # every leaf one segment
                    seg, nseg = (seg == nseg).astype(np.int64), 1
            else:
                specs = tuple(fusion.Spec(tuple(leaves[i].shape),
                                          leaves[i].dtype) for i in part)
                layout = fusion.make_layout(specs, align=world,
                                            leaf_align=block)
                if per_layer:
                    seg = _block_segments(layout, block)
                    nseg = layout.num_segments
                else:
                    seg = np.zeros((layout.padded_len // block,), np.int64)
                    end = max(o + s for o, s in zip(layout.offsets,
                                                    layout.sizes))
                    seg[-(-end // block):] = 1
                    nseg = 1
            f = [1.0] * (len(part) if per_layer else 1)
            if factors is not None:
                f = [factors[i] for i in part] if per_layer \
                    else [factors[part[0]]]
            if spread and not sharded:
                f = [x / lane_group for x in f]
            scale = None
            if factors is not None or (spread and not sharded):
                scale = torch.tensor(f + [1.0], dtype=torch.float64,
                                     device=device)
            plan.append(_Bucket(tuple(part), layout, tuple(_round_metas(
                seg, nseg + 1, block, rank, world, device)), scale))
    return plan


def check_whole_model(factors: Optional[Sequence[float]]) -> None:
    """Whole-model Adasum collapses every leaf into one segment, which
    takes one replication factor: the reference asserts that
    (rvh.py:296-299), and so does this."""
    if factors is not None and len(set(factors)) > 1:
        raise ValueError("per_layer=False requires uniform TP sharding "
                         "across leaves (one dot correction for the "
                         "collapsed segment, rvh.py:296-302)")


def replication_factors(leaf_specs: Sequence[Any], model_size: int
                        ) -> List[float]:
    """Per leaf, 1/(the model-axis size it is not sharded over)
    (`_leaf_replication_factors`, rvh.py:199-216)."""
    return [1.0 if "model" in spec_axes(s) else 1.0 / model_size
            for s in leaf_specs]


def shard_factors(n: int, *, shard_dims=None, shard_comm=None,
                  leaf_specs=None, model_comm=None
                  ) -> Optional[List[float]]:
    """Per leaf of a lane tree of shards, what this rank's partial sum of
    a whole-leaf quantity (a dot, a squared norm) counts before the sums
    over the lane group (`shard_comm`) and the model group
    (`model_comm`): 1/g for a leaf the data axis leaves whole (each of
    the g ranks of a lane group holds all of it), times
    `replication_factors` over the model axis. None where neither group
    is given."""
    if shard_comm is None and model_comm is None:
        return None
    f = [1.0] * n
    if shard_comm is not None:
        f = [x if d is not None else x / shard_comm.world
             for x, d in zip(f, shard_dims)]
    if model_comm is not None:
        f = [x * y for x, y in zip(f, replication_factors(
            spec_leaves(leaf_specs), model_comm.world))]
    return f


def adasum_rvh_pytree(tree: PyTree, comm, *, per_layer: bool = True,
                      acc_dtype=torch.float32, use_pallas: bool = False,
                      compress: str = "none",
                      bucket_bytes: Optional[int] = None,
                      impl: str = "kernel", donate: bool = False,
                      collect: Optional[list] = None,
                      cache: Optional[dict] = None,
                      leaf_specs: Optional[PyTree] = None,
                      shard_dims: Optional[Sequence[Optional[int]]] = None,
                      shard_comm=None,
                      allgather_result: bool = True,
                      model_comm=None) -> PyTree:
    """ADASUMRVH of this rank's lane `tree` (leaves [*shape], no lane
    axis) with every other rank's: the combined tree, the same bits on
    every rank (rvh.py:219-326).

    `shard_dims` (one entry per leaf in flatten order) marks the leaves
    given as shards: their dim `d` splits into `comm.world` sub-pieces,
    sub-piece j being rank j's to keep, and `shard_comm` (if any) holds
    the other shards of the same leaves, over which the dots are summed.
    With allgather_result=False a shard comes back as this rank's
    sub-piece of the combined shard (ZeRO-1; whole leaves still come
    back whole), else as the combined shard.

    `use_pallas` selects the combine's fp32 rule on the plain arm, as in
    the reference. `collect`, when given, receives one [3] triple:
    round 0's [Σ a·b, Σ a·a, Σ b·b] over every lane pair (2i, 2i+1) and
    every leaf — the reference's level-0 `probe_stats`, read from the
    dots the combine computes, plus one [3]-sized reduction. `donate`
    frees each input leaf once it is packed. `cache` keeps the plan by
    leaf shapes and dtypes.

    `leaf_specs` (a spec tree like `tree`'s, or a list of specs in
    flatten order): how the model axis shards each leaf, the leaves
    being this rank's model shards; `model_comm` is the model group.
    The dots of each segment are then corrected for replication and
    summed over it (rvh.py:250-320); specs that name no model axis
    change nothing."""
    if impl not in COMBINE_IMPLS:
        raise ValueError(f"impl={impl!r}; one of {COMBINE_IMPLS}")
    if compress not in ("none", "int8"):
        raise ValueError(f"compress={compress!r}; none | int8")
    leaves, treedef = T.flatten(tree)
    if not leaves:
        return tree
    factors = None
    if leaf_specs is not None:
        specs = spec_leaves(leaf_specs)
        if any("model" in spec_axes(s) for s in specs):
            if model_comm is None:
                raise ValueError("leaf specs over the model axis need "
                                 "model_comm (the model group)")
            factors = replication_factors(specs, model_comm.world)
    if factors is None:
        model_comm = None
    key = (tuple((tuple(x.shape), x.dtype) for x in leaves),
           None if shard_dims is None else tuple(shard_dims),
           None if factors is None else tuple(factors))
    plan = cache.get(key) if cache is not None else None
    if plan is None:
        plan = rvh_plan(leaves, comm.world, comm.rank, per_layer=per_layer,
                        bucket_bytes=bucket_bytes, device=leaves[0].device,
                        shard_dims=shard_dims, factors=factors,
                        lane_group=shard_comm.world if shard_comm else 1)
        if cache is not None:
            cache[key] = plan
    out: List[Any] = [None] * len(leaves)
    probe: Optional[list] = [] if collect is not None else None
    # per layer each bucket is a chain of its own; whole-model Adasum
    # runs its buckets (shards, whole leaves) in lockstep
    for group in ([[b] for b in plan] if per_layer else [plan]):
        packed = []
        for bucket in group:
            sub = [leaves[i] for i in bucket.idxs]
            packed.append(pack_shards(sub, bucket.layout) if bucket.sharded
                          else fusion.pack(sub, bucket.layout))
            if donate:
                for x in sub:
                    _release(x)
            del sub
        gathers = [allgather_result or not b.sharded for b in group]
        bufs = adasum_rvh_lockstep(   # handed over: each round frees its input
            packed, [b.metas for b in group], comm, acc_dtype=acc_dtype,
            fp32_math=use_pallas, compress=compress, impl=impl,
            gathers=gathers, probe=probe,
            shard_comm=shard_comm if any(b.sharded for b in group) else None,
            seg_scales=[b.scale for b in group], model_comm=model_comm)
        del packed
        for bucket, gather in zip(group, gathers):
            buf, lay = bufs.pop(0), bucket.layout
            if not bucket.sharded:
                got = T.leaves(fusion.unpack(buf, lay))
            elif gather:
                got = unpack_shards(buf, lay)
            else:
                got = unpack_pieces(buf, lay)
            del buf
            for i, x in zip(bucket.idxs, got):
                out[i] = x
    del leaves
    if collect is not None and comm.world > 1:
        local = sum(v.sum(dim=0) for v in probe)
        got = comm.group_sum(local, comm.world)
        if model_comm is not None:
            got = model_comm.group_sum(got, model_comm.world)
        collect.append(got)
    return T.unflatten(treedef, out)


def build_rvh_combiner(cfg: CombineConfig, comm, *, with_stats: bool = False,
                       impl: str = "kernel", donate: bool = False,
                       shard_dims: Optional[Sequence[Optional[int]]] = None,
                       shard_comm=None, allgather_result: bool = True,
                       leaf_specs=None, model_comm=None):
    """The `adasum-rvh` combiner over `comm`: this rank's lane tree ->
    the combined tree (and, with_stats, its CombineStats: {'levels':
    [1, 3]} from round 0, [0, 3] at world 1). `shard_dims`, `shard_comm`,
    `allgather_result`, `leaf_specs` and `model_comm` as in
    `adasum_rvh_pytree`."""
    cache: dict = {}

    def run(tree: PyTree):
        collect: Optional[list] = [] if with_stats else None
        out = adasum_rvh_pytree(
            tree, comm, per_layer=cfg.per_layer, acc_dtype=cfg.acc,
            use_pallas=cfg.use_pallas, compress=cfg.compress,
            bucket_bytes=cfg.fusion_bytes, impl=impl, donate=donate,
            collect=collect, cache=cache, shard_dims=shard_dims,
            shard_comm=shard_comm, allgather_result=allgather_result,
            leaf_specs=leaf_specs, model_comm=model_comm)
        return (out, stack_stats(collect)) if with_stats else out

    run.combine_path = "rvh"
    return run
