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

ZeRO-1 (`allgather_result=False`) and tensor-parallel leaf specs are
ROADMAP.md queue 1 item 7.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.kernels import adasum as K
from repro_torch.runtime import ITEM_SHARDING, not_ported
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


def adasum_rvh_local(buf: torch.Tensor, metas: Sequence[RoundMeta], comm, *,
                     acc_dtype=torch.float32, fp32_math: bool = False,
                     compress: str = "none", impl: str = "kernel",
                     allgather_result: bool = True,
                     probe: Optional[list] = None,
                     seg_scale: Optional[torch.Tensor] = None,
                     model_axes: Sequence[str] = ()) -> torch.Tensor:
    """Algorithm 1 on this rank's fused bucket `buf` [padded_len]
    (padding zeroed, padded_len a multiple of world x block), with
    `metas` from `_round_metas` for this rank. Returns the combined
    bucket, the same on every rank. `probe`, when given, receives round
    0's local per-segment triples (before the pair sum).

    Memory: each round's input dies once its output is written, so a
    caller that hands `buf` over without keeping a reference (e.g.
    `adasum_rvh_local(bufs.pop(), ...)`) holds at most the bucket plus
    one half at a time. The reference's tensor-parallel `seg_scale` /
    `model_axes` and ZeRO-1 (`allgather_result=False`) raise, naming
    ROADMAP.md queue 1 item 7."""
    if not allgather_result:
        raise not_ported("RVH without its allgather phase (ZeRO-1, "
                         "allgather_result=False)", ITEM_SHARDING)
    if seg_scale is not None or model_axes:
        raise not_ported("tensor-parallel dots in RVH (seg_scale, "
                         "model_axes)", ITEM_SHARDING)
    world, rank = comm.world, comm.rank
    if world == 1:
        return buf
    n = buf.shape[0]
    if n % (world * metas[0].block):
        raise ValueError(f"bucket of {n} elements is not a multiple of "
                         f"world x block = {world} x {metas[0].block}")
    off, length, trace = 0, n, []
    # ---- reduce-scatter + combine phase (lines 2-21) ----
    for r, (d, meta) in enumerate(zip(round_distances(world), metas)):
        mid = buf.shape[0] // 2
        is_left = (rank // d) % 2 == 0
        lo, hi = buf[:mid], buf[mid:]
        keep, send = (lo, hi) if is_left else (hi, lo)
        recv = _exchange(comm, send, rank ^ d,
                         compress if buf.shape[0] % (2 * QBLOCK) == 0
                         else "none")
        a, b = (keep, recv) if is_left else (recv, keep)
        with comm.timed("kernels"):
            v = segment_dots(a, b, meta, acc_dtype, impl)
        if probe is not None and r == 0:
            probe.append(v)
        v = comm.group_sum(v, 2 * d)             # finish the dots (line 17)
        with comm.timed("kernels"):
            new = combine_halves(a, b, v, meta, fp32_math, impl)
        del a, b, keep, send, recv, lo, hi
        buf = new
        off, length = (off, mid) if is_left else (off + mid, mid)
        trace.append((d, is_left))
    # ---- allgather phase (lines 22-24): every rank's chunk into one [n]
    # buffer, the rounds in reverse, each exchanging the span it holds for
    # its partner's, received in place. Compressed, the int8 payloads
    # travel and each rank dequantizes every chunk once at the end ----
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
class _Bucket:
    """One bucket's static pieces on this rank."""
    lo: int                       # leaf range [lo, hi) in flatten order
    hi: int
    layout: fusion.FusionLayout
    metas: Tuple[RoundMeta, ...]


def rvh_plan(leaves: Sequence[Any], world: int, rank: int, *,
             per_layer: bool = True, bucket_bytes: Optional[int] = None,
             block: int = K.BLOCK_ELEMS, device=None) -> List[_Bucket]:
    """The buckets of `adasum_rvh_pytree` (rvh.py:276-315): per-bucket
    chains at `bucket_bytes` when per_layer and there is more than one
    leaf, else one bucket; per_layer=False collapses every leaf into one
    segment (the padding tail is segment 1)."""
    if per_layer and bucket_bytes and len(leaves) > 1:
        nbytes = [(int(np.prod(x.shape)) if len(x.shape) else 1)
                  * x.dtype.itemsize for x in leaves]
        ranges = fusion.bucketize_sizes(nbytes, bucket_bytes)
    else:
        ranges = [(0, len(leaves))]
    plan = []
    for lo, hi in ranges:
        specs = tuple(fusion.Spec(tuple(x.shape), x.dtype)
                      for x in leaves[lo:hi])
        layout = fusion.make_layout(specs, align=world, leaf_align=block)
        if per_layer:
            seg = _block_segments(layout, block)
            nseg = layout.num_segments
        else:
            seg = np.zeros((layout.padded_len // block,), np.int64)
            end = max(o + s for o, s in zip(layout.offsets, layout.sizes))
            seg[-(-end // block):] = 1
            nseg = 1
        plan.append(_Bucket(lo, hi, layout, tuple(_round_metas(
            seg, nseg + 1, block, rank, world, device))))
    return plan


def adasum_rvh_pytree(tree: PyTree, comm, *, per_layer: bool = True,
                      acc_dtype=torch.float32, use_pallas: bool = False,
                      compress: str = "none",
                      bucket_bytes: Optional[int] = None,
                      impl: str = "kernel", donate: bool = False,
                      collect: Optional[list] = None,
                      cache: Optional[dict] = None,
                      leaf_specs: Optional[PyTree] = None,
                      allgather_result: bool = True) -> PyTree:
    """ADASUMRVH of this rank's lane `tree` (leaves [*shape], no lane
    axis) with every other rank's: the combined tree, the same bits on
    every rank (rvh.py:219-326).

    `use_pallas` selects the combine's fp32 rule on the plain arm, as in
    the reference. `collect`, when given, receives one [3] triple:
    round 0's [Σ a·b, Σ a·a, Σ b·b] over every lane pair (2i, 2i+1) and
    every leaf — the reference's level-0 `probe_stats`, read from the
    dots the combine computes, plus one [3]-sized reduction. `donate`
    frees each input leaf once it is packed. `cache` keeps the plan by
    leaf shapes and dtypes."""
    if impl not in COMBINE_IMPLS:
        raise ValueError(f"impl={impl!r}; one of {COMBINE_IMPLS}")
    if leaf_specs is not None:
        raise not_ported("tensor-parallel leaf specs in RVH", ITEM_SHARDING)
    if compress not in ("none", "int8"):
        raise ValueError(f"compress={compress!r}; none | int8")
    leaves, treedef = T.flatten(tree)
    if not leaves:
        return tree
    key = tuple((tuple(x.shape), x.dtype) for x in leaves)
    plan = cache.get(key) if cache is not None else None
    if plan is None:
        plan = rvh_plan(leaves, comm.world, comm.rank, per_layer=per_layer,
                        bucket_bytes=bucket_bytes, device=leaves[0].device)
        if cache is not None:
            cache[key] = plan
    out: List[Any] = [None] * len(leaves)
    probe: Optional[list] = [] if collect is not None else None
    for bucket in plan:
        sub = leaves[bucket.lo:bucket.hi]
        packed = [fusion.pack(sub, bucket.layout)]
        if donate:
            for x in sub:
                _release(x)
        del sub
        buf = adasum_rvh_local(      # handed over: each round frees its input
            packed.pop(), bucket.metas, comm, acc_dtype=acc_dtype,
            fp32_math=use_pallas, compress=compress, impl=impl,
            allgather_result=allgather_result, probe=probe)
        out[bucket.lo:bucket.hi] = T.leaves(fusion.unpack(buf,
                                                          bucket.layout))
    del leaves
    if collect is not None and comm.world > 1:
        local = sum(v.sum(dim=0) for v in probe)
        collect.append(comm.group_sum(local, comm.world))
    return T.unflatten(treedef, out)


def build_rvh_combiner(cfg: CombineConfig, comm, *, with_stats: bool = False,
                       impl: str = "kernel", donate: bool = False):
    """The `adasum-rvh` combiner over `comm`: this rank's lane tree ->
    the combined tree (and, with_stats, its CombineStats: {'levels':
    [1, 3]} from round 0, [0, 3] at world 1)."""
    cache: dict = {}

    def run(tree: PyTree):
        collect: Optional[list] = [] if with_stats else None
        out = adasum_rvh_pytree(
            tree, comm, per_layer=cfg.per_layer, acc_dtype=cfg.acc,
            use_pallas=cfg.use_pallas, compress=cfg.compress,
            bucket_bytes=cfg.fusion_bytes, impl=impl, donate=donate,
            collect=collect, cache=cache)
        return (out, stack_stats(collect)) if with_stats else out

    run.combine_path = "rvh"
    return run
