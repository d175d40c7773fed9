"""Tensor fusion with per-layer boundary bookkeeping (paper §4.4.3) — the
port of `repro/core/fusion.py`.

Leaves are fused into flat buffers before the combine, and the
per-tensor boundaries inside a buffer are kept so that per-layer dot
products (§3.6) survive fusion. Layouts are host-side ints, computed
exactly as the reference computes them (offsets, `padded_len`, segment
ids), from the leaves in `jax.tree.flatten` order (`repro_torch.tree`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as T

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Spec:
    """Shape and dtype of a leaf that need not exist (the reference's
    `jax.ShapeDtypeStruct`; a leaf, not a tuple node, of a pytree)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class FusionLayout:
    """Static layout of the fused flat buffer.

    Attributes:
      shapes:    leaf shapes in flatten order.
      dtypes:    leaf dtypes.
      offsets:   start offset of each leaf in the fused buffer.
      sizes:     element count of each leaf.
      padded_len: total buffer length, padded to a multiple of `align`.
      num_segments: number of real segments (== number of leaves); the
        padding tail is segment `num_segments` (a dummy layer).
      treedef:   pytree structure for unpacking.
    """
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[Any, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    padded_len: int
    num_segments: int
    treedef: Any

    def segment_ids(self) -> np.ndarray:
        """int32 [padded_len] mapping each element to its layer index."""
        seg = np.full((self.padded_len,), self.num_segments, dtype=np.int32)
        for i, (off, sz) in enumerate(zip(self.offsets, self.sizes)):
            seg[off:off + sz] = i
        return seg


def make_layout(tree: PyTree, *, align: int = 1, leaf_align: int = 1
                ) -> FusionLayout:
    """A FusionLayout for a pytree of tensors or `Spec`s.

    `align`: pad the buffer total to a multiple of this. `leaf_align`:
    start every leaf at a multiple of this (the block kernels' contract:
    one layer per kernel block)."""
    leaves, treedef = T.flatten(tree)
    shapes, dtypes, offsets, sizes = [], [], [], []
    off = 0
    for leaf in leaves:
        if leaf_align > 1:
            off = ((off + leaf_align - 1) // leaf_align) * leaf_align
        shapes.append(tuple(leaf.shape))
        dtypes.append(leaf.dtype)
        sz = int(np.prod(leaf.shape)) if len(leaf.shape) else 1
        offsets.append(off)
        sizes.append(sz)
        off += sz
    align = max(align, 1) * max(leaf_align, 1)
    padded = ((off + align - 1) // align) * align
    padded = max(padded, align)
    return FusionLayout(tuple(shapes), tuple(dtypes), tuple(offsets),
                        tuple(sizes), padded, len(leaves), treedef)


def layout_bytes(layout: FusionLayout) -> int:
    """Raw (unpadded) payload bytes of one lane of the fused buffer."""
    return sum(sz * dt.itemsize for sz, dt in zip(layout.sizes,
                                                   layout.dtypes))


def _result_type(dtypes) -> torch.dtype:
    return functools.reduce(torch.promote_types, dtypes)


def pack(tree: PyTree, layout: FusionLayout, dtype=None) -> torch.Tensor:
    """Flattens leaves into the fused buffer (zero padded, including the
    alignment gaps between leaves)."""
    leaves = T.leaves(tree)
    dtype = dtype or _result_type(layout.dtypes)
    buf = torch.zeros((layout.padded_len,), dtype=dtype,
                      device=leaves[0].device)
    for leaf, off, sz in zip(leaves, layout.offsets, layout.sizes):
        buf[off:off + sz] = leaf.reshape(-1)
    return buf


def unpack(buf: torch.Tensor, layout: FusionLayout) -> PyTree:
    """Splits the fused buffer back into the original pytree. Leaves are
    views of `buf` where no cast is needed."""
    leaves = [buf[off:off + sz].reshape(shape).to(dtype)
              for shape, dtype, off, sz in zip(layout.shapes, layout.dtypes,
                                               layout.offsets, layout.sizes)]
    return T.unflatten(layout.treedef, leaves)


def bucketize_sizes(sizes_bytes: Sequence[int], bucket_bytes: int
                    ) -> List[Tuple[int, int]]:
    """Splits a run of per-leaf byte sizes into contiguous buckets of
    ~bucket_bytes, never splitting a leaf across buckets (Horovod's
    fusion threshold). Returns (leaf_start, leaf_end) index ranges."""
    buckets: List[Tuple[int, int]] = []
    start, acc = 0, 0
    for i, nbytes in enumerate(sizes_bytes):
        if acc > 0 and acc + nbytes > bucket_bytes:
            buckets.append((start, i))
            start, acc = i, 0
        acc += nbytes
    buckets.append((start, len(sizes_bytes)))
    return buckets


def bucketize(layout: FusionLayout, bucket_bytes: int, itemsize: int = 4
              ) -> List[Tuple[int, int]]:
    """`bucketize_sizes` over a layout's leaves at a uniform itemsize."""
    return bucketize_sizes([sz * itemsize for sz in layout.sizes],
                           bucket_bytes)


def select_block_elems(sizes: Sequence[int], *, unit: int = 1024,
                       max_block: int = 8192, max_waste: float = 0.25
                       ) -> int:
    """The largest power-of-two multiple of `unit` (<= max_block) whose
    leaf-alignment padding wastes at most `max_waste` of the raw payload:
    big-matrix buckets get 8192-element blocks, buckets of tiny leaves
    (norms) fall to the `unit` granule."""
    raw = max(sum(int(s) for s in sizes), 1)
    b = max(max_block, unit)
    while b > unit:
        padded = sum((int(s) + b - 1) // b * b for s in sizes)
        if padded - raw <= max_waste * raw:
            return b
        b //= 2
    return unit


def pack_stacked(leaves: Sequence[torch.Tensor], layout: FusionLayout,
                 dtype=None) -> torch.Tensor:
    """Like `pack`, but every leaf carries a leading lane axis:
    [k, *shape] leaves -> [k, padded_len] buffer (alignment gaps and tail
    zero-padded). The layout describes the payload shapes."""
    dtype = dtype or _result_type(layout.dtypes)
    k = leaves[0].shape[0]
    buf = torch.zeros((k, layout.padded_len), dtype=dtype,
                      device=leaves[0].device)
    for leaf, off, sz in zip(leaves, layout.offsets, layout.sizes):
        buf[:, off:off + sz] = leaf.reshape(k, -1)
    return buf
