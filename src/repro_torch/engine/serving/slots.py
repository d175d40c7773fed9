"""Slotted-cache device ops, the page pool and the paged-cache device ops
(the port of `repro/engine/serving/slots.py`).

Every op covers every node of both segments of a `DecodeCache`
(`layers`, and `dense_layers` of a MoE config with a dense prefix), as
the reference's tree-generic ops do: the four attention caches —
`KVCache` and `MLACache` (dense per-slot rows), `PagedKVCache` and
`PagedMLACache` (page arenas) — and the recurrent states (`RWKVState`,
the hybrid's `MambaState`), which stay dense per slot under every
layout. Each attention cache's first two fields are its rows or arenas
(k/v, or the latent c_kv and k_rope), the last its positions.

A slotted cache keeps the slot axis at position 1 of every leaf (the
layer axis is 0), per-slot positions and recurrent state included.
`insert_rows` / `insert_rows_at` admit freshly prefilled rows (and
states) into a dense cache, `select_rows` merges two cache versions
per slot, and `slot_positions` / `set_positions` read and rewrite the
per-slot positions — the rewrite is speculation's accept and rollback,
and touches attention caches only (recurrent state has no pos rewrite;
the engine never speculates on those families).

`PagePool` is the host-side allocator — refcounted physical pages, a
free list, copy-on-write — copied from the reference. The device ops
rewrite cache rows and page tables without changing a shape. Unlike the
reference, which rebuilds every cache functionally (`.at[].set`), the
row and page ops write IN PLACE (`index_put_` / `copy_`) and return the
cache they were given: copying a `[L, num_pages, page_size, ...]`
arena per admission or COW would swamp the card. Physical page 0 is the
trash page: free slots and unallocated table entries point at it,
making their garbage writes inert.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.attention import KVCache, MLACache
from repro_torch.models.transformer import (ATTN_CACHES, PAGED_CACHES,
                                            DecodeCache, cache_nodes,
                                            cache_segments, map_nodes,
                                            map_segments)


def _nbytes(a: torch.Tensor) -> int:
    return a.numel() * a.element_size()


# ======================================================== slotted caches
def insert_rows(cache: DecodeCache, row: DecodeCache,
                slot: int) -> DecodeCache:
    """Write a one-slot cache into `cache` at slot index `slot`, in
    place (every leaf of the slot: rows, states and positions)."""
    for c, r in zip(cache_nodes(cache), cache_nodes(row)):
        for dst, src in zip(c, r):
            dst[:, slot:slot + 1] = src.to(dst.dtype)
    return cache


def insert_rows_at(cache: DecodeCache, rows: DecodeCache,
                   slots: torch.Tensor) -> DecodeCache:
    """Scatter an n-slot cache (a group's prefill rows) into `cache` at
    slot indices `slots` [n], in place — the dense layout's admission."""
    idx = slots.long()
    for c, r in zip(cache_nodes(cache), cache_nodes(rows)):
        for dst, src in zip(c, r):
            dst[:, idx] = src.to(dst.dtype)
    return cache


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """torch.where on axis 1 (slots or physical pages) of [L, n, ...]."""
    m = mask.reshape((1, mask.shape[0]) + (1,) * (a.dim() - 2))
    return torch.where(m, a, b)


def select_rows(mask: torch.Tensor, new: DecodeCache,
                old: DecodeCache) -> DecodeCache:
    """Per-slot select over dense caches, every leaf of every node: slots
    where mask[b] take `new`, the others keep `old`. mask: bool [B] over
    the slot axis. Returns new tensors."""
    return map_nodes(lambda n, o: type(n)(
        *(_sel(mask, a, b) for a, b in zip(n, o))), new, old)


def select_states(mask: torch.Tensor, new: DecodeCache,
                  old: DecodeCache) -> DecodeCache:
    """`select_rows` over the recurrent states and the attention caches'
    positions: slots where mask[b] take `new`'s, the others keep `old`'s.
    The attention rows and arenas are `new`'s (a paged arena has no slot
    axis to select on; a dense row a step wrote at a kept slot's pos is
    masked, and that slot's next decode overwrites it)."""
    return map_nodes(lambda n, o: n._replace(pos=_sel(mask, n.pos, o.pos))
                     if isinstance(n, ATTN_CACHES)
                     else type(n)(*(_sel(mask, a, b) for a, b in zip(n, o))),
                     new, old)


def state_copy(cache: DecodeCache) -> DecodeCache:
    """What `select_states` reads from `old`: a copy of every recurrent
    state and of every attention cache's positions; the rows and arenas
    are shared with `cache`."""
    return map_nodes(lambda n: n._replace(pos=n.pos.clone())
                     if isinstance(n, ATTN_CACHES)
                     else type(n)(*(t.clone() for t in n)), cache)


def slot_positions(cache: DecodeCache) -> torch.Tensor:
    """The per-slot positions [B] (layer 0's of the first node; every
    layer of every node holds the same)."""
    pos = cache_nodes(cache)[0].pos
    if pos.dim() != 2:
        raise ValueError("cache has no per-slot pos; was it built with "
                         "per_slot=True?")
    return pos[0]


def set_positions(cache: DecodeCache, pos: torch.Tensor) -> DecodeCache:
    """The cache with every layer's per-slot pos set to `pos` [B], in
    both segments. This values-only rewrite IS speculative accept and
    rollback: advancing pos to old_pos + accepted + 1 commits the
    accepted rows, and what the verify wrote beyond it becomes masked
    garbage that the next writes overwrite. Rows and arenas are shared
    with `cache`."""
    return map_segments(lambda att: att._replace(
        pos=pos.to(torch.int32).expand_as(att.pos).clone()), cache)


def dense_kv_bytes(cache: DecodeCache) -> int:
    """Bytes of the dense attention rows (K/V, or MLA's latent and rope
    key; positions and recurrent state excluded) in every segment: the
    constant footprint of kv_layout='dense', which the paged arena's
    `kv_bytes_in_use` is compared against."""
    return sum(_nbytes(a) for c in cache_nodes(cache)
               if isinstance(c, (KVCache, MLACache)) for a in c[:2])


def dense_fallback_stats(cache: DecodeCache) -> tuple:
    """(leaves, bytes) of the per-slot state living outside page arenas
    in a cache built for kv_layout='paged' (slots.py:334): the mamba or
    rwkv recurrent state, positions included. An all-dense cache (the
    ssm fallback) counts every leaf."""
    leaves = [t for c in cache_nodes(cache)
              if not isinstance(c, PAGED_CACHES) for t in c]
    return len(leaves), sum(_nbytes(t) for t in leaves)


# ============================================================== page pool
class PagePool:
    """Host-side physical-page allocator for the paged KV arena.

    Pages are refcounted: a page owned by one slot has refcount 1; a
    shared read-only prefix page holds one reference per slot using it
    plus (optionally) one held by the prefix index that keeps it warm for
    future requests. Physical page 0 is the reserved trash page — never
    allocated, never freed; free slots' table entries point at it.

    The pool is pure bookkeeping: the engine pairs each transition with
    the matching device op (``paged_insert_rows``, ``copy_pages``,
    ``set_page_tables``)."""

    TRASH = 0

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 2, f"need >= 2 pages (1 is trash), {num_pages}"
        assert page_size >= 1, page_size
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # pop() low
        self._ref = np.zeros((num_pages,), np.int32)
        self._ref[self.TRASH] = 1          # never allocatable

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """n fresh pages (refcount 1 each), or None if the pool cannot
        cover the request (caller evicts and retries)."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def ref(self, pages) -> None:
        """Take one extra reference on each page (prefix sharing)."""
        for p in pages:
            assert self._ref[p] > 0, f"ref on free page {p}"
            self._ref[p] += 1

    def release(self, pages) -> None:
        """Drop one reference per page; pages hitting zero return to the
        free list."""
        for p in pages:
            assert p != self.TRASH and self._ref[p] > 0, (p, self._ref[p])
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(int(p))

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def is_shared(self, page: int) -> bool:
        return self._ref[page] > 1

    def cow(self, page: int) -> Optional[int]:
        """Copy-on-write: drop this slot's reference on a shared `page`
        and allocate a private destination page. Returns the new page id
        (the caller must issue the device ``copy_pages``), or None if the
        pool is exhausted."""
        got = self.alloc(1)
        if got is None:
            return None
        self.release([page])
        return got[0]

    def __repr__(self):
        return (f"PagePool(pages={self.num_pages}, size={self.page_size}, "
                f"used={self.pages_used}, free={self.pages_free})")


# ====================================================== paged device ops
def paged_insert_rows(cache: DecodeCache, rows: DecodeCache,
                      slots: torch.Tensor, write_tables: torch.Tensor,
                      new_tables: torch.Tensor) -> DecodeCache:
    """Admit n freshly-prefilled rows into the paged cache, in place.

    `rows` is the dense per-slot cache the prefill emits (rows
    [L, n, cap, ...] in each segment); its rows are scattered into the
    arenas through `write_tables` [n, pages_per_slot] — the slots' new
    tables with every non-owned entry (shared prefix pages, unallocated
    tail) at trash page 0, so shared pages are never clobbered. The
    slots' page tables are set to `new_tables` and their positions to
    the rows'. Recurrent states take the plain per-slot scatter."""
    P = write_tables.shape[1]
    idx = write_tables.long()
    slots = slots.long()
    for c, r in zip(cache_nodes(cache), cache_nodes(rows)):
        if not isinstance(c, PAGED_CACHES):
            for dst, src in zip(c, r):
                dst[:, slots] = src.to(dst.dtype)
            continue
        for arena, dense in zip(c[:2], r[:2]):
            Lyr, n = dense.shape[:2]
            arena[:, idx] = dense.reshape(
                (Lyr, n, P, arena.shape[2]) + dense.shape[3:]).to(arena.dtype)
        c.page_table[:, slots] = new_tables.to(torch.int32)
        c.pos[:, slots] = r.pos
    return cache


def gather_prefix(cache: DecodeCache, pages: torch.Tensor) -> DecodeCache:
    """Read a shared-prefix context back out of the arenas: `pages`
    [n_pages] physical ids in logical order -> DecodeCache of per-layer
    pairs [L, 1, n_pages * page_size, ...] in each segment (K/V, or the
    MLA latents; a leading singleton batch axis the prefill broadcasts
    across the admission group). Feeds `prefill_cache(prefix_kv=...)`."""
    def g(arena):
        sel = arena[:, pages.long()]                 # [L, n, ps, ...]
        Lyr, n, psz = sel.shape[:3]
        return sel.reshape((Lyr, 1, n * psz) + sel.shape[3:])
    return map_segments(lambda c: (g(c[0]), g(c[1])), cache)


def copy_pages(cache: DecodeCache, src: torch.Tensor,
               dst: torch.Tensor) -> DecodeCache:
    """Copy arena pages src[i] -> dst[i] in every layer of every
    segment, in place (the COW backing-store move). Page tables and
    positions untouched."""
    for c in cache_segments(cache):
        for arena in c[:2]:
            arena[:, dst.long()] = arena[:, src.long()]
    return cache


def set_page_tables(cache: DecodeCache, tables: torch.Tensor) -> DecodeCache:
    """Install the host-side page tables [B, pages_per_slot] into every
    layer of every segment, in place (values only: no shape ever
    changes)."""
    for c in cache_segments(cache):
        pt = c.page_table
        pt.copy_(tables.to(device=pt.device, dtype=torch.int32).expand_as(pt))
    return cache


def select_rows_paged(slot_mask: torch.Tensor, page_mask: torch.Tensor,
                      new: DecodeCache, old: DecodeCache) -> DecodeCache:
    """Merge two versions of a paged cache: arena leaves per PHYSICAL
    page (`page_mask` [num_pages] marks pages taken from `new`), per-slot
    leaves (page tables, positions, recurrent state) by `slot_mask` [B].
    Returns new tensors. The reference merges hot-reload transition
    ticks with it; in the port it serves callers that keep two cache
    versions."""
    def sel(n, o):
        if not isinstance(n, PAGED_CACHES):
            return type(n)(*(_sel(slot_mask, a, b) for a, b in zip(n, o)))
        return type(n)(_sel(page_mask, n[0], o[0]),
                       _sel(page_mask, n[1], o[1]),
                       _sel(slot_mask, n.page_table, o.page_table),
                       _sel(slot_mask, n.pos, o.pos))
    return map_nodes(sel, new, old)


def paged_kv_page_bytes(cache: DecodeCache) -> int:
    """Bytes one physical page occupies across all layers, both arenas
    and both segments — the unit of `kv_bytes_in_use` accounting."""
    return sum(_nbytes(a) // a.shape[1]
               for c in cache_segments(cache) for a in c[:2])
