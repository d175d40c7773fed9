"""Collectives for Adasum across ranks: a small object around a
`torch.distributed` process group, one process per rank. It gives
`core/rvh.py` what the reference gets from `lax.ppermute` and `lax.psum`
inside `shard_map` (repro/core/rvh.py:99-105, :172-177):

  exchange(sends, partner)  the XOR-partner swap of `lax.ppermute`: one
                            `batch_isend_irecv` holding an isend and an
                            irecv per tensor, so neither side waits on
                            the other;
  group_sum(v, block)       the grouped psum over contiguous blocks of
                            `block` ranks (`axis_index_groups`), as an
                            all_gather and a sum in rank order: every
                            rank of the block holds the same bits and a
                            repeat gives the same bits. Meant for the
                            small per-segment dot triples;
  allreduce(x)              an in-place sum over the comm's ranks
                            (`dist.all_reduce`: every rank gets the bits
                            the one reduction computed — gloo's and
                            NCCL's rings reduce each chunk on one rank
                            and copy it to the others — and a repeat the
                            same bits; its order is the library's, not
                            rank order). The full-vector sums: sum and
                            mean across ranks, the lane mean of the
                            delayed combine, adascale's lane mean and a
                            lane group's gradient;
  all_to_all(sends, recvs)  tensors to and from every other rank in one
                            batch of isends and irecvs (the rank-owned
                            chunks of `adasum_linear_ranks`);
  reduce_scatter(chunks)    chunk q of every rank summed on rank q, in
                            rank order (a lane group's gradient shards);
  all_gather(x)             every rank's tensor on every rank (sharded
                            params, the ZeRO-1 delta pieces);
  broadcast(x, src)         rank `src`'s tensor to every rank, in place;
  broadcast_object(o, src)  rank `src`'s picklable host object to every
                            rank (the elastic drivers' messages);
  align_groups()            rank 0's count of process groups made, on
                            every rank (before a parked rank rejoins);
  gather_to_host(x, srcs)   the tensors of ranks `srcs`, stacked in rank
                            0's host memory (a checkpoint's lane rows).

`Comm.init` starts the process group from the launch environment
(`RANK`, `WORLD_SIZE`, `LOCAL_WORLD_SIZE`, and `MASTER_ADDR` /
`MASTER_PORT` for the default `env://`, as `torch.distributed.run`
sets them). Subgroups are made once, when a comm is made, on every rank
in the same order (`dist.new_group` is collective): the blocks of 2, 4,
... ranks that `group_sum` uses, and the sub-communicators of `split`.

Every collective and every isend / irecv goes through the comm's own
process group, so two comms over the same ranks (the delayed combine's
exchange leg on a thread of its own beside the step's comm) never
interleave their messages in a different order on different ranks.

Staging: gloo carries host memory. A CUDA tensor on a gloo group is
copied through a pinned host buffer both ways (after a stream
synchronize), in messages of at most CHUNK_BYTES, and `staged_bytes`
counts the bytes copied between card and host. On NCCL, tensors go from
device to device and nothing is staged. NCCL takes one card per rank:
`init` refuses more ranks on a host than it has cards.

With `timing` on, each kind of call is timed (CUDA events on a card, the
host clock on the CPU; `take_ms` reads and clears them).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

DIST_BACKENDS = ("nccl", "gloo")
CHUNK_BYTES = 256 << 20     # largest single gloo message


def _pow2_blocks(n: int) -> List[int]:
    """Block sizes 2, 4, ... below n that divide n."""
    out, b = [], 2
    while b < n and n % b == 0:
        out.append(b)
        b *= 2
    return out


class Comm:
    """One rank's view of a group of ranks: `rank` (local index), `world`
    and `backend`. Made on every rank by `Comm.init` (all ranks) or
    `split` (sub-communicators)."""

    def __init__(self, ranks: Sequence[int], group, blocks: Dict[int, object],
                 device: torch.device, owner: bool = False,
                 flags: Optional[dict] = None,
                 host: Optional[Dict[str, torch.Tensor]] = None):
        self.ranks = tuple(ranks)           # global ranks, by local rank
        self.group = group
        self._blocks = blocks               # block size -> this rank's group
        self.rank = self.ranks.index(dist.get_rank())
        self.world = len(self.ranks)
        self.backend = str(dist.get_backend(group))
        self.device = device
        self.staged_bytes = 0
        self._flags = flags if flags is not None else {"timing": False}
        self._owner = owner                 # destroys the process group
        self._times: Dict[str, list] = {}
        # pinned staging buffers, by name; shared with the comm's
        # sub-communicators unless one runs on a thread of its own
        self._host: Dict[str, torch.Tensor] = {} if host is None else host
        self._children: List["Comm"] = []

    # ------------------------------------------------------------- creation
    @classmethod
    def init(cls, backend: str, device: torch.device,
             init_method: str = "env://",
             timeout_s: float = 600.0) -> "Comm":
        """Start the process group from the launch environment and return
        the comm of all ranks. Collective: every rank calls it."""
        if backend not in DIST_BACKENDS:
            raise ValueError(f"dist backend {backend!r}; one of "
                             f"{DIST_BACKENDS}")
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        device = torch.device(device)
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            cards = torch.cuda.device_count()
            if cards < local:
                raise ValueError(
                    f"nccl needs one card per rank: {local} ranks on this "
                    f"host and {cards} card(s). Ranks that share one card "
                    f"run over gloo (--dist-backend gloo --device cuda:0)")
            if device.type != "cuda":
                raise ValueError(f"nccl carries CUDA tensors; the device is "
                                 f"{device}")
            local_rank = int(os.environ.get("LOCAL_RANK", rank))
            if device.index not in (None, local_rank):
                raise ValueError(
                    f"nccl takes one card per rank: local rank {local_rank} "
                    f"runs on cuda:{local_rank}, not {device}. Ranks that "
                    f"share one card run over gloo (--dist-backend gloo)")
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        ranks = list(range(world))
        return cls(ranks, dist.group.WORLD, cls._block_groups(ranks)[1],
                   device, owner=True)

    @staticmethod
    def _block_groups(ranks: Sequence[int]):
        """Collective: a group per contiguous block of 2, 4, ... of
        `ranks`; returns (whether this rank is in `ranks`, {block: the
        group holding this rank})."""
        me = dist.get_rank()
        mine = {}
        for block in _pow2_blocks(len(ranks)):
            for s in range(0, len(ranks), block):
                members = list(ranks[s:s + block])
                g = dist.new_group(members)
                if me in members:
                    mine[block] = g
        return me in ranks, mine

    def split(self, groups: Sequence[Sequence[int]],
              share_staging: bool = True) -> "Comm":
        """Sub-communicators, one per list of local ranks in `groups` (a
        partition of this comm, each list ascending). Collective over
        this comm; returns the one holding this rank. It stages through
        this comm's pinned buffers (one set for every comm a rank calls
        in turn: pinned blocks are rounded up to a power of two and kept
        by the host allocator) unless `share_staging` is off, as it must
        be for a comm used on another thread beside this one."""
        mine = None
        for members in groups:
            ranks = [self.ranks[i] for i in members]
            g = dist.new_group(ranks)
            inside, blocks = self._block_groups(ranks)
            if inside:
                mine = Comm(ranks, g, blocks, self.device,
                            flags=self._flags,
                            host=self._host if share_staging else None)
        if mine is None:
            raise ValueError(f"rank {self.rank} is in none of {groups}")
        self._children.append(mine)
        return mine

    def align_groups(self) -> None:
        """Give every rank of this comm rank 0's count of the process
        groups made so far. `dist.new_group` names a group by that count
        on each process, and non-members take no part in it beyond the
        count; a rank that sat out splits the others made (an evicted
        rank parked while the survivors built their sub-communicators)
        would name its later groups differently and never meet the
        others in them. Collective."""
        from torch.distributed import distributed_c10d as c10d
        c10d._world.group_count = self.broadcast_object(
            c10d._world.group_count)

    def close(self) -> None:
        """Destroy the process group (the comm made by `init` only)."""
        if self._owner and dist.is_initialized():
            dist.destroy_process_group()
        self._owner = False

    # ------------------------------------------------------------- timing
    @property
    def timing(self) -> bool:
        """Whether calls are timed (shared with the sub-communicators)."""
        return self._flags["timing"]

    @timing.setter
    def timing(self, on: bool) -> None:
        self._flags["timing"] = bool(on)

    @contextlib.contextmanager
    def timed(self, name: str):
        """Time the body under `name` when `timing` is on."""
        if not self.timing:
            yield
            return
        if self.device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            self._times.setdefault(name, []).append((a, b))
        else:
            t0 = time.perf_counter()
            yield
            self._times.setdefault(name, []).append(
                1e3 * (time.perf_counter() - t0))

    def take_ms(self) -> Dict[str, float]:
        """Milliseconds per name since the last call, this comm and its
        sub-communicators summed; clears them."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out: Dict[str, float] = {}
        for c in [self] + self._children:
            for name, items in c._times.items():
                ms = sum(x if isinstance(x, float) else x[0].elapsed_time(x[1])
                         for x in items)
                out[name] = out.get(name, 0.0) + ms
            c._times = {}
        return out

    def free_buffers(self) -> None:
        """Drop the pinned host staging buffers this comm and its
        sub-communicators keep for reuse (sized to the largest message
        staged through them)."""
        for c in [self] + self._children:
            c._host.clear()

    def total_staged_bytes(self) -> int:
        return self.staged_bytes + sum(c.staged_bytes for c in self._children)

    # ------------------------------------------------------------ staging
    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def _host_buffer(self, key: str, nbytes: int) -> torch.Tensor:
        """A pinned uint8 host buffer of at least nbytes, kept for reuse."""
        buf = self._host.get(key)
        if buf is None or buf.numel() < nbytes:
            self._host.pop(key, None)
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._host[key] = buf
        return buf[:nbytes]

    def _to_host(self, ts: Sequence[torch.Tensor], key: str):
        """Byte views of `ts` in one pinned buffer (copied from the card)."""
        sizes = [t.numel() * t.element_size() for t in ts]
        host = self._host_buffer(key, sum(sizes))
        with self.timed("stage"):
            torch.cuda.current_stream(ts[0].device).synchronize()
            off = 0
            for t, n in zip(ts, sizes):
                host[off:off + n].copy_(t.reshape(-1).view(torch.uint8))
                off += n
        self.staged_bytes += sum(sizes)
        return host, sizes

    def _from_host(self, host: torch.Tensor, outs: Sequence[torch.Tensor]):
        with self.timed("stage"):
            off = 0
            for t in outs:
                n = t.numel() * t.element_size()
                t.reshape(-1).view(torch.uint8).copy_(host[off:off + n])
                off += n
        self.staged_bytes += host.numel()

    # -------------------------------------------------------- collectives
    def exchange(self, sends: Sequence[torch.Tensor], partner: int,
                 recvs: Optional[Sequence[torch.Tensor]] = None
                 ) -> List[torch.Tensor]:
        """Swap tensors with local rank `partner`, who calls this with
        tensors of the same shapes and dtypes. `recvs` (contiguous, e.g.
        views of a larger buffer) receive in place; by default new
        tensors. Returns the received tensors."""
        sends = [s.contiguous() for s in sends]
        if recvs is None:
            recvs = [torch.empty_like(s) for s in sends]
        peer = self.ranks[partner]
        with self.timed("exchange"):
            if self._staged(sends[0]):
                hsend, sizes = self._to_host(sends, "send")
                hrecv = self._host_buffer("recv", sum(sizes))
                self._p2p([hsend], [hrecv], peer)
                self._from_host(hrecv, recvs)
            else:
                flat = lambda ts: [t.reshape(-1).view(torch.uint8)
                                   for t in ts]
                self._p2p(flat(sends), flat(recvs), peer)
        return list(recvs)

    def _p2p(self, sends, recvs, peer: int) -> None:
        """isend every byte tensor of `sends` and irecv into `recvs`, in
        CHUNK_BYTES pieces on gloo, in one batch."""
        self._p2p_many([(s, r, peer) for s, r in zip(sends, recvs)])

    def _p2p_many(self, items) -> None:
        """One batch of (send bytes, receive bytes, global peer) items on
        the comm's group, each in CHUNK_BYTES pieces on gloo; empty items
        are skipped (both sides know their sizes)."""
        step = CHUNK_BYTES if self.backend == "gloo" else None
        ops = []
        for s, r, peer in items:
            for t, op in ((s, dist.isend), (r, dist.irecv)):
                n = t.numel()
                cuts = range(0, n, step) if step else ([0] if n else [])
                for c in cuts:
                    e = n if step is None else min(n, c + step)
                    ops.append(dist.P2POp(op, t[c:e], peer,
                                          group=self.group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()

    def all_to_all(self, sends: Sequence[Sequence[torch.Tensor]],
                   recvs: Sequence[Sequence[torch.Tensor]]) -> None:
        """sends[q]: this rank's tensors for local rank q; recvs[q]:
        contiguous tensors receiving local rank q's tensors for this rank
        (the byte sizes q sends), in place. This rank's own entries are
        copied. One batch of isends and irecvs, staged through pinned
        host buffers on gloo."""
        with self.timed("exchange"):
            self._all_to_all(sends, recvs)

    def _all_to_all(self, sends, recvs) -> None:
        me = self.rank
        for s, r in zip(sends[me], recvs[me]):
            r.copy_(s)
        peers = [q for q in range(self.world) if q != me]
        if not peers:
            return
        flat = lambda ts: [t.contiguous().reshape(-1).view(torch.uint8)
                           for t in ts]
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
        probe = next((t for q in peers for t in sends[q]), None)
        if probe is not None and self._staged(probe):
            # one tensor sent to every peer (an all-gather) is staged once
            same = all(len(sends[q]) == 1 and sends[q][0] is probe
                       for q in peers)
            outs = [probe] if same else [t for q in peers for t in sends[q]]
            hsend, _ = self._to_host(outs, "send")
            hrecv = self._host_buffer(
                "recv", sum(nbytes(recvs[q]) for q in peers))
            items, so, ro = [], 0, 0
            for q in peers:
                ns, nr = nbytes(sends[q]), nbytes(recvs[q])
                items.append((hsend[so:so + ns], hrecv[ro:ro + nr],
                              self.ranks[q]))
                so, ro = (so if same else so + ns), ro + nr
            self._p2p_many(items)
            self._from_host(hrecv, [t for q in peers for t in recvs[q]])
        else:
            self._p2p_many([
                (s, r, self.ranks[q]) for q in peers
                for s, r in zip(flat(sends[q]), flat(recvs[q]))])

    def _native(self, ts: Sequence[torch.Tensor]) -> bool:
        """Whether NCCL's own collective takes these per-rank tensors:
        on nccl, when every rank's is the same size."""
        return (self.backend == "nccl"
                and len({(tuple(t.shape), t.dtype) for t in ts}) == 1)

    def reduce_scatter(self, chunks: Sequence[torch.Tensor]) -> torch.Tensor:
        """chunks[q]: this rank's part of local rank q's sum (the same
        shapes on every rank; a chunk may be empty). Returns this rank's
        chunk summed over the ranks; consumes chunks[rank], which may hold
        the sum. On gloo (which has no reduce-scatter) each chunk travels
        to its owner in one batch of staged isends and irecvs, and the
        owner sums the ranks' parts in rank order, so a repeat gives the
        same bits; on nccl, with chunks of one size,
        `reduce_scatter_tensor` (nccl's order, as fixed)."""
        me, W = self.rank, self.world
        if W == 1:
            return chunks[0]
        with self.timed("reduce_scatter"):
            if self._native(chunks):
                out = torch.empty_like(chunks[me])
                dist.reduce_scatter_tensor(
                    out, torch.cat([c.reshape(-1) for c in chunks]).view(
                        (W,) + tuple(out.shape)), group=self.group)
                return out
            mine = chunks[me]
            recvs = [[] if q == me else [torch.empty(
                mine.shape, dtype=mine.dtype, device=mine.device)]
                for q in range(W)]
            sends = [[] if q == me else [c] for q, c in enumerate(chunks)]
            self._all_to_all(sends, recvs)
            parts = [mine if q == me else recvs[q][0] for q in range(W)]
            # rank order, c0 + c1 first (addition commutes, so this rank's
            # own chunk can hold the sum when it is one of the two)
            out = parts[me] if me < 2 else parts[0]
            out += parts[1 - me] if me < 2 else parts[1]
            for q in range(2, W):
                out += parts[q]
        return out

    def all_gather(self, x: torch.Tensor,
                   shapes: Optional[Sequence[Sequence[int]]] = None,
                   outs: Optional[Sequence[torch.Tensor]] = None
                   ) -> List[torch.Tensor]:
        """Every local rank's `x`, by rank (this rank's own is `x`).
        `shapes` gives each rank's shape when they differ (an empty one
        sends nothing); by default all are x's. `outs` (contiguous, e.g.
        slices of the whole tensor) receive in place, this rank's a copy
        of x. Staged isends and irecvs in one batch on gloo;
        `all_gather_into_tensor` on nccl when the shapes agree."""
        if self.world == 1:
            if outs is not None:
                outs[0].copy_(x)
            return [x] if outs is None else list(outs)
        shapes = [tuple(x.shape)] * self.world if shapes is None else \
            [tuple(s) for s in shapes]
        with self.timed("all_gather"):
            if outs is not None:
                x = x.contiguous()
                self._all_to_all([[x]] * self.world, [[t] for t in outs])
                return list(outs)
            outs = [x if q == self.rank else
                    torch.empty(shapes[q], dtype=x.dtype, device=x.device)
                    for q in range(self.world)]
            if self._native(outs):
                flat = torch.empty((self.world,) + tuple(x.shape),
                                   dtype=x.dtype, device=x.device)
                dist.all_gather_into_tensor(flat, x.contiguous(),
                                            group=self.group)
                return list(flat.unbind(0))
            x = x.contiguous()
            self._all_to_all([[x]] * self.world, [[t] for t in outs])
        return outs

    def _group(self, block: int):
        if block == self.world:
            return self.group
        if block not in self._blocks:
            raise ValueError(f"no block of {block} ranks in a comm of "
                             f"{self.world}")
        return self._blocks[block]

    def group_sum(self, v: torch.Tensor, block: int) -> torch.Tensor:
        """Sum of `v` over the contiguous block of `block` ranks holding
        this rank, in rank order (an all_gather, then a fixed-order sum).
        For small tensors."""
        if block == 1:
            return v
        with self.timed("dots_sum"):
            x = v.detach().contiguous()
            if self._staged(x):
                x = x.cpu()
                self.staged_bytes += 2 * x.numel() * x.element_size()
            parts = [torch.empty_like(x) for _ in range(block)]
            dist.all_gather(parts, x, group=self._group(block))
            out = parts[0].clone()
            for p in parts[1:]:
                out += p
        return out.to(v.device)

    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place sum (or, with op="max", maximum) of `x` over every
        rank of the comm."""
        if self.world == 1:
            return x
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        with self.timed("allreduce"):
            if self._staged(x):
                host, _ = self._to_host([x], "send")
                dist.all_reduce(host.view(x.dtype), op=rop, group=self.group)
                self._from_host(host, [x])
            else:
                dist.all_reduce(x, op=rop, group=self.group)
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Local rank `src`'s `x` into `x` on every rank, in place."""
        if self.world == 1:
            return x
        root = self.ranks[src]
        if self._staged(x):
            if self.rank == src:
                host, _ = self._to_host([x], "send")
            else:
                host = self._host_buffer("send", x.numel() * x.element_size())
            dist.broadcast(host, root, group=self.group)
            if self.rank != src:
                self._from_host(host, [x])
        else:
            dist.broadcast(x, root, group=self.group)
        return x

    def broadcast_object(self, obj, src: int = 0):
        """Local rank `src`'s picklable `obj` on every rank (the others
        pass anything, e.g. None). Collective."""
        if self.world == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src=self.ranks[src], group=self.group,
            device=self.device if self.backend == "nccl" else None)
        return box[0]

    def gather_to_host(self, x: torch.Tensor, srcs: Sequence[int]
                       ) -> Optional[torch.Tensor]:
        """The `x` of each local rank in `srcs` (same shape and dtype on
        each), stacked as [len(srcs), *x.shape] in local rank 0's host
        memory; None on every other rank. Only the ranks in `srcs` send,
        one after another, so rank 0 holds one received copy on its card
        at a time (nccl) or none (gloo). Collective over `srcs` and rank
        0; the other ranks return at once."""
        if self.rank != 0 and self.rank not in srcs:
            return None
        x = x.detach().contiguous()
        on_card = x.device.type == "cuda"
        gloo = self.backend == "gloo"
        nbytes = x.numel() * x.element_size()
        with self.timed("gather"):
            if self.rank != 0:
                if gloo and on_card:
                    x = x.cpu()
                    self.staged_bytes += nbytes
                self._send_recv(x, self.ranks[0], send=True)
                return None
            out = torch.empty((len(srcs),) + tuple(x.shape), dtype=x.dtype)
            buf = None if gloo or not on_card else torch.empty_like(x)
            for i, src in enumerate(srcs):
                if src == 0:
                    out[i].copy_(x)
                elif buf is None:
                    self._send_recv(out[i], self.ranks[src], send=False)
                else:
                    self._send_recv(buf, self.ranks[src], send=False)
                    out[i].copy_(buf)
            if on_card:     # rows copied from the card: its own, nccl's
                self.staged_bytes += nbytes * (1 if buf is None
                                               else len(srcs))
        return out

    def _send_recv(self, t: torch.Tensor, peer: int, send: bool) -> None:
        """Send `t` to (or receive it from) global rank `peer`, in
        CHUNK_BYTES pieces on gloo."""
        flat = t.reshape(-1).view(torch.uint8)
        n = flat.numel()
        step = CHUNK_BYTES if self.backend == "gloo" else max(n, 1)
        op = dist.isend if send else dist.irecv
        ops = [dist.P2POp(op, flat[c:c + step], peer, group=self.group)
               for c in range(0, n, step)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
