"""Step-addressed batch prefetching (the port of
`repro/runtime/prefetch.py`).

The deterministic sources in `repro_torch.data.pipeline` make every batch
a pure function of (seed, step). The `Prefetcher` builds the next batches
on a background thread while step `i` runs, so the step loop only blocks
when the host is slower than the card.

Restart contract: batches are addressed BY STEP (never by queue
position), so prefetching cannot change the stream — `get(step)` returns
bitwise the tensors the synchronous path would have built, and a
save/restore/resume simply starts asking for another step. Stale
speculative work is dropped, never consumed.

Staging. `host_stage` (the default, and the CPU path) turns the numpy
batch into tensors with `torch.from_numpy`; the step loop moves them to
its device. `DeviceStage` also copies the batch to the card from the
prefetch thread: pinned host tensors, a `non_blocking` copy on a side
CUDA stream the thread owns, and an event that the consuming stream
waits on in `get` (with `record_stream` on that stream, so the caching
allocator does not reuse the batch's memory while the step reads it).
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

import torch

PyTree = Any


def host_stage(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


class DeviceStage:
    """Stage and claim functions that put the batch on `device` from the
    prefetch thread (a side stream on a card; `torch.from_numpy` on the
    CPU)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._stream = None     # made by the first stage, in the thread

    def __call__(self, batch: Dict[str, Any]):
        if self.device.type != "cuda":
            return host_stage(batch), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            out = {k: torch.from_numpy(v).pin_memory().to(
                self.device, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def claim(self, staged) -> Dict[str, torch.Tensor]:
        """On the consuming thread: order its stream after the copy."""
        out, done = staged
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in out.values():
                t.record_stream(cur)
        return out


class Prefetcher:
    """Wraps a deterministic `source` (anything with `.batch(step)`).

    `get(step)` returns the staged batch for `step` and schedules the
    next `depth` steps on the background thread (double-buffered at the
    default depth=1). Completed-but-unclaimed futures for other steps are
    discarded on seek, preserving the pure-(seed, step) contract.
    `stage(host_batch)` runs on the prefetch thread; `claim(staged)` on
    the thread that calls `get`.
    """

    def __init__(self, source, *, depth: int = 1,
                 limit: Optional[int] = None,
                 stage: Optional[Callable[[Dict], Any]] = None,
                 claim: Optional[Callable[[Any], Dict]] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.source = source
        self.depth = depth
        self.limit = limit      # first step NOT to produce (end of run)
        self._stage = stage or host_stage
        self._claim = claim or (lambda staged: staged)
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="repro-prefetch")
        self._pending: Dict[int, Future] = {}
        self._lock = threading.Lock()
        self._closed = False
        # how often the loop found its batch ready vs had to build it
        # synchronously (miss == no overlap won)
        self.hits = 0
        self.misses = 0

    # ----------------------------------------------------------- internals
    def _produce(self, step: int):
        return self._stage(self.source.batch(step))

    def _schedule(self, step: int):
        if self.limit is not None and step >= self.limit:
            return      # never speculate past the end of the run
        if step not in self._pending:
            self._pending[step] = self._pool.submit(self._produce, step)

    # ------------------------------------------------------------- public
    def schedule(self, step: int):
        """Hint: start producing `step` in the background."""
        with self._lock:
            if not self._closed:
                self._schedule(step)

    def get(self, step: int) -> Dict[str, torch.Tensor]:
        """The batch for `step` — bitwise `source.batch(step)` after
        staging, whatever was speculatively produced before."""
        with self._lock:
            if self._closed:
                return self._claim(self._produce(step))
            fut = self._pending.pop(step, None)
            # a seek (restart/resume) invalidates speculation for other
            # steps; drop it so memory stays at O(depth) batches
            stale = [s for s in self._pending
                     if s < step or s > step + self.depth]
            for s in stale:
                self._pending.pop(s)
            for i in range(1, self.depth + 1):
                self._schedule(step + i)
        if fut is None:
            self.misses += 1
            return self._claim(self._produce(step))
        self.hits += 1
        return self._claim(fut.result())

    def close(self):
        with self._lock:
            self._closed = True
            self._pending.clear()
        self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
