"""The delayed combine's split executor, `combine_delay = 1` (the port of
`repro/runtime/delayed.py`).

The single-program `train_step` of a delayed runtime runs the pending
correction, then the local step, then folds the correction in, one after
another on one stream. This executor runs the correction on a thread of
its own, on a CUDA stream of its own, while the caller's thread runs the
local step on the current stream, which

  * makes the overlap observable: per-step accounting splits
    `combine_wait_s` (time blocked on the correction after the local
    step finished) from `compute_s` (the local step itself);
  * lets a benchmark add interconnect latency to the exchange leg only
    (`comm_delay`, a sleep before the correction).

Bitwise contract: `step(state, batch)` gives exactly the state the
single-program step gives: the same pieces (`correction_fn`, `local_fn`,
`fold_fn` of the Runtime) in the same apply order (the lane mean first,
the correction second). The correction reads only the pending carry and
the local step writes a new one, so neither writes what the other reads;
the call consumes the state's pending carry (it is released as it is
packed), which no one reads again.

Streams: the local step's work is issued on the caller's current
stream; the correction waits on an event recorded there (the carry is
ready), runs on the side stream, and hands its result back with an event
the caller's stream waits on. Tensors that cross streams are
`record_stream`ed, so the caching allocator does not reuse their memory
while the other stream may still read it. Across ranks the correction
runs on the runtime's exchange comm, a process group of its own, so its
collectives never interleave with the local step's.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as T

PyTree = Any


class DelayedCombineStream:
    """Runs a delayed Runtime's round as two overlapped legs:

        stream = DelayedCombineStream(runtime, comm_delay=0.05)
        state, metrics = stream.step(state, batch)   # == train_step(...)

    `metrics` gains two host-side floats: `compute_s` (the local step's
    wall time, to the end of its work on the card) and `combine_wait_s`
    (the wait for the correction after that, ~0 when the overlap hides
    it)."""

    def __init__(self, runtime, *, comm_delay: float = 0.0):
        if runtime.correction_fn is None or runtime.local_fn is None:
            raise ValueError(
                "DelayedCombineStream needs a delayed-mode Runtime "
                "(EngineConfig.combine_delay=1): correction_fn/local_fn "
                "are only built then")
        self.runtime = runtime
        self.comm_delay = float(comm_delay)
        self._corr = runtime.correction_fn
        self._local = runtime.local_fn
        self._fold = runtime.fold_fn
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="repro-delayed-combine")
        self._side: Optional[torch.cuda.Stream] = None
        self.last_compute_s = 0.0
        self.last_combine_wait_s = 0.0

    # ------------------------------------------------------------- exchange
    def _side_stream(self, pending: PyTree) -> Optional[torch.cuda.Stream]:
        leaves = T.leaves(pending)
        if not leaves or leaves[0].device.type != "cuda":
            return None
        if self._side is None:
            self._side = torch.cuda.Stream(device=leaves[0].device)
        return self._side

    def _exchange(self, pending: PyTree, ready, donate: bool
                  ) -> Tuple[PyTree, Optional[torch.cuda.Event]]:
        """The exchange leg: the injected latency, then the correction,
        finished before it returns (so `combine_wait_s` measures
        readiness, not queueing). On a card it runs on the side stream
        after `ready`, and returns the event that marks its end."""
        if self.comm_delay > 0:
            time.sleep(self.comm_delay)
        side = self._side_stream(pending)
        if side is None:
            with torch.no_grad():
                return self._corr(pending, donate=donate), None
        with torch.cuda.stream(side), torch.no_grad():
            side.wait_event(ready)
            for x in T.leaves(pending):
                x.record_stream(side)
            corr = self._corr(pending, donate=donate)
            done = torch.cuda.Event()
            done.record(side)
        done.synchronize()
        return corr, done

    def _ready(self, pending: PyTree):
        """An event on the caller's stream after the carry's producer."""
        leaves = T.leaves(pending)
        if not leaves or leaves[0].device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(leaves[0].device))
        return ev

    def _fold_in(self, new_state, corr, done) -> Dict[str, Any]:
        new_state = dict(new_state)
        if done is not None:
            here = torch.cuda.current_stream(T.leaves(corr)[0].device)
            here.wait_event(done)
            for x in T.leaves(corr):
                x.record_stream(here)
        with torch.no_grad():
            self._fold(new_state["params"], corr)
        return new_state

    @staticmethod
    def _finish(new_state) -> None:
        """Wait for the caller's stream (the local step's work)."""
        leaves = [x for x in T.leaves(new_state["params"])
                  if isinstance(x, torch.Tensor)]
        if leaves and leaves[0].device.type == "cuda":
            torch.cuda.current_stream(leaves[0].device).synchronize()

    def combine_time(self, pending: PyTree) -> float:
        """Wall time (s) of one exchange on its own, without consuming
        `pending` — the quantity the overlap is supposed to hide."""
        t0 = time.perf_counter()
        self._exchange(pending, self._ready(pending), donate=False)
        return time.perf_counter() - t0

    # ----------------------------------------------------------------- step
    def step(self, state: PyTree, batch: Dict[str, Any]
             ) -> Tuple[PyTree, Dict[str, Any]]:
        t0 = time.perf_counter()
        pending = state["pending"]
        fut = self._pool.submit(self._exchange, pending,
                                self._ready(pending), True)
        try:
            new_state, metrics = self._local(state, batch)
            self._finish(new_state)
        finally:
            t1 = time.perf_counter()
            corr, done = fut.result()
        t2 = time.perf_counter()
        new_state = self._fold_in(new_state, corr, done)
        self.last_compute_s = t1 - t0
        self.last_combine_wait_s = t2 - t1
        metrics = dict(metrics, compute_s=self.last_compute_s,
                       combine_wait_s=self.last_combine_wait_s)
        return new_state, metrics

    def serial_step(self, state: PyTree, batch: Dict[str, Any]
                    ) -> Tuple[PyTree, Dict[str, Any]]:
        """The same round with the exchange run inline BEFORE the local
        step (no overlap): the baseline the overlap is measured against,
        bitwise the same state."""
        t0 = time.perf_counter()
        pending = state["pending"]
        corr, done = self._exchange(pending, self._ready(pending), True)
        t1 = time.perf_counter()
        new_state, metrics = self._local(state, batch)
        self._finish(new_state)
        t2 = time.perf_counter()
        new_state = self._fold_in(new_state, corr, done)
        metrics = dict(metrics, compute_s=t2 - t1, combine_wait_s=t1 - t0)
        return new_state, metrics

    def close(self) -> None:
        self._pool.shutdown(wait=True)
