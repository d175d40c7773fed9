"""Request-level scheduling for ServeEngine: continuous batching (the
port's copy of `repro/engine/serving/scheduler.py`, numpy only).

A FIFO queue feeds a fixed pool of `max_slots` decode slots; a request
is admitted the moment a slot frees up and retired on EOS or on its
token budget. Slot count and cache capacity are fixed at engine build,
so the churn of the active set never changes a device-side shape.

Resilience, as in the reference: per-request deadlines and retry budgets
(`deadline_s`, `max_retries`), recompute preemption back to the queue
front (`preempt`), terminal failure from queue or slot (`fail`), and the
`PressureLadder` that sheds speculation, then admissions, then preempts
as the page pool runs dry.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

_REQ_IDS = itertools.count()


@dataclasses.dataclass
class GenerationRequest:
    """One decode job: a prompt, its sampling budget, and its policy.

    stream: optional per-token callback `fn(handle, token)` fired as each
    token is committed (including the one produced by the prefill).

    Sampling: `temperature=0` (the default) is greedy argmax — the
    tested-bitwise path. With `temperature>0` the engine samples, after
    optional `top_k` (0 = off) and nucleus `top_p` (1.0 = off)
    truncation. Decode stays reproducible: token t of a request is a
    pure function of (`seed`, t) — `seed` defaults to the request_id —
    independent of batch composition or admission timing.

    Resilience: `deadline_s` is a wall-clock budget from submission —
    an expired request fails terminally with finish_reason 'deadline'
    (it is never left hanging in the queue or a slot). `max_retries`
    bounds recompute preemptions: the (max_retries+1)-th preemption
    fails the request with finish_reason 'retries' instead of requeueing
    it. Both default to off (None)."""
    prompt: np.ndarray                      # [T] int token ids
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    stream: Optional[Callable] = None
    temperature: float = 0.0                # 0 => greedy argmax
    top_k: int = 0                          # 0 => no top-k truncation
    top_p: float = 1.0                      # 1.0 => no nucleus truncation
    seed: Optional[int] = None              # None => request_id
    deadline_s: Optional[float] = None      # wall-clock budget (None = none)
    max_retries: Optional[int] = None       # preemption budget (None = inf)
    request_id: int = dataclasses.field(
        default_factory=lambda: next(_REQ_IDS))

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got "
                             f"{self.deadline_s}")
        if self.max_retries is not None and self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")

    @property
    def sampling_seed(self) -> int:
        return self.request_id if self.seed is None else self.seed


class RequestHandle:
    """Live view of a submitted request. The engine appends to `tokens`
    as decode ticks complete; `done` flips on retirement."""

    def __init__(self, request: GenerationRequest):
        self.request = request
        self.tokens: List[int] = []          # generated tokens (no prompt)
        self.status = "queued"               # queued | running | done | failed
        self.slot: Optional[int] = None
        self.version: Optional[int] = None   # params version when admitted
        self.finish_reason: Optional[str] = None
        # eos | length | deadline | retries | drained
        self.submitted_at = time.perf_counter()
        self.first_token_at: Optional[float] = None
        self.done_at: Optional[float] = None
        self.retries = 0                     # recompute preemptions so far
        # speculation accounting: draft tokens proposed for / accepted by
        # this request
        self.spec_proposed = 0
        self.spec_accepted = 0

    @property
    def done(self) -> bool:
        """Terminal — completed OR failed (deadline/retries/drained). A
        submitted request always becomes done; it is never left hanging."""
        return self.status in ("done", "failed")

    @property
    def failed(self) -> bool:
        return self.status == "failed"

    @property
    def deadline_at(self) -> Optional[float]:
        d = self.request.deadline_s
        return None if d is None else self.submitted_at + d

    def past_deadline(self, now: float) -> bool:
        da = self.deadline_at
        return da is not None and now > da

    @property
    def output(self) -> np.ndarray:
        """prompt + generated tokens, the legacy `generate` row layout."""
        return np.concatenate(
            [self.request.prompt, np.asarray(self.tokens, np.int32)])

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (submit -> first commit), seconds."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token AFTER the first (the streaming
        cadence), seconds; None until 2+ tokens exist."""
        if self.done_at is None or len(self.tokens) < 2:
            return None
        return (self.done_at - self.first_token_at) / (len(self.tokens) - 1)

    def __repr__(self):
        return (f"RequestHandle(id={self.request.request_id}, "
                f"status={self.status}, slot={self.slot}, "
                f"tokens={len(self.tokens)})")


class ContinuousBatchingScheduler:
    """FIFO admission into a fixed slot pool; retire on EOS/budget."""

    def __init__(self, max_slots: int, max_len: int):
        assert max_slots >= 1 and max_len >= 2, (max_slots, max_len)
        self.max_slots = max_slots
        self.max_len = max_len
        self.queue: deque = deque()
        self.active: Dict[int, RequestHandle] = {}
        self._free: List[int] = list(range(max_slots))

    # ---------------------------------------------------------- lifecycle
    def submit(self, handle: RequestHandle):
        req = handle.request
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.request_id}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds the slot "
                f"capacity max_len={self.max_len}")
        self.queue.append(handle)

    def admit(self, accept: Optional[Callable] = None
              ) -> List[Tuple[int, RequestHandle]]:
        """Move queued requests into free slots (FIFO). Returns the
        (slot, handle) pairs admitted this tick.

        accept(handle) -> bool: optional admission gate (the paged
        engine declines when the page pool cannot cover the prompt).
        FIFO order is preserved — a declined head blocks the queue until
        pages free up, keeping admission starvation-free."""
        out = []
        while self._free and self.queue:
            if accept is not None and not accept(self.queue[0]):
                break
            slot = self._free.pop(0)
            handle = self.queue.popleft()
            handle.slot, handle.status = slot, "running"
            self.active[slot] = handle
            out.append((slot, handle))
        return out

    def preempt(self, slot: int) -> RequestHandle:
        """Evict a running request back to the FRONT of the queue
        (recompute preemption under page-pool pressure). Its generated
        tokens are kept; re-admission prefills prompt+generated.

        With a `max_retries` budget, the (budget+1)-th preemption fails
        the request terminally (finish_reason 'retries') instead of
        requeueing — the caller checks `handle.failed` on the return."""
        handle = self.active.pop(slot)
        handle.status, handle.slot = "queued", None
        self._free.append(slot)
        handle.retries += 1
        budget = handle.request.max_retries
        if budget is not None and handle.retries > budget:
            handle.status = "failed"
            handle.finish_reason = "retries"
            handle.done_at = time.perf_counter()
        else:
            self.queue.appendleft(handle)
        return handle

    def fail(self, handle: RequestHandle, reason: str) -> None:
        """Terminal failure (deadline expiry, drain, retry exhaustion):
        remove the handle from wherever it sits — queue or slot — and
        mark it failed. Idempotent on already-terminal handles. The
        caller releases any KV pages the slot held BEFORE calling."""
        if handle.done:
            return
        if handle.status == "running" and handle.slot is not None:
            self.active.pop(handle.slot, None)
            self._free.append(handle.slot)
            handle.slot = None
        elif handle.status == "queued":
            try:
                self.queue.remove(handle)
            except ValueError:
                pass
        handle.status = "failed"
        handle.finish_reason = reason
        handle.done_at = time.perf_counter()

    def expired(self, now: Optional[float] = None) -> List[RequestHandle]:
        """Queued + running handles past their deadline (host-side
        bookkeeping only; the engine releases pages then calls fail)."""
        now = time.perf_counter() if now is None else now
        return [h for h in list(self.queue) + list(self.active.values())
                if h.past_deadline(now)]

    def should_retire(self, handle: RequestHandle, token: int) -> Optional[str]:
        req = handle.request
        if req.eos_id is not None and token == req.eos_id:
            return "eos"
        if len(handle.tokens) >= req.max_new_tokens:
            return "length"
        return None

    def retire(self, slot: int, reason: str):
        handle = self.active.pop(slot)
        handle.status, handle.finish_reason = "done", reason
        handle.done_at = time.perf_counter()
        handle.slot = None
        self._free.append(slot)

    # -------------------------------------------------------------- state
    @property
    def has_work(self) -> bool:
        return bool(self.active or self.queue)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def occupancy(self) -> float:
        return len(self.active) / self.max_slots


class PrefixIndex:
    """Host-side registry of shared-prefix pages (vLLM-style prefix
    caching): maps page-aligned token prefixes to the physical pages
    holding their K/V, so a request whose prompt starts with an
    already-prefilled prefix (the common one-system-prompt-many-users
    serve shape) reuses those pages read-only and prefills only its
    unshared tail.

    Keys are the EXACT token bytes of the prefix up to each page
    boundary — no hash collisions, correctness by construction. Only
    FULL pages are ever registered, capped at (len(prompt) - 1) //
    page_size: the last prompt token always lands in the requester's own
    pages, so the extend-prefill has at least one tail token to compute
    logits from, and decode never writes into a registered page
    (registered pages are immutable). Entries are LRU-ordered; the pool
    evicts least-recently-matched entries first when it runs dry."""

    def __init__(self, page_size: int):
        assert page_size >= 1
        self.page_size = page_size
        self._pages: "OrderedDict[bytes, int]" = OrderedDict()  # key -> pid
        self._keys: Dict[int, bytes] = {}                       # pid -> key

    def _key(self, prompt: np.ndarray, n_pages: int) -> bytes:
        return np.ascontiguousarray(
            prompt[:n_pages * self.page_size], np.int32).tobytes()

    def max_shareable(self, prompt: np.ndarray) -> int:
        """Pages a prompt could share: full pages strictly before the
        final token."""
        return max(0, (len(prompt) - 1) // self.page_size)

    def match(self, prompt: np.ndarray) -> List[int]:
        """Physical pages of the longest registered prefix of `prompt`
        (in logical order). Does NOT take references — the caller owns
        refcounting via its PagePool. Marks matched entries
        most-recently-used."""
        pages: List[int] = []
        for i in range(1, self.max_shareable(prompt) + 1):
            pid = self._pages.get(self._key(prompt, i))
            if pid is None:
                break
            pages.append(pid)
        if pages:
            # bump deepest-first so shallow chain links end most recent:
            # LRU eviction then drops leaf pages before their prefix,
            # never orphaning a reachable chain suffix
            for i in range(len(pages), 0, -1):
                self._pages.move_to_end(self._key(prompt, i))
        return pages

    def register(self, prompt: np.ndarray, page_ids: List[int],
                 start: int = 0) -> List[int]:
        """Record pages `start..start+len(page_ids)` of `prompt`'s chain
        (the caller passes the pages it just prefilled). Returns the
        subset actually registered (new entries — the caller holds one
        pool reference per returned page on the index's behalf)."""
        newly = []
        limit = min(start + len(page_ids), self.max_shareable(prompt))
        for i in range(start, limit):
            key = self._key(prompt, i + 1)
            if key in self._pages:
                continue
            pid = page_ids[i - start]
            self._pages[key] = pid
            self._keys[pid] = key
            newly.append(pid)
        # deepest-first recency bump (see match): shallow links stay
        # most recent so LRU eviction trims chains leaf-first
        for i in range(limit, start, -1):
            key = self._key(prompt, i)
            if key in self._pages:
                self._pages.move_to_end(key)
        return newly

    def evict_lru(self, evictable: Optional[Callable] = None
                  ) -> Optional[int]:
        """Drop the least-recently-used entry whose page `evictable(pid)`
        (default: any); returns its page id (the caller releases its
        pool reference). None when nothing qualifies. The filter lets
        the engine skip pages other slots still reference — evicting
        those frees nothing and would only cold the cache."""
        for key, pid in self._pages.items():        # LRU order
            if evictable is None or evictable(pid):
                del self._pages[key]
                del self._keys[pid]
                return pid
        return None

    def forget(self, pid: int) -> None:
        """Remove a page from the index (external eviction)."""
        key = self._keys.pop(pid, None)
        if key is not None:
            del self._pages[key]

    def pages(self) -> List[int]:
        """Every physical page the index currently references (one pool
        reference each, held on the index's behalf)."""
        return list(self._keys)

    def __contains__(self, pid: int) -> bool:
        return pid in self._keys

    def __len__(self) -> int:
        return len(self._pages)


class PressureLadder:
    """Serve-side graceful degradation (host logic only). Levels, in
    escalation order:

        0 normal   — everything on
        1 no_spec  — speculation off (draft dispatches stop competing
                     with real decode work)
        2 no_admit — admissions paused while anything is active
        3 preempt  — preempt-by-recompute the youngest slot when the
                     pool is dry, so older slots can grow

    `update` maps (free page fraction, queue depth) to a level with
    hysteresis: a level is entered when free_frac drops below its
    `enter` threshold, and only decays once free_frac clears
    `exit_margin` x that threshold AND the queue is no longer hot. Deep
    queues (>= queue_factor x max_slots) alone raise level 1."""

    LEVELS = ("normal", "no_spec", "no_admit", "preempt")

    def __init__(self, *, enter=(0.25, 0.10, 0.02), exit_margin: float = 1.5,
                 queue_factor: int = 4):
        if not enter[0] > enter[1] > enter[2] >= 0:
            raise ValueError(f"enter thresholds must strictly decrease to "
                             f">= 0, got {enter}")
        if exit_margin <= 1.0:
            raise ValueError(f"exit_margin must be > 1, got {exit_margin}")
        self.enter = tuple(enter)
        self.exit_margin = exit_margin
        self.queue_factor = queue_factor
        self.level = 0
        self.changes = 0

    @property
    def name(self) -> str:
        return self.LEVELS[self.level]

    def update(self, *, free_frac: float, queue_len: int,
               max_slots: int) -> int:
        target = 0
        for i, thr in enumerate(self.enter):
            if free_frac < thr:
                target = i + 1
        queue_hot = queue_len >= self.queue_factor * max(1, max_slots)
        if queue_hot:
            target = max(target, 1)
        if target < self.level:
            clear = (free_frac >= min(1.0, self.enter[self.level - 1]
                                      * self.exit_margin)
                     and not queue_hot)
            if not clear:
                target = self.level        # hysteresis: hold the level
        if target != self.level:
            self.level = target
            self.changes += 1
        return self.level
