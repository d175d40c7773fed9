"""ServeEngine — request-level serving over EngineConfig (the port of the
paged path of `repro/engine/serving/engine.py`).

    engine = ServeEngine.from_config(
        EngineConfig(arch="qwen3-32b", reduced=True, max_slots=8,
                     max_len=128), device="cpu")
    h = engine.submit(GenerationRequest(prompt, max_new_tokens=32))
    engine.drain()                       # or: while engine.step(): ...
    h.tokens                             # generated ids (streamed too)

What it does, as the reference's default path:

  * **continuous batching** — a fixed pool of `max_slots` decode slots
    over one paged KV cache (per-slot positions, page tables); requests
    are admitted the moment a slot frees and retired on EOS/budget;
  * **fused prefill** — each admission group's prompts run through one
    `model.prefill_cache` forward (the flash kernel on a card);
  * **paged KV** — a global page arena sized in `page_size`-token pages,
    addressed through int32 page tables; a host-side `PagePool`
    allocates on admission/growth, frees on retirement and copies on
    write; page-aligned shared prompt prefixes map read-only onto the
    same physical pages and prefill computes only the unshared tail
    (flash kernel with q_offset = prefix length);
  * **decode** — one batched step per tick through the paged-decode
    kernel, greedy by default, per-slot sampling when a request asks;
  * **checkpoints** — `from_config` with `ckpt_dir` serves the params of
    the latest checkpoint (a params-only restore by manifest path, in
    the dtype the checkpoint stored); with `hot_reload` a `HotReloader`
    polls the directory each tick and params are versioned: new
    admissions take the newest version, in-flight slots finish on the
    version they were admitted with, and a swap flushes the prefix
    index (its pages hold K/V of the old weights).

The engine is single-threaded and tick-driven (`step()` = reload poll +
admit + one batched decode + retire). Device state is written in place
(see `slots`), so a transition tick — slots of two param versions live
at once — decodes once per version with the other versions' slots'
page-table rows pointed at the trash page: each pass writes K/V only
into the pages of its own version's slots, and each slot keeps the
token of its own version's pass. Speculation, deadlines, preemption and
the dense layout are later slices (ROADMAP.md queue 1); the options that
ask for them raise.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.attention import paged_capacity
from repro_torch.runtime import (ITEM_SERVING_EXTRAS, DeviceLike,
                                 make_generator, not_ported, resolve_device)
from ..build import make_batched_decode_step, make_sampling_decode_step, \
    sample_logits
from .reload import HotReloader
from .scheduler import (ContinuousBatchingScheduler, GenerationRequest,
                        PrefixIndex, RequestHandle)
from .slots import (PagePool, copy_pages, gather_prefix, paged_insert_rows,
                    paged_kv_page_bytes, set_page_tables)

PyTree = Any


def _bucket(n: int, max_len: int) -> int:
    """Prompt padding bucket: next power of two (min 8), clipped to the
    cache capacity."""
    b = 8
    while b < n:
        b *= 2
    return min(b, max_len)


def _params_template(model) -> PyTree:
    """The params tree as meta tensors (shapes only): what a params-only
    restore reads into."""
    from repro_torch.models.transformer import param_spec

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.empty(node[0], device="meta")
    return walk(param_spec(model.cfg))


def resolve_serve_parts(config, *, model=None, params=None,
                        checkpoint=None, device: DeviceLike = None,
                        generator: Optional[torch.Generator] = None):
    """arch -> model; a checkpoint manager from ckpt_dir; and params —
    the params-only restore of the latest checkpoint when there is one
    (on `device`), else freshly initialised on `device` from `generator`
    (default: seed 0 on that device). Returns (model, params, checkpoint,
    loaded_step)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import get_config, get_reduced
    from repro_torch.models import build_model

    config.validate()
    if model is None:
        if not config.arch:
            raise ValueError("EngineConfig.arch is empty — pass a built "
                             "Model via from_config(model=...)")
        mcfg = (get_reduced(config.arch) if config.reduced
                else get_config(config.arch))
        model = build_model(mcfg,
                            param_dtype=getattr(torch, config.param_dtype))
    if checkpoint is None and config.ckpt_dir:
        checkpoint = CheckpointManager(config.ckpt_dir)
    loaded_step = None
    if params is None:
        dev = resolve_device(device)
        if checkpoint is not None and checkpoint.latest_step() is not None:
            loaded_step = checkpoint.latest_step()
            params = checkpoint.restore_params(_params_template(model),
                                               loaded_step, device=dev)
        else:
            params = model.init(generator or make_generator(dev), device=dev)
    return model, params, checkpoint, loaded_step


class ServeEngine:
    """Continuous-batching serving engine for one (model, params)."""

    def __init__(self, config, model, params: PyTree, *, checkpoint=None,
                 loaded_step: Optional[int] = None):
        config.validate()
        cfg = model.cfg
        self.config = config
        self.model = model
        self.device = params["embed"]["table"].device
        # versioned params: in-flight slots pin the version they were
        # admitted with; hot-reload bumps _version for new admissions
        self._params: Dict[int, PyTree] = {0: params}
        self._version = 0
        self._loaded_step = loaded_step
        self.checkpoint = checkpoint
        self._reloader: Optional[HotReloader] = None
        if checkpoint is not None and config.hot_reload:
            self._reloader = HotReloader(checkpoint, params,
                                         loaded_step=loaded_step)
        self.max_slots = config.max_slots
        self.max_len = config.serve_max_len()
        self.scheduler = ContinuousBatchingScheduler(self.max_slots,
                                                     self.max_len)
        ps = config.page_size
        cap = paged_capacity(cfg, self.max_len)
        if cap % ps:
            raise ValueError(
                f"{cfg.name}: paged cache capacity {cap} (sliding window "
                f"{cfg.sliding_window}) is not a multiple of page_size="
                f"{ps}; pick a page size dividing the window")
        self._page_size = ps
        self._pages_per_slot = cap // ps
        # full provisioning: every slot at capacity + the trash page
        full = self.max_slots * self._pages_per_slot + 1
        self._num_pages = config.kv_pages or full
        if self._num_pages < self._pages_per_slot + 1:
            raise ValueError(
                f"kv_pages={self._num_pages} cannot hold even one full "
                f"slot: capacity {cap} needs {self._pages_per_slot} pages "
                f"of {ps} tokens plus the reserved trash page "
                f"(>= {self._pages_per_slot + 1})")
        if self._num_pages < full:
            raise not_ported(
                f"kv_pages={self._num_pages} below full provisioning "
                f"({full}): backpressure and recompute preemption",
                ITEM_SERVING_EXTRAS)
        self._pool = PagePool(self._num_pages, ps)
        share = config.prefix_sharing and not cfg.sliding_window
        self._prefix = PrefixIndex(ps) if share else None
        self._tables = np.zeros((self.max_slots, self._pages_per_slot),
                                np.int32)
        self._owned = np.zeros_like(self._tables, bool)
        self._shared = np.zeros_like(self._tables, bool)
        self._tables_dirty = False
        self._host_pos = np.zeros((self.max_slots,), np.int64)
        self.cache = model.init_cache(params, self.max_slots, self.max_len,
                                      paged=(ps, self._num_pages))
        self._page_bytes = paged_kv_page_bytes(self.cache)
        self._kv_capacity_bytes = (self._num_pages - 1) * self._page_bytes
        self._tokens = np.zeros((self.max_slots, 1), np.int32)
        # per-slot sampling policy rows; greedy slots (temperature 0)
        # take the argmax, an all-greedy tick skips sampling entirely
        self._temp = np.zeros((self.max_slots,), np.float32)
        self._topk = np.zeros((self.max_slots,), np.int32)
        self._topp = np.ones((self.max_slots,), np.float32)
        self._seeds = np.zeros((self.max_slots,), np.int64)
        self._pos = np.zeros((self.max_slots,), np.int32)
        self._decode = make_batched_decode_step(model)
        self._decode_sampled = make_sampling_decode_step(model)
        self._ttft: List[float] = []
        self._tpot: List[float] = []
        self.stats = {"submitted": 0, "completed": 0, "generated_tokens": 0,
                      "prefill_calls": 0, "decode_steps": 0,
                      "prefill_s": 0.0, "decode_s": 0.0,
                      "kv_bytes_in_use": 0, "peak_kv_bytes_in_use": 0,
                      "kv_pages_used": 0,
                      "kv_pages_free": self._pool.pages_free,
                      "prefix_hits": 0, "prefix_tokens_reused": 0,
                      "cow_copies": 0, "reloads": 0, "restore_fallbacks": 0,
                      "transition_ticks": 0, "started_at": None}

    # ------------------------------------------------------- construction
    @classmethod
    def from_config(cls, config, *, model=None, params=None,
                    checkpoint=None, device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None
                    ) -> "ServeEngine":
        """Build model and params from the config, on `device` (`cuda`
        unless the caller says otherwise): with `ckpt_dir`, the params of
        the latest checkpoint (`checkpoint` may pass a shared manager,
        e.g. a training run's, which `hot_reload` then polls); else
        random weights from `generator`."""
        model, params, checkpoint, loaded_step = resolve_serve_parts(
            config, model=model, params=params, checkpoint=checkpoint,
            device=device, generator=generator)
        if loaded_step is not None:
            print(f"[serve] serving checkpoint step {loaded_step} from "
                  f"{checkpoint.root}")
        return cls(config, model, params, checkpoint=checkpoint,
                   loaded_step=loaded_step)

    # ------------------------------------------------------------- params
    def swap_params(self, params: PyTree, step: Optional[int] = None):
        """Hot-swap: new admissions decode with `params`; slots already
        in flight finish on their admitted version."""
        self._version += 1
        self._params[self._version] = params
        self._loaded_step = step
        self.stats["reloads"] += 1
        # registered prefix pages hold K/V computed under the OLD
        # weights — flush them so new admissions re-prefill under the
        # new version (pages still referenced by in-flight old-version
        # slots survive until those slots retire)
        self.flush_prefix()

    def flush_prefix(self) -> int:
        """Release every prefix-index page reference; returns the number
        of pages flushed."""
        n = 0
        if self._prefix is not None:
            while True:
                pid = self._prefix.evict_lru()
                if pid is None:
                    break
                self._pool.release([pid])
                n += 1
        return n

    def _gc_versions(self):
        live = {h.version for h in self.scheduler.active.values()}
        live.add(self._version)
        for v in [v for v in self._params if v not in live]:
            del self._params[v]

    @property
    def params(self) -> PyTree:
        """The params new admissions will see."""
        return self._params[self._version]

    @property
    def loaded_step(self) -> Optional[int]:
        return self._loaded_step

    # ------------------------------------------------------------- submit
    def submit(self, request: GenerationRequest) -> RequestHandle:
        """Enqueue a request; a later `step()` admits it to a slot.
        Raises immediately if it can never fit a slot."""
        handle = RequestHandle(request)
        self.scheduler.submit(handle)
        self.stats["submitted"] += 1
        if self.stats["started_at"] is None:
            self.stats["started_at"] = time.perf_counter()
        return handle

    # --------------------------------------------------------------- tick
    def step(self) -> bool:
        """One scheduler tick: admit (paged reservation, fused prefill,
        shared prefixes prefill only the unshared tail) -> one batched
        decode over the active slots (page growth / COW first) -> retire
        finished. Returns True while queued or in-flight work remains."""
        if self._reloader is not None:
            # synchronous, as the reference's: a poll that finds a new step
            # reads and checks the whole checkpoint before this tick admits
            # or decodes, and a shared async manager first drains its write
            got = self._reloader.poll()
            if got is not None:
                self.swap_params(got[1], step=got[0])
            self.stats["restore_fallbacks"] = self._reloader.fallbacks
        admitted = self.scheduler.admit(self._reserve_pages)
        if admitted:
            self._admit_batch(admitted)
        if self.scheduler.active:
            self._decode_tick()
        self._gc_versions()
        used = self._pool.pages_used
        b = used * self._page_bytes
        self.stats["kv_bytes_in_use"] = b
        self.stats["peak_kv_bytes_in_use"] = max(
            self.stats["peak_kv_bytes_in_use"], b)
        self.stats["kv_pages_used"] = used
        self.stats["kv_pages_free"] = self._pool.pages_free
        return self.scheduler.has_work

    def drain(self) -> None:
        """Run ticks until every submitted request is done."""
        while self.step():
            pass

    def leaked_pages(self) -> int:
        """Pages the pool holds that no active slot and no prefix-index
        entry accounts for (0 is the invariant)."""
        pids = set()
        for slot in self.scheduler.active:
            mask = self._owned[slot] | self._shared[slot]
            pids.update(int(p) for p in self._tables[slot][mask])
        if self._prefix is not None:
            pids.update(self._prefix.pages())
        return self._pool.pages_used - len(pids)

    # ------------------------------------------------------ paged plumbing
    def _prompt_pages(self, n_tokens: int) -> int:
        """Pages the prefill of an n-token prompt touches (rolling SWA
        prompts longer than the window only ever occupy the window)."""
        return min(-(-n_tokens // self._page_size), self._pages_per_slot)

    def _evict_until(self, n_free: int) -> bool:
        """Drop cold prefix-index entries (LRU) until `n_free` pages are
        available; only pages nothing else references are candidates."""
        while self._pool.pages_free < n_free:
            if self._prefix is None:
                return False
            pid = self._prefix.evict_lru(
                lambda p: self._pool.refcount(p) == 1)
            if pid is None:
                return False
            self._pool.release([pid])
        return True

    def _reserve_pages(self, handle) -> bool:
        """Admission gate + reservation: match the prompt against the
        prefix index (read-only reuse), then allocate pages for the
        unshared tail, evicting cold prefix pages if needed. Declines
        (request stays queued, FIFO) when the pool cannot cover it."""
        prompt = handle.request.prompt
        shared: List[int] = []
        if self._prefix is not None:
            shared = self._prefix.match(prompt)[:self._pages_per_slot]
        # pin the matched pages FIRST, so evicting their index entries
        # cannot free them and hand one back as this slot's own page
        self._pool.ref(shared)
        n_own = self._prompt_pages(len(prompt)) - len(shared)
        own = self._pool.alloc(n_own) if self._evict_until(n_own) else None
        if own is None:
            self._pool.release(shared)
            return False
        if self._prefix is not None:
            # register this prompt's own full pages at reservation, so a
            # same-tick co-arrival with the same prefix matches them and
            # prefills only its tail; admission-group order puts the
            # leader's prefill before any follower gathers the prefix
            newly = self._prefix.register(prompt, own, start=len(shared))
            self._pool.ref(newly)
        handle._admit_plan = (prompt, shared, own)
        return True

    def _release_slot_pages(self, slot: int):
        """Drop this slot's page references (owned AND shared); pages
        the prefix index still holds survive for future reuse."""
        mask = self._owned[slot] | self._shared[slot]
        if mask.any():
            self._pool.release(self._tables[slot][mask].tolist())
        self._tables[slot] = 0
        self._owned[slot] = False
        self._shared[slot] = False
        self._tables_dirty = True

    def _claim_page(self, slot: int, lp: int):
        """Make logical page `lp` of `slot` writable: a fresh page
        (growth) or a copy-on-write of a shared one."""
        if not (self._evict_until(1) and self._pool.pages_free >= 1):
            raise RuntimeError(
                f"page pool exhausted growing slot {slot} "
                f"(kv_pages={self._num_pages}): no evictable prefix pages")
        if self._shared[slot, lp]:
            old = int(self._tables[slot, lp])
            new = self._pool.cow(old)       # cannot fail: a page is free
            copy_pages(self.cache,
                       torch.tensor([old], device=self.device),
                       torch.tensor([new], device=self.device))
            self._shared[slot, lp] = False
            self.stats["cow_copies"] += 1
        else:
            (new,) = self._pool.alloc(1)
        self._tables[slot, lp] = new
        self._owned[slot, lp] = True
        self._tables_dirty = True

    def _grow_active(self):
        """Before a decode tick every active slot must own the page its
        next token writes into."""
        cap = self._pages_per_slot * self._page_size
        rolling = self.model.cfg.sliding_window > 0
        for slot in sorted(self.scheduler.active):
            p = int(self._host_pos[slot])
            row = p % cap if rolling else min(p, cap - 1)
            lp = row // self._page_size
            if not self._owned[slot, lp]:
                self._claim_page(slot, lp)

    def _sync_tables(self):
        if self._tables_dirty:
            set_page_tables(self.cache, torch.from_numpy(self._tables))
            self._tables_dirty = False

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ----------------------------------------------------------- internals
    def _admit_batch(self, admitted):
        """Fused prefill for this tick's admissions, grouped by prompt
        bucket and shared-prefix chain: one prefill + one arena scatter
        per group. Shared-prefix groups gather the prefix K/V from its
        pages once and prefill only the unshared tail."""
        groups: Dict[Any, list] = {}
        plans: Dict[int, Any] = {}
        for slot, handle in admitted:
            handle.version = self._version
            req = handle.request
            self._temp[slot] = req.temperature
            self._topk[slot] = req.top_k
            self._topp[slot] = req.top_p
            self._seeds[slot] = req.sampling_seed
            self._pos[slot] = 0
            prompt, shared, own = handle._admit_plan
            del handle._admit_plan
            plans[slot] = prompt
            n_sh = len(shared)
            table = np.zeros((self._pages_per_slot,), np.int32)
            table[:n_sh] = shared
            table[n_sh:n_sh + len(own)] = own
            self._tables[slot] = table
            self._owned[slot] = False
            self._owned[slot, n_sh:n_sh + len(own)] = True
            self._shared[slot] = False
            self._shared[slot, :n_sh] = True
            # no dirty mark: paged_insert_rows writes this slot's table
            self._host_pos[slot] = len(prompt)
            if n_sh:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_reused"] += n_sh * self._page_size
            tail = prompt[n_sh * self._page_size:]
            # bucket within the capacity left after the prefix: the
            # cache rows land at offset prefix_len
            key = (_bucket(len(tail), self.max_len - n_sh * self._page_size),
                   tuple(shared))
            groups.setdefault(key, []).append((slot, handle))
        for (P, shared), group in groups.items():
            t0 = time.perf_counter()
            n = len(group)
            prefix_len = len(shared) * self._page_size
            toks = np.zeros((n, P), np.int32)
            lengths = np.zeros((n,), np.int32)
            for i, (slot, _) in enumerate(group):
                tail = plans[slot][prefix_len:]
                toks[i, :len(tail)] = tail
                lengths[i] = len(tail)
            if prefix_len:
                pfx = gather_prefix(self.cache,
                                    self._dev(np.asarray(shared, np.int64)))
                logits, rows = self.model.prefill_cache(
                    self.params, self._dev(toks), self._dev(lengths),
                    self.max_len, prefix_kv=pfx, prefix_len=prefix_len)
            else:
                logits, rows = self.model.prefill_cache(
                    self.params, self._dev(toks), self._dev(lengths),
                    self.max_len)
            logits = logits[:, -1, :]
            slots = [slot for slot, _ in group]
            tables = self._tables[slots]
            write_tables = np.where(self._owned[slots], tables, 0)
            paged_insert_rows(self.cache, rows, self._dev(np.asarray(slots)),
                              self._dev(write_tables), self._dev(tables))
            self.stats["prefill_calls"] += 1
            if all(h.request.temperature <= 0 for _, h in group):
                nxt = torch.argmax(logits, dim=-1)
            else:
                nxt = sample_logits(logits, self._seeds[slots],
                                    self._pos[slots], self._temp[slots],
                                    self._topk[slots], self._topp[slots])
            nxt = nxt.tolist()                 # waits for the device
            self.stats["prefill_s"] += time.perf_counter() - t0
            for i, (_, handle) in enumerate(group):
                self._commit(handle, int(nxt[i]))

    def _decode_tick(self):
        t0 = time.perf_counter()
        # every active slot must own its write page before the batch
        # advances (growth / COW)
        self._grow_active()
        self._sync_tables()
        active = dict(self.scheduler.active)       # slot -> handle
        toks = self._dev(self._tokens)
        if any(h.request.temperature > 0 for h in active.values()):
            decode = lambda params, cache: self._decode_sampled(
                params, toks, cache, self._seeds, self._pos, self._temp,
                self._topk, self._topp)
        else:
            decode = lambda params, cache: self._decode(params, toks, cache)
        versions = sorted({h.version for h in active.values()})
        if len(versions) == 1:
            nxt, self.cache = decode(self._params[versions[0]], self.cache)
            nxt = nxt.cpu().numpy()                # waits for the device
        else:
            nxt = self._transition_decode(decode, active, versions)
            self.stats["transition_ticks"] += 1
        self.stats["decode_steps"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0
        for slot in active:
            self._host_pos[slot] += 1
        for slot, handle in active.items():
            self._commit(handle, int(nxt[slot, 0]))

    def _transition_decode(self, decode, active, versions) -> np.ndarray:
        """A tick with slots of several param versions: one pass per
        version. The arenas are written in place, so in each pass every
        slot of another version has its page-table rows pointed at the
        trash page: the pass writes K/V only into its own slots' pages
        (the others' writes land in trash page 0) and their output rows
        are discarded. Positions advance once."""
        att = self.cache.layers["attn"]
        slot_version = np.full((self.max_slots,), -1)
        for slot, h in active.items():
            slot_version[slot] = h.version
        nxt = np.zeros((self.max_slots, 1), np.int32)
        for v in versions:
            mine = slot_version == v
            keep = self._dev(mine)[None, :, None]
            view = type(self.cache)({"attn": att._replace(
                page_table=torch.where(keep, att.page_table,
                                       PagePool.TRASH))})
            out, after = decode(self._params[v], view)
            nxt[mine] = out.cpu().numpy()[mine]    # waits for the device
        self.cache = type(self.cache)(
            {"attn": att._replace(pos=after.layers["attn"].pos)})
        return nxt

    def _commit(self, handle: RequestHandle, token: int):
        """Record one generated token; stream it; retire if finished."""
        handle.tokens.append(token)
        slot = handle.slot
        self._tokens[slot, 0] = token
        # next sample position = tokens generated so far: token t is a
        # pure function of (seed, t) regardless of batch composition
        self._pos[slot] = len(handle.tokens)
        self.stats["generated_tokens"] += 1
        if handle.first_token_at is None:
            handle.first_token_at = time.perf_counter()
        if handle.request.stream is not None:
            handle.request.stream(handle, token)
        reason = self.scheduler.should_retire(handle, token)
        if reason is not None:
            self.scheduler.retire(slot, reason)
            self.stats["completed"] += 1
            if handle.ttft is not None:
                self._ttft.append(handle.ttft)
            if handle.tpot is not None:
                self._tpot.append(handle.tpot)
            self._release_slot_pages(slot)

    # ---------------------------------------------------------- reporting
    def kv_stats(self) -> Dict[str, Any]:
        """KV-memory view of the engine: live/peak bytes, page counts,
        prefix-reuse counters."""
        return {"kv_layout": "paged",
                "kv_bytes_in_use": self.stats["kv_bytes_in_use"],
                "peak_kv_bytes_in_use": self.stats["peak_kv_bytes_in_use"],
                "kv_capacity_bytes": self._kv_capacity_bytes,
                "kv_page_bytes": self._page_bytes,
                "kv_pages_used": self.stats["kv_pages_used"],
                "kv_pages_free": self.stats["kv_pages_free"],
                "prefix_hits": self.stats["prefix_hits"],
                "prefix_tokens_reused": self.stats["prefix_tokens_reused"],
                "cow_copies": self.stats["cow_copies"]}

    def throughput(self) -> Dict[str, float]:
        """Completion/throughput fields (the serve CLI prints these):
        tok/s, the host wall time per prefill group and per decode tick
        (each ends in a device sync), and per-request latency — TTFT
        (submit -> first token) and TPOT (per-token cadence after the
        first), each mean/p50/p99 over completed requests."""
        started = self.stats["started_at"]
        wall = (time.perf_counter() - started) if started else 0.0
        toks = self.stats["generated_tokens"]
        n_pre, n_dec = self.stats["prefill_calls"], self.stats["decode_steps"]
        out = {"completed": self.stats["completed"],
               "submitted": self.stats["submitted"],
               "generated_tokens": toks,
               "decode_steps": n_dec,
               "prefill_calls": n_pre,
               "wall_s": wall,
               "tok_s": toks / wall if wall > 0 else 0.0,
               "prefill_ms_mean": (1e3 * self.stats["prefill_s"] / n_pre
                                   if n_pre else 0.0),
               "decode_tick_ms_mean": (1e3 * self.stats["decode_s"] / n_dec
                                       if n_dec else 0.0),
               "kv_bytes_in_use": self.stats["kv_bytes_in_use"],
               "peak_kv_bytes": self.stats["peak_kv_bytes_in_use"],
               "prefix_hits": self.stats["prefix_hits"],
               "prefix_tokens_reused": self.stats["prefix_tokens_reused"],
               "reloads": self.stats["reloads"],
               "transition_ticks": self.stats["transition_ticks"],
               "restore_fallbacks": self.stats["restore_fallbacks"]}
        for name, samples in (("ttft", self._ttft), ("tpot", self._tpot)):
            if samples:
                arr = np.asarray(samples, np.float64)
                out[f"{name}_mean_s"] = float(arr.mean())
                out[f"{name}_p50_s"] = float(np.percentile(arr, 50))
                out[f"{name}_p99_s"] = float(np.percentile(arr, 99))
        out["kv_pages_used"] = self.stats["kv_pages_used"]
        out["kv_pages_free"] = self.stats["kv_pages_free"]
        return out
