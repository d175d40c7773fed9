"""ServeEngine — request-level serving over EngineConfig (the port of
`repro/engine/serving/engine.py`): the decoder-only text models — dense
GQA, MLA and MoE decoders, the SSM (rwkv) and the hybrid (hymba).
Frontend and encoder-decoder models are refused, as the reference
refuses them; `ServeSession.generate` serves them through its stepped
loop.

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
  * **scan prefill** (`prefill_mode='scan'`, and the only prefill of
    the recurrent families) — the prompt fed through decode steps on a
    dense per-slot cache, a slot whose prompt has ended keeping its
    whole cache, then inserted like a parallel prefill's rows;
  * **paged KV** (the default) — a global page arena sized in
    `page_size`-token pages, addressed through int32 page tables; a
    host-side `PagePool` allocates on admission/growth, frees on
    retirement and copies on write; page-aligned shared prompt prefixes
    map read-only onto the same physical pages and prefill computes only
    the unshared tail (flash kernel with q_offset = prefix length). An
    arena below full provisioning (`kv_pages`) backs admission off and
    preempts the youngest request under pressure (recompute: it
    re-prefills prompt + generated tokens on re-admission);
  * **dense KV** (`kv_layout='dense'`) — per-slot rows at full capacity,
    admitted by a row scatter, decoded by the plain dense attention;
    rwkv (no attention K/V) always serves it, and the hybrid's mamba
    state stays dense per slot beside its paged attention — both with a
    warning, and counted in `kv_stats()['dense_fallback_*']`;
  * **decode** — one batched step per tick (paged: through the
    paged-decode kernel), greedy by default, per-slot sampling when a
    request asks;
  * **speculation** (`speculation_k`) — a draft model over a dense
    per-slot cache proposes k tokens per slot (k+1 draft steps), and ONE
    target verify forward scores all k+1 positions; each slot commits
    its longest matching draft prefix plus the corrected token, and the
    rows beyond it are rolled back by a pos rewrite (paged: the pages
    that hold only rejected rows are returned);
  * **resilience** — per-request deadlines and retry budgets (terminal
    'deadline' / 'retries' finishes), a graceful drain (SIGTERM handler)
    that fails queued requests as 'drained', and an opt-in pressure
    ladder: no speculation -> no admissions -> preempt;
  * **checkpoints** — `from_config` with `ckpt_dir` serves the params of
    the latest checkpoint (a params-only restore by manifest path, in
    the dtype the checkpoint stored); with `hot_reload` a `HotReloader`
    polls the directory each tick and params are versioned: new
    admissions take the newest version, in-flight slots finish on the
    version they were admitted with, and a swap flushes the prefix
    index (its pages hold K/V of the old weights).

The engine is single-threaded and tick-driven (`step()` = deadlines +
reload poll + ladder + admit + one batched decode or speculation tick +
retire). Device state is written in place (see `slots`), so a
transition tick — slots of two param versions live at once — decodes
once per version: paged, with the other versions' slots' page-table
rows pointed at the trash page, so each pass writes K/V only into its
own version's pages; dense, each later version on a copy of the rows,
merged per slot. Each slot keeps the token of its own version's pass.
Rejected speculative rows stay in the caches as garbage, masked by pos
exactly as the reference's are.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.attention import paged_capacity
from repro_torch.models.transformer import PAGED_CACHES, map_nodes
from repro_torch.runtime import DeviceLike, make_generator, resolve_device
from ..build import (make_batched_decode_step, make_draft_propose,
                     make_sampling_decode_step, make_verify_step,
                     sample_logits)
from .reload import HotReloader
from .scheduler import (ContinuousBatchingScheduler, GenerationRequest,
                        PrefixIndex, PressureLadder, RequestHandle)
from .slots import (PagePool, copy_pages, dense_fallback_stats,
                    dense_kv_bytes, gather_prefix, insert_rows_at,
                    paged_insert_rows, paged_kv_page_bytes, select_rows,
                    select_states, set_page_tables, state_copy)

PyTree = Any

_PREFILL_MODES = ("auto", "parallel", "scan")


def effective_kv_layout(config, model_cfg):
    """The cache layout ServeEngine builds for (config, model):
    ('paged' | 'dense', fallback_reason). Recurrent-only families have
    no attention K/V to page, so `kv_layout='paged'` falls back to the
    dense slotted layout there (engine.py:67)."""
    if config.kv_layout != "paged":
        return "dense", ""
    if model_cfg.family == "ssm":
        return "dense", (f"{model_cfg.name} (family=ssm) has no attention "
                         f"K/V to page; serving the dense slotted layout")
    return "paged", ""


def resolve_prefill_mode(config, model) -> str:
    """'parallel' or 'scan' for (config, model), validated as the
    reference does (engine.py:82)."""
    mode = config.prefill_mode
    if mode not in _PREFILL_MODES:
        raise ValueError(f"prefill_mode={mode!r}; one of {_PREFILL_MODES}")
    if mode == "auto":
        mode = "parallel" if model.prefill_cache is not None else "scan"
    if mode == "parallel" and model.prefill_cache is None:
        raise ValueError(
            f"{model.cfg.name} ({model.cfg.family}) has no parallel "
            f"prefill (recurrent state); use prefill_mode='scan'")
    return mode


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


def serve_mesh(config, device: DeviceLike = None):
    """The serving mesh (engine.py:119-122 of the reference): (data_mesh
    or 1, model_mesh) over the cards a process sees, falling back to
    (n, 1) when they are fewer; one card on the CPU."""
    from repro_torch.launch.mesh import make_local_mesh
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return make_local_mesh(config.data_mesh or 1, config.model_mesh, n)


def resolve_serve_parts(config, *, model=None, params=None,
                        checkpoint=None, device: DeviceLike = None,
                        generator: Optional[torch.Generator] = None,
                        mesh=None):
    """arch -> model (its heads padded for the mesh's model size under
    `pad_heads`; `mesh` defaults to `serve_mesh`); a checkpoint manager
    from ckpt_dir; and params — the params-only restore of the latest
    checkpoint when there is one (on `device`), else freshly initialised
    on `device` from `generator` (default: seed 0 on that device).
    Serving stays one process on one device, as the reference's does:
    the mesh pads heads and shards nothing. Returns (model, params,
    checkpoint, loaded_step)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import build_model

    config.validate()
    if mesh is None:
        mesh = serve_mesh(config, device)
    if model is None:
        if not config.arch:
            raise ValueError("EngineConfig.arch is empty — pass a built "
                             "Model via from_config(model=...)")
        model = build_model(config.model_config(mesh.axis_size("model")),
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


def derive_draft_config(target_cfg, spec: Optional[Dict[str, Any]] = None):
    """The draft ModelConfig a speculation-enabled engine builds
    (engine.py:145). `spec` (EngineConfig.draft_config):
      * None — the target at quarter depth, MoE routing dropped;
      * {'arch': preset[, 'reduced': bool, field overrides]} — a preset;
      * {field overrides} — dataclasses.replace over the target config.
    Every form: the draft shares the target's vocab, is an attention
    family (its per-slot cache rolls back by a pos rewrite), and runs
    full attention (sliding_window forced to 0)."""
    import dataclasses as _dc
    from repro_torch.configs.base import get_config, get_reduced
    if spec and "arch" in spec:
        extra = {k: v for k, v in spec.items() if k not in ("arch",
                                                            "reduced")}
        dcfg = (get_reduced(spec["arch"]) if spec.get("reduced")
                else get_config(spec["arch"]))
        if extra:
            dcfg = _dc.replace(dcfg, **extra)
    elif spec:
        dcfg = _dc.replace(target_cfg, **spec)
    else:
        dcfg = _dc.replace(target_cfg,
                           name=f"{target_cfg.name}-draft",
                           n_layers=max(1, target_cfg.n_layers // 4),
                           n_experts=0, n_experts_per_tok=0,
                           n_shared_experts=0, first_dense_layers=0)
    if dcfg.sliding_window:
        dcfg = _dc.replace(dcfg, sliding_window=0)
    if dcfg.family in ("ssm", "hybrid") or dcfg.is_encoder_decoder:
        raise ValueError(
            f"draft model {dcfg.name} (family={dcfg.family}) cannot "
            f"draft for speculation: recurrent/enc-dec state has no "
            f"pos-rewrite rollback — pick an attention-family draft")
    if dcfg.vocab_size != target_cfg.vocab_size:
        raise ValueError(
            f"draft vocab_size={dcfg.vocab_size} != target vocab_size="
            f"{target_cfg.vocab_size} ({target_cfg.name}): draft "
            f"proposals must be target token ids")
    return dcfg


def _make_parallel_prefill(model, cap: int):
    """(params, tokens [n,P], lengths [n]) -> (last-position logits
    [n,V], dense rows): one fused forward."""
    def prefill(params, tokens, lengths):
        logits, rows = model.prefill_cache(params, tokens, lengths, cap)
        return logits[:, -1, :], rows
    return prefill


def _make_scan_prefill(model, cap: int):
    """Stepped prefill (engine.py:229): the prompts fed one position at
    a time through decode steps on a fresh dense per-slot cache — the
    math of sequential decode. A slot whose prompt has ended keeps its
    old recurrent state and positions, as the reference's keeps its whole
    old cache (`select_rows`): its step still runs, and an RWKV or mamba
    state would otherwise absorb the pad token. Its attention rows are
    not restored: the step's row at the kept pos is masked, and the
    slot's next decode overwrites it. Returns the logits at each prompt's
    last position [n,V] fp32 and the rows."""
    def prefill(params, tokens, lengths):
        B, P = tokens.shape
        cache = model.init_cache(params, B, cap, per_slot=True)
        last = torch.zeros((B, model.cfg.vocab_size), dtype=torch.float32,
                           device=tokens.device)
        shortest = int(lengths.min())
        for t in range(P):
            # until the shortest prompt ends every slot takes the step;
            # after, the ended slots' state is kept aside first (the
            # step writes in place)
            old = None if t < shortest else state_copy(cache)
            logits, cache = model.decode_step(params, tokens[:, t:t + 1],
                                              cache)
            if old is not None:
                cache = select_states(t < lengths, cache, old)
            last = torch.where((t == lengths - 1)[:, None],
                               logits[:, -1, :].float(), last)
        return last, cache
    return prefill


class ServeEngine:
    """Continuous-batching serving engine for one (model, params)."""

    def __init__(self, config, model, params: PyTree, *, checkpoint=None,
                 loaded_step: Optional[int] = None,
                 draft_params: Optional[PyTree] = None):
        config.validate()
        cfg = model.cfg
        if cfg.is_encoder_decoder or cfg.frontend != "none":
            raise ValueError(
                f"ServeEngine serves decoder-only text models; "
                f"{cfg.name} (frontend={cfg.frontend}, "
                f"enc-dec={cfg.is_encoder_decoder}) still goes through "
                f"ServeSession.generate(stepped_prefill=True)")
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
        mode = self.prefill_mode = resolve_prefill_mode(config, model)
        layout, fallback_reason = effective_kv_layout(config, cfg)
        self.paged = layout == "paged"
        if fallback_reason:
            import warnings
            from ..build import EngineWarning
            warnings.warn(fallback_reason, EngineWarning, stacklevel=2)
        self._pool = None
        self._prefix = None
        if self.paged:
            ps = config.page_size
            cap = paged_capacity(cfg, self.max_len)
            if cap % ps:
                raise ValueError(
                    f"{cfg.name}: paged cache capacity {cap} (sliding "
                    f"window {cfg.sliding_window}) is not a multiple of "
                    f"page_size={ps}; pick a page size dividing the window "
                    f"(kv_layout='dense' always works)")
            self._page_size = ps
            self._pages_per_slot = cap // ps
            # full provisioning: every slot at capacity + the trash page;
            # kv_pages sizes the arena down (backpressure + preemption)
            # or up (a larger warm prefix cache)
            full = self.max_slots * self._pages_per_slot + 1
            self._num_pages = config.kv_pages or full
            if self._num_pages < self._pages_per_slot + 1:
                raise ValueError(
                    f"kv_pages={self._num_pages} cannot hold even one full "
                    f"slot: capacity {cap} needs {self._pages_per_slot} "
                    f"pages of {ps} tokens plus the reserved trash page "
                    f"(>= {self._pages_per_slot + 1})")
            self._pool = PagePool(self._num_pages, ps)
            share = (config.prefix_sharing and mode == "parallel"
                     and not cfg.sliding_window)
            self._prefix = PrefixIndex(ps) if share else None
            self._tables = np.zeros((self.max_slots, self._pages_per_slot),
                                    np.int32)
            self._owned = np.zeros_like(self._tables, bool)
            self._shared = np.zeros_like(self._tables, bool)
            self._tables_dirty = False
            self._host_pos = np.zeros((self.max_slots,), np.int64)
            self._admit_seq = np.zeros((self.max_slots,), np.int64)
            self._seq = 0
            self.cache = model.init_cache(params, self.max_slots,
                                          self.max_len,
                                          paged=(ps, self._num_pages))
            self._page_bytes = paged_kv_page_bytes(self.cache)
            self._kv_capacity_bytes = (self._num_pages - 1) * self._page_bytes
        else:
            self.cache = model.init_cache(params, self.max_slots,
                                          self.max_len, per_slot=True)
            self._page_bytes = 0
            self._kv_capacity_bytes = dense_kv_bytes(self.cache)
        # paged-accounting honesty: per-slot state that stays dense though
        # paging was asked for (the hybrid's mamba state; the whole cache
        # under the ssm fallback), surfaced in kv_stats (engine.py:451)
        self._dense_fallback_leaves = self._dense_fallback_bytes = 0
        if config.kv_layout == "paged":
            self._dense_fallback_leaves, self._dense_fallback_bytes = \
                dense_fallback_stats(self.cache)
            if self.paged and self._dense_fallback_leaves:
                import warnings
                from ..build import EngineWarning
                warnings.warn(
                    f"{cfg.name}: {self._dense_fallback_leaves} cache "
                    f"leaves ({self._dense_fallback_bytes} bytes) stay "
                    f"dense per-slot under kv_layout='paged' (recurrent "
                    f"state has no K/V rows to page); paged byte "
                    f"accounting excludes them — see "
                    f"kv_stats()['dense_fallback_leaves']",
                    EngineWarning, stacklevel=2)
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
        self._prefill = (_make_parallel_prefill(model, self.max_len)
                         if mode == "parallel"
                         else _make_scan_prefill(model, self.max_len))
        # ---- speculative decoding: draft propose -> one-forward verify
        self.spec_k = int(config.speculation_k or 0)
        self._draft_model = None
        if self.spec_k and model.verify_step is None:
            import warnings
            from ..build import EngineWarning
            warnings.warn(
                f"{cfg.name} (family={cfg.family}): recurrent state has "
                f"no pos-rewrite rollback — speculation disabled, every "
                f"tick runs plain decode", EngineWarning, stacklevel=2)
            self.spec_k = 0
        if self.spec_k:
            from repro_torch.models import build_model
            dcfg = derive_draft_config(cfg, config.draft_config)
            self._draft_model = build_model(
                dcfg, param_dtype=getattr(torch, config.param_dtype),
                attn_impl=model.attn_impl)
            self._draft_params = (
                draft_params if draft_params is not None
                else self._draft_model.init(make_generator(self.device, 1),
                                            device=self.device))
            # the draft cache is DENSE per-slot: drafts are small, their
            # rows transient (healed by the next propose's pos rewrite)
            self._draft_cache = self._draft_model.init_cache(
                self._draft_params, self.max_slots, self.max_len,
                per_slot=True)
            self._draft_prefill = _make_parallel_prefill(self._draft_model,
                                                         self.max_len)
            self._propose = make_draft_propose(self._draft_model,
                                               self.spec_k)
            self._verify = make_verify_step(model)
            # spec-tick ceiling: pos + k stays below the rolling capacity
            # for every active slot, so verify rows are exactly pos + t
            # (no wrap, no clamp) and rollback is a pos rewrite
            self._spec_cap = paged_capacity(cfg, self.max_len)
        self._ttft: List[float] = []
        self._tpot: List[float] = []
        # graceful degradation (opt-in): the ladder watches page-pool and
        # queue pressure each tick and sheds load in stages
        self._ladder = PressureLadder() if config.pressure_ladder else None
        self._draining = False
        self.stats = {"submitted": 0, "completed": 0, "generated_tokens": 0,
                      "prefill_calls": 0, "decode_steps": 0,
                      "prefill_s": 0.0, "decode_s": 0.0,
                      "kv_bytes_in_use": 0, "peak_kv_bytes_in_use": 0,
                      "kv_pages_used": 0,
                      "kv_pages_free": (self._pool.pages_free
                                        if self._pool else 0),
                      "prefix_hits": 0, "prefix_tokens_reused": 0,
                      "cow_copies": 0, "preemptions": 0,
                      "spec_ticks": 0, "spec_tokens_proposed": 0,
                      "spec_tokens_accepted": 0, "draft_prefills": 0,
                      "failed": 0, "deadline_kills": 0, "retries": 0,
                      "drained": 0, "degradation_level": 0,
                      "degradation_changes": 0, "ladder_preempts": 0,
                      "reloads": 0, "restore_fallbacks": 0,
                      "transition_ticks": 0, "started_at": None}
        if not self.paged:
            # dense slots pay full capacity up front: that constant IS
            # the footprint (what paging exists to beat)
            self.stats["kv_bytes_in_use"] = self._kv_capacity_bytes
            self.stats["peak_kv_bytes_in_use"] = self._kv_capacity_bytes

    # ------------------------------------------------------- construction
    @classmethod
    def from_config(cls, config, *, model=None, params=None,
                    checkpoint=None, device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None,
                    draft_params: Optional[PyTree] = None, mesh=None
                    ) -> "ServeEngine":
        """Build model and params from the config, on `device` (`cuda`
        unless the caller says otherwise): with `ckpt_dir`, the params of
        the latest checkpoint (`checkpoint` may pass a shared manager,
        e.g. a training run's, which `hot_reload` then polls); else
        random weights from `generator`. `draft_params`: weights of the
        speculation draft (default: random, from a generator seeded 1 —
        correct tokens, low acceptance). `mesh`: as `resolve_serve_parts`
        takes it."""
        model, params, checkpoint, loaded_step = resolve_serve_parts(
            config, model=model, params=params, checkpoint=checkpoint,
            device=device, generator=generator, mesh=mesh)
        if loaded_step is not None:
            print(f"[serve] serving checkpoint step {loaded_step} from "
                  f"{checkpoint.root}")
        return cls(config, model, params, checkpoint=checkpoint,
                   loaded_step=loaded_step, draft_params=draft_params)

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
        """One scheduler tick: deadline enforcement -> hot-reload poll
        -> pressure-ladder update -> admit (paged reservation, fused
        prefill, shared prefixes prefill only the unshared tail) -> one
        speculation tick or one batched decode over the active slots
        (page growth / COW first) -> retire finished. Returns True while
        queued or in-flight work remains."""
        self._enforce_deadlines()
        if self._reloader is not None:
            # synchronous, as the reference's: a poll that finds a new step
            # reads and checks the whole checkpoint before this tick admits
            # or decodes, and a shared async manager first drains its write
            got = self._reloader.poll()
            if got is not None:
                self.swap_params(got[1], step=got[0])
            self.stats["restore_fallbacks"] = self._reloader.fallbacks
        level = 0
        if self._ladder is not None:
            free_frac = 1.0
            if self.paged:
                free_frac = (self._pool.pages_free
                             / max(1, self._num_pages - 1))
            level = self._ladder.update(
                free_frac=free_frac, queue_len=len(self.scheduler.queue),
                max_slots=self.max_slots)
            self.stats["degradation_level"] = level
            self.stats["degradation_changes"] = self._ladder.changes
        # admissions stop while draining, and at ladder level >= 2 while
        # anything is in flight (an empty active set must still admit —
        # pausing then would deadlock the queue against a full pool)
        blocked = self._draining or (level >= 2 and self.scheduler.active)
        if not blocked:
            admitted = self.scheduler.admit(
                self._reserve_pages if self.paged else None)
            if admitted:
                self._admit_batch(admitted)
        if (level >= 3 and self.paged and self._pool.pages_free == 0
                and len(self.scheduler.active) > 1):
            # preempt-by-recompute rung: free the youngest slot's pages
            # so the older slots can keep growing
            if self._preempt_youngest(None):
                self.stats["ladder_preempts"] += 1
        if self.scheduler.active:
            self._decode_tick()
        if self._draining and not self.scheduler.active:
            # active set drained: queued requests end terminally (never
            # hung) with finish_reason 'drained'
            for h in list(self.scheduler.queue):
                self.scheduler.fail(h, "drained")
                self.stats["failed"] += 1
                self.stats["drained"] += 1
        self._gc_versions()
        if self.paged:
            used = self._pool.pages_used
            b = used * self._page_bytes
            self.stats["kv_bytes_in_use"] = b
            self.stats["peak_kv_bytes_in_use"] = max(
                self.stats["peak_kv_bytes_in_use"], b)
            self.stats["kv_pages_used"] = used
            self.stats["kv_pages_free"] = self._pool.pages_free
        return self.scheduler.has_work

    def drain(self) -> None:
        """Run ticks until every submitted request is terminal."""
        while self.step():
            pass

    # --------------------------------------------------------- resilience
    def _enforce_deadlines(self):
        """Fail every queued or running request past its deadline_s
        budget (terminal finish_reason 'deadline'; a running slot's pages
        are released first). Requests without a deadline are untouched."""
        now = time.perf_counter()
        for h in self.scheduler.expired(now):
            if h.slot is not None and self.paged:
                self._release_slot_pages(h.slot)
            self.scheduler.fail(h, "deadline")
            self.stats["deadline_kills"] += 1
            self.stats["failed"] += 1

    def request_drain(self):
        """Graceful drain (SIGTERM): no new admissions; in-flight slots
        decode to completion; once the active set empties, queued
        requests fail terminally with finish_reason 'drained'."""
        self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    def install_drain_handler(self):
        """SIGTERM => request_drain(). The process keeps running until
        the caller's drain loop ends."""
        import signal

        def handler(signum, frame):
            print("[serve] SIGTERM: draining (no new admissions; "
                  "in-flight requests finish)")
            self.request_drain()
        signal.signal(signal.SIGTERM, handler)

    def leaked_pages(self) -> int:
        """Pages the pool holds that no active slot and no prefix-index
        entry accounts for (0 is the invariant; the dense layout has no
        pool)."""
        if not self.paged:
            return 0
        pids = set()
        for slot in self.scheduler.active:
            mask = self._owned[slot] | self._shared[slot]
            pids.update(int(p) for p in self._tables[slot][mask])
        if self._prefix is not None:
            pids.update(self._prefix.pages())
        return self._pool.pages_used - len(pids)

    def close(self):
        """Close the checkpoint manager the engine serves from (an async
        manager drains its writer first)."""
        close = getattr(self.checkpoint, "close", None)
        if close is not None:
            close()

    # ------------------------------------------------------ paged plumbing
    def _full_prompt(self, handle) -> np.ndarray:
        """Prompt plus any already generated tokens: a preempted request
        re-prefills its whole trajectory (recompute preemption)."""
        if not handle.tokens:
            return handle.request.prompt
        return np.concatenate([handle.request.prompt,
                               np.asarray(handle.tokens, np.int32)])

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
        prompt = self._full_prompt(handle)
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

    def _preempt_youngest(self, keep_slot: Optional[int]) -> bool:
        """Pool pressure: push the most recently admitted request (other
        than `keep_slot`) back to the queue front, freeing its pages. It
        re-prefills prompt + generated on re-admission, on the CURRENT
        param version. Over its `max_retries` budget it fails terminally
        instead (finish_reason 'retries')."""
        others = [s for s in self.scheduler.active if s != keep_slot]
        if not others:
            return False
        victim = max(others, key=lambda s: self._admit_seq[s])
        handle = self.scheduler.active[victim]
        self._release_slot_pages(victim)
        self.scheduler.preempt(victim)
        self.stats["preemptions"] += 1
        if handle.failed:
            self.stats["failed"] += 1
        else:
            self.stats["retries"] += 1
        return True

    def _claim_page(self, slot: int, lp: int):
        """Make logical page `lp` of `slot` writable: a fresh page
        (growth) or a copy-on-write of a shared one, evicting cold
        prefix pages and then preempting younger requests under
        pressure."""
        while not (self._evict_until(1) and self._pool.pages_free >= 1):
            if not self._preempt_youngest(slot):
                raise RuntimeError(
                    f"page pool exhausted growing slot {slot} "
                    f"(kv_pages={self._num_pages}): no evictable prefix "
                    f"pages and no other request to preempt")
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
        next token writes into (may preempt, shrinking the active set)."""
        cap = self._pages_per_slot * self._page_size
        rolling = self.model.cfg.sliding_window > 0
        for slot in sorted(self.scheduler.active):
            if slot not in self.scheduler.active:   # preempted meanwhile
                continue
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
        """Prefill this tick's admissions, grouped by prompt bucket (and,
        paged, by shared-prefix chain): one prefill + one cache scatter
        per group. Shared-prefix groups gather the prefix K/V from its
        pages once and prefill only the unshared tail. With speculation,
        the draft prefills each full prompt into its dense cache first."""
        groups: Dict[Any, list] = {}
        plans: Dict[int, Any] = {}
        for slot, handle in admitted:
            handle.version = self._version
            req = handle.request
            self._temp[slot] = req.temperature
            self._topk[slot] = req.top_k
            self._topp[slot] = req.top_p
            self._seeds[slot] = req.sampling_seed
            # the sampling position continues across preemption: token t
            # is a function of (seed, t)
            self._pos[slot] = len(handle.tokens)
            if self.paged:
                prompt, shared, own = handle._admit_plan
                del handle._admit_plan
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
                self._admit_seq[slot] = self._seq = self._seq + 1
                if n_sh:
                    self.stats["prefix_hits"] += 1
                    self.stats["prefix_tokens_reused"] += (
                        n_sh * self._page_size)
                # bucket within the capacity left after the prefix: the
                # cache rows land at offset prefix_len
                key = (_bucket(len(prompt) - n_sh * self._page_size,
                               self.max_len - n_sh * self._page_size),
                       tuple(shared))
            else:
                prompt = self._full_prompt(handle)
                key = (_bucket(len(prompt), self.max_len), ())
            plans[slot] = prompt
            groups.setdefault(key, []).append((slot, handle))
        if self._draft_model is not None:
            # the draft prefills the FULL prompt (plus the generated tokens
            # of a preempted re-admission) into its dense cache, before
            # the target commits its first token, so both stand at the
            # same position. No prefix sharing: the draft has no arena.
            dgroups: Dict[int, list] = {}
            for slot, _ in admitted:
                fp = plans[slot]
                dgroups.setdefault(_bucket(len(fp), self.max_len),
                                   []).append((slot, fp))
            for P, dgroup in dgroups.items():
                toks = np.zeros((len(dgroup), P), np.int32)
                lengths = np.zeros((len(dgroup),), np.int32)
                for i, (_, fp) in enumerate(dgroup):
                    toks[i, :len(fp)] = fp
                    lengths[i] = len(fp)
                _, rows = self._draft_prefill(self._draft_params,
                                              self._dev(toks),
                                              self._dev(lengths))
                insert_rows_at(self._draft_cache, rows,
                               self._dev(np.asarray([s for s, _ in dgroup])))
                self.stats["draft_prefills"] += 1
        params = self._params[self._version]
        for (P, shared), group in groups.items():
            t0 = time.perf_counter()
            n = len(group)
            prefix_len = len(shared) * self._page_size if self.paged else 0
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
                    params, self._dev(toks), self._dev(lengths),
                    self.max_len, prefix_kv=pfx, prefix_len=prefix_len)
                logits = logits[:, -1, :]
            else:
                logits, rows = self._prefill(params, self._dev(toks),
                                             self._dev(lengths))
            slots = [slot for slot, _ in group]
            if self.paged:
                tables = self._tables[slots]
                write_tables = np.where(self._owned[slots], tables, 0)
                paged_insert_rows(self.cache, rows,
                                  self._dev(np.asarray(slots)),
                                  self._dev(write_tables), self._dev(tables))
            else:
                insert_rows_at(self.cache, rows, self._dev(np.asarray(slots)))
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

    # ------------------------------------------------- speculative decoding
    def _can_speculate(self) -> bool:
        """Host-side spec-tick preconditions; any miss makes THIS tick a
        plain decode: the ladder below level 1, one live param version,
        all-greedy slots, and pos + k < capacity for every active slot
        (verify rows are exactly pos + t, rollback a pos rewrite)."""
        if self._ladder is not None and self._ladder.level >= 1:
            return False
        active = self.scheduler.active
        if not active:
            return False
        if len({h.version for h in active.values()}) != 1:
            return False
        k = self.spec_k
        for h in active.values():
            if h.request.temperature > 0:
                return False
            # rows in cache = prompt + generated - 1 (the last committed
            # token's K/V lands when it is fed); verify writes k+1 more
            rows = len(h.request.prompt) + len(h.tokens) - 1
            if rows + k >= self._spec_cap:
                return False
        return True

    def _grow_spec(self, k: int) -> Dict[int, list]:
        """Claim every page the verify may write (rows pos..pos+k per
        active slot; fresh page, or COW of a shared one, preempting under
        pressure like plain growth). Each claim records (logical page,
        previous table entry, was-shared) so `_rollback_spec` can return
        pages that end up holding only rejected rows. A slot preempted by
        a later claim has its pages released already; its entries are
        never applied."""
        ps = self._page_size
        undo: Dict[int, list] = {}
        for slot in sorted(self.scheduler.active):
            if slot not in self.scheduler.active:   # preempted meanwhile
                continue
            p = int(self._host_pos[slot])
            for lp in range(p // ps, (p + k) // ps + 1):
                if not self._owned[slot, lp]:
                    undo.setdefault(slot, []).append(
                        (lp, int(self._tables[slot, lp]),
                         bool(self._shared[slot, lp])))
                    self._claim_page(slot, lp)
        return undo

    def _rollback_spec(self, entries, slot: int, last_row: int):
        """Undo this tick's page claims that hold ONLY rejected rows
        (logical pages strictly beyond `last_row`, the row of the last
        committed token): release the page and restore the pre-claim
        entry — trash for growth, the read-only original for a COW'd
        shared page (never written; the copy holds only rejected rows).
        Device tables re-sync on the next tick."""
        ps = self._page_size
        for lp, old_pid, old_shared in entries:
            if lp * ps > last_row:
                self._pool.release([int(self._tables[slot, lp])])
                self._tables[slot, lp] = old_pid
                self._owned[slot, lp] = False
                self._shared[slot, lp] = old_shared
                if old_shared:
                    self._pool.ref([old_pid])
                self._tables_dirty = True

    def _spec_tick(self) -> bool:
        """One speculation tick: the draft proposes k tokens per slot
        (k+1 draft steps on its dense cache, healing last tick's overrun
        by the pos rewrite), the target scores all k+1 positions in ONE
        verify forward, and each slot commits its longest draft prefix
        matching the target's greedy argmax plus the corrected token:
        1..k+1 tokens for one target forward. Returns False when the
        preconditions fail (the caller runs a plain tick)."""
        if not self._can_speculate():
            return False
        k = self.spec_k
        undo: Dict[int, list] = {}
        if self.paged:
            undo = self._grow_spec(k)       # may preempt under pressure
            self._sync_tables()
        active = dict(self.scheduler.active)
        if not active:                      # growth preempted everything
            return True
        p_vec = np.zeros((self.max_slots,), np.int32)
        for slot, h in active.items():
            # K/V rows in cache == the device pos (see _can_speculate)
            p_vec[slot] = len(h.request.prompt) + len(h.tokens) - 1
        version = next(iter({h.version for h in active.values()}))
        toks = self._dev(self._tokens)
        drafts, self._draft_cache = self._propose(
            self._draft_params, toks, self._draft_cache, self._dev(p_vec))
        spec_toks = torch.cat([toks, drafts], dim=1)           # [B, k+1]
        _, g, acc, self.cache = self._verify(self._params[version],
                                             spec_toks, self.cache)
        g = g.cpu().numpy()                    # waits for the device
        acc = acc.cpu().numpy()
        self.stats["decode_steps"] += 1        # ONE target forward
        self.stats["spec_ticks"] += 1
        for slot, handle in active.items():
            a = int(acc[slot])
            self.stats["spec_tokens_proposed"] += k
            self.stats["spec_tokens_accepted"] += a
            handle.spec_proposed += k
            handle.spec_accepted += a
            if self.paged:
                self._host_pos[slot] += a + 1
            for t in range(a + 1):
                self._commit(handle, int(g[slot, t]))
                if handle.done:
                    # EOS/budget inside the accepted run: later tokens are
                    # discarded; the slot's pages are released already
                    break
            if self.paged and not handle.done:
                self._rollback_spec(undo.get(slot, ()), slot,
                                    int(p_vec[slot]) + a)
        return True

    def _decode_tick(self):
        t0 = time.perf_counter()
        if not (self.spec_k and self._spec_tick()):
            self._plain_tick()
        self.stats["decode_s"] += time.perf_counter() - t0

    def _plain_tick(self):
        if self.paged:
            # every active slot must own its write page before the batch
            # advances (growth / COW; may preempt under pool pressure)
            self._grow_active()
            self._sync_tables()
        active = dict(self.scheduler.active)       # slot -> handle
        if not active:                             # all preempted
            return
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
        if self.paged:
            for slot in active:
                self._host_pos[slot] += 1
        for slot, handle in active.items():
            self._commit(handle, int(nxt[slot, 0]))

    def _transition_decode(self, decode, active, versions) -> np.ndarray:
        """A tick with slots of several param versions: one pass per
        version, each slot keeping its own version's token, K/V and
        recurrent state. Paged: in each pass every slot of another
        version has its page-table rows pointed at the trash page, so the
        pass writes K/V only into its own slots' pages; the recurrent
        states (dense per slot) of every pass after the first start from
        a copy of the tick's starting states and merge per slot. Dense:
        every pass after the first decodes a copy of the whole cache,
        merged per slot (`select_rows`). Positions advance once."""
        slot_version = np.full((self.max_slots,), -1)
        for slot, h in active.items():
            slot_version[slot] = h.version
        nxt = np.zeros((self.max_slots, 1), np.int32)
        clone = lambda n: type(n)(*(t.clone() for t in n))
        if not self.paged:
            copies = {v: map_nodes(clone, self.cache) for v in versions[1:]}
            out, merged = decode(self._params[versions[0]], self.cache)
            mine = slot_version == versions[0]
            nxt[mine] = out.cpu().numpy()[mine]
            for v in versions[1:]:
                out, after = decode(self._params[v], copies.pop(v))
                mine = slot_version == v
                merged = select_rows(self._dev(mine), after, merged)
                nxt[mine] = out.cpu().numpy()[mine]
            self.cache = merged
            return nxt
        paged = lambda n: isinstance(n, PAGED_CACHES)
        start = map_nodes(lambda n: n if paged(n) else clone(n), self.cache)
        merged = None
        for i, v in enumerate(versions):
            mine = slot_version == v
            keep = self._dev(mine)[None, :, None]
            view = map_nodes(
                lambda n, s0: n._replace(page_table=torch.where(
                    keep, n.page_table, PagePool.TRASH)) if paged(n)
                else (n if i == 0 else clone(s0)), self.cache, start)
            out, after = decode(self._params[v], view)
            nxt[mine] = out.cpu().numpy()[mine]    # waits for the device
            merged = after if merged is None else select_states(
                self._dev(mine), after, merged)
        self.cache = map_nodes(
            lambda n, a, m: n._replace(pos=a.pos) if paged(n) else m,
            self.cache, after, merged)
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
            if self.paged:
                self._release_slot_pages(slot)

    # ---------------------------------------------------------- reporting
    def kv_stats(self) -> Dict[str, Any]:
        """KV-memory view of the engine: live/peak bytes, page counts,
        prefix-reuse, pressure and speculation counters. The dense
        layout reports its constant full-capacity footprint."""
        proposed = self.stats["spec_tokens_proposed"]
        return {"kv_layout": "paged" if self.paged else "dense",
                "dense_fallback_leaves": self._dense_fallback_leaves,
                "dense_fallback_bytes": self._dense_fallback_bytes,
                "kv_bytes_in_use": self.stats["kv_bytes_in_use"],
                "peak_kv_bytes_in_use": self.stats["peak_kv_bytes_in_use"],
                "kv_capacity_bytes": self._kv_capacity_bytes,
                "kv_page_bytes": self._page_bytes,
                "kv_pages_used": self.stats["kv_pages_used"],
                "kv_pages_free": self.stats["kv_pages_free"],
                "prefix_hits": self.stats["prefix_hits"],
                "prefix_tokens_reused": self.stats["prefix_tokens_reused"],
                "cow_copies": self.stats["cow_copies"],
                "preemptions": self.stats["preemptions"],
                "spec_ticks": self.stats["spec_ticks"],
                "spec_tokens_proposed": proposed,
                "spec_tokens_accepted": self.stats["spec_tokens_accepted"],
                "spec_acceptance_rate": (
                    self.stats["spec_tokens_accepted"] / proposed
                    if proposed else 0.0)}

    def throughput(self) -> Dict[str, float]:
        """Completion/throughput fields (the serve CLI prints these):
        tok/s, the host wall time per prefill group and per decode tick
        (each ends in a device sync), the resilience counters, per-
        request latency — TTFT (submit -> first token) and TPOT (per-token
        cadence after the first), each mean/p50/p99 over completed
        requests — and, under speculation, acceptance and target
        forwards per generated token."""
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
               # every submitted request ends completed or failed; failed
               # splits into deadline kills, retry-budget exhaustion and
               # drain-time shedding
               "failed": self.stats["failed"],
               "deadline_kills": self.stats["deadline_kills"],
               "retries": self.stats["retries"],
               "drained": self.stats["drained"],
               "restore_fallbacks": self.stats["restore_fallbacks"]}
        if self._ladder is not None:
            out["degradation_level"] = self.stats["degradation_level"]
            out["degradation_changes"] = self.stats["degradation_changes"]
            out["ladder_preempts"] = self.stats["ladder_preempts"]
        for name, samples in (("ttft", self._ttft), ("tpot", self._tpot)):
            if samples:
                arr = np.asarray(samples, np.float64)
                out[f"{name}_mean_s"] = float(arr.mean())
                out[f"{name}_p50_s"] = float(np.percentile(arr, 50))
                out[f"{name}_p99_s"] = float(np.percentile(arr, 99))
        if self.paged:
            out["kv_pages_used"] = self.stats["kv_pages_used"]
            out["kv_pages_free"] = self.stats["kv_pages_free"]
            out["preemptions"] = self.stats["preemptions"]
        if self.spec_k:
            proposed = self.stats["spec_tokens_proposed"]
            out["spec_ticks"] = self.stats["spec_ticks"]
            out["spec_tokens_proposed"] = proposed
            out["spec_tokens_accepted"] = self.stats["spec_tokens_accepted"]
            out["spec_acceptance_rate"] = (
                self.stats["spec_tokens_accepted"] / proposed
                if proposed else 0.0)
            out["draft_prefills"] = self.stats["draft_prefills"]
            # target decode + verify forwards per generated token: what
            # speculation exists to shrink (1.0 for plain decode)
            out["dispatches_per_token"] = n_dec / toks if toks else 0.0
        return out
