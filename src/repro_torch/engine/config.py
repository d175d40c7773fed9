"""EngineConfig, train and serve fields (the port's subset of
`repro/engine/config.py`).

Field names, defaults and checks match the reference, so a config means
the same in both packages; `from_cli` parses the train CLI with the
reference's flags and preset table. Options a later slice brings raise
`NotImplementedError` naming their ROADMAP item. The controller knobs
(`grow_*`, `max_global_batch`, `lr_rescale`, `noise_ema`,
`shrink_threshold`, `min_global_batch`) drive `fit_adaptive`; `elastic`
drives `fit_elastic`.

Span rules. Across ranks (`validate(dp_total=W)` with W > 1, one
process per rank) they are the reference's (config.py:309-313): span <=
dp and dp % span == 0, and global_batch divisible by dp. On one device
(W = 1) the port runs the `span` Adasum lanes stacked on one card, so
`validate` drops the span <= dp rule: on a one-device JAX mesh
`build_runtime` asserts dp % span == 0 and `TrainSession` quietly clamps
span > dp to 0, so the reference would run no combine there; the
function its `sync_step` computes does not depend on the mesh, and the
port computes that function with the lanes stacked. A span must be a
power of two that divides global_batch.

Meshes. `rank_mesh(world)` lays the ranks out as a (data, model) grid:
`data_mesh` 0 means every rank the model axis does not use
(config.py:49-50 of the reference), a grid larger than the ranks falls
back to (world, 1) as the reference's `make_local_mesh` does, and a grid
smaller than the ranks (the reference would leave devices idle) is
refused, naming ROADMAP.md queue 1 item 7. `pad_heads` pads heads for
the mesh's model size (`model_config(model_size=)`).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Optional

from repro_torch.data.pipeline import DataConfig
from repro_torch.parallel.policy import RunPolicy
from repro_torch.runtime import ITEM_SHARDING, not_ported

PARAM_DTYPES = ("float32", "bfloat16")
_COMBINE_OPS = ("adasum", "sum", "mean")
_BACKENDS = ("", "rvh", "gspmd_tree", "fused", "linear")
_COMPRESS = ("none", "int8")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # ---- model ----
    arch: str = ""              # registry id ("gemma-7b", ...); "" => the
                                # caller passes a built Model
    reduced: bool = False       # CPU-scale reduced variant of `arch`

    # ---- combiner ----
    combine: str = "adasum"     # 'adasum' | 'sum' | 'mean' | registry entry
    backend: str = ""           # '' => auto (rvh at span == dp across
                                # ranks, gspmd_tree below it and on one
                                # device)
    span: int = 0               # #Adasum lanes; 0 => one per DP rank
    combine_point: str = "auto" # 'pre' | 'post' | 'auto' (by optimizer kind)
    per_layer: bool = True      # paper §3.6 per-layer Adasum
    acc_dtype: str = "float32"  # dot-product accumulation dtype (§4.4.1)
    use_pallas: bool = False    # kernel granule 1024 (vs 256) and the TPU
                                # kernel's fp32 combine rule on the CPU arm
    compress: str = "none"      # 'int8': quantized RVH wire payloads
    fused_combine: bool = True  # bucketed single-pass combine for the
                                # gspmd_tree backend
    fusion_threshold_mb: int = 64   # Horovod-style packing bucket budget

    # ---- parallelism (fsdp / scatter_grads act across ranks, on the
    # data axis; on one device they change nothing, as in the
    # reference; pad_heads is the model axis's, item 7) ----
    data_mesh: int = 0          # 0 => all ranks not used by model_mesh
    model_mesh: int = 1
    fsdp: bool = False          # ZeRO-3: params sharded over the ranks
    scatter_grads: bool = False # ZeRO-2: lane grads reduce-scattered in
                                # each lane group (span < ranks)
    pad_heads: bool = False
    attn_chunk: int = 512

    # ---- optimizer / training ----
    optimizer: str = "adam"
    lr: float = 1e-3
    local_steps: int = 1        # paper §5.2 local-SGD steps per sync
    combine_delay: int = 0      # 0 = synchronous combine; 1 = DaSGD-style
                                # delayed mode: round i-1's delta exchange
                                # overlaps round i's compute, correction
                                # lands at i+1
    accum_steps: int = 1        # microbatch gradient accumulation (§2.2)
    accum_dtype: str = "float32"
    opt_state_dtype: str = "float32"
    param_dtype: str = "float32"

    # ---- data ----
    seq_len: int = 256
    global_batch: int = 16
    data_kind: str = "synthetic"    # synthetic | memmap
    data_path: str = ""
    data_seed: int = 0

    # ---- run control ----
    steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    log_every: int = 10
    strict: bool = False        # hard-error instead of warn+degrade

    # ---- pipelined runtime (engine/pipeline.py) ----
    prefetch: bool = True       # batches built on a background thread
    prefetch_depth: int = 1     # speculative batches in flight (1 =
                                # double-buffered; >1 = deeper pipeline)
    device_stage: bool = False  # the prefetch thread also copies the
                                # batch to the card (side CUDA stream)
    async_checkpoint: bool = True   # off-thread checkpoint writes
    elastic: bool = False       # straggler flag / node loss => checkpoint
                                # + halve-DP restart (fit_elastic; needs
                                # ckpt_dir)

    # ---- adaptive batch/span controller (repro_torch.control) ----
    combine_stats: bool = True  # CombineStats per-step metrics
    adaptive_batch: bool = False # gradient-noise-adaptive controller:
                                # grow global_batch (and span) when the
                                # EMA noise scale exceeds the band, via
                                # save -> rebuild -> resume (needs
                                # ckpt_dir; driven by fit_adaptive)
    grow_factor: int = 2        # batch multiplier per resize (AdaBatch
                                # doubling; power of two when grow_span)
    grow_threshold: float = 2.0 # resize while ema_noise > threshold *
                                # global_batch (hysteresis: reset below
                                # threshold/2)
    grow_patience: int = 8      # consecutive in-band steps before a resize
    grow_cooldown: int = 16     # steps after a resize before re-arming
    max_global_batch: int = 0   # controller hard cap (0 = uncapped)
    grow_span: bool = True      # grow Adasum span with the batch (kept a
                                # power-of-two divisor of dp)
    lr_rescale: str = "adascale" # LR rule at a resize: 'adascale' gain |
                                # 'linear' | 'none'
    noise_ema: float = 0.9      # noise-scale EMA decay
    shrink_threshold: float = 0.0 # shrink while ema_noise < this *
                                # global_batch (0 = shrink direction off;
                                # must stay below grow_threshold); LR is
                                # divided by the gain growth multiplied by
    min_global_batch: int = 0   # controller shrink floor (0 = span floor)

    # ---- serving (engine/serving.ServeEngine) ----
    max_slots: int = 8          # continuous-batching decode slot pool
    max_len: int = 0            # per-slot cache capacity; 0 => seq_len
                                # (rounded up to a page multiple — see
                                # serve_max_len())
    hot_reload: bool = False    # poll ckpt_dir mid-stream; new requests
                                # see new weights, in-flight finish on old
    prefill_mode: str = "auto"  # 'parallel' (one fused forward) | 'scan'
                                # (stepped decode prefill) | 'auto'
    kv_layout: str = "paged"    # 'paged' (page-pool arena, the default)
                                # | 'dense' (per-slot max_len buffers)
    page_size: int = 16         # tokens per KV page (paged layout)
    kv_pages: int = 0           # physical pages in the arena (incl. the
                                # reserved trash page); 0 => enough for
                                # every slot at full capacity
    prefix_sharing: bool = True # map page-aligned shared prompt prefixes
                                # onto the same read-only pages; prefill
                                # computes only the unshared tail
    speculation_k: int = 0      # draft-model speculative decoding: draft
                                # tokens proposed + verified per tick
                                # (0 = off); greedy ticks only
    draft_config: Optional[Dict[str, Any]] = None
                                # draft model: {'arch': preset[, 'reduced':
                                # bool, field overrides]} or ModelConfig
                                # field overrides of the target; None =>
                                # the target at quarter depth
    pressure_ladder: bool = False # serve graceful degradation under
                                # kv/queue pressure: no speculation ->
                                # no admissions -> preempt-by-recompute

    # ------------------------------------------------------------ validation
    def validate(self, dp_total: Optional[int] = None) -> "EngineConfig":
        """Cross-field checks; returns self so it chains. Pass `dp_total`
        (1 on one device) for the span and batch checks."""
        if self.param_dtype not in PARAM_DTYPES:
            raise ValueError(f"param_dtype={self.param_dtype!r}; expected "
                             f"one of {PARAM_DTYPES}")
        if self.combine in _COMBINE_OPS and self.backend not in _BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {_BACKENDS[1:]}")
        if self.combine not in _COMBINE_OPS:
            from .registry import available_combiners
            if self.combine not in available_combiners():
                raise ValueError(
                    f"unknown combine op {self.combine!r}; built-ins "
                    f"{_COMBINE_OPS}, registry {available_combiners()}")
        if self.span < 0:
            raise ValueError(f"span must be >= 0, got {self.span}")
        if self.compress not in _COMPRESS:
            raise ValueError(f"compress={self.compress!r}; expected one of "
                             f"{_COMPRESS}")
        if self.fusion_threshold_mb < 1:
            raise ValueError(f"fusion_threshold_mb must be >= 1, got "
                             f"{self.fusion_threshold_mb}")
        if self.prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be >= 1, got "
                             f"{self.prefetch_depth}")
        if not self.prefetch and (self.prefetch_depth > 1
                                  or self.device_stage):
            raise ValueError(
                "prefetch_depth > 1 / device_stage require prefetch=True "
                "(they configure the prefetch stage; with prefetch off "
                "they would be silently ignored)")
        if self.local_steps < 1 or self.accum_steps < 1:
            raise ValueError("local_steps/accum_steps must be >= 1")
        if self.local_steps > 1 and self.accum_steps > 1:
            raise ValueError("local_steps and accum_steps are mutually "
                             "exclusive (both reshape the lane batch)")
        if self.combine_delay not in (0, 1):
            raise ValueError(
                f"combine_delay must be 0 (synchronous) or 1 (DaSGD-style "
                f"one-round delayed exchange), got {self.combine_delay}")
        if self.combine_delay and self.accum_steps > 1:
            raise ValueError(
                "combine_delay and accum_steps are mutually exclusive: "
                "the delayed path combines per-lane optimizer-step deltas "
                "(local_steps semantics), not accumulated raw gradients — "
                "use local_steps to amortize syncs instead")
        if self.data_kind == "memmap" and not self.data_path:
            raise ValueError("data_kind='memmap' needs data_path")
        self._validate_controller()
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_len < 0:
            raise ValueError(f"max_len must be >= 0, got {self.max_len}")
        if self.hot_reload and not self.ckpt_dir:
            raise ValueError("hot_reload=True needs ckpt_dir (the serve "
                             "engine watches it for new checkpoints)")
        if self.prefill_mode not in ("auto", "parallel", "scan"):
            raise ValueError(f"prefill_mode={self.prefill_mode!r}; "
                             f"expected auto | parallel | scan")
        if self.kv_layout not in ("paged", "dense"):
            raise ValueError(f"kv_layout={self.kv_layout!r}; "
                             f"expected paged | dense")
        if self.kv_layout == "paged":
            if self.page_size < 1:
                raise ValueError(
                    f"page_size must be >= 1 for kv_layout='paged', got "
                    f"{self.page_size} (each KV page holds page_size "
                    f"token rows)")
            if self.kv_pages < 0:
                raise ValueError(f"kv_pages must be >= 0 (0 = full "
                                 f"provisioning), got {self.kv_pages}")
            if self.kv_pages == 1:
                raise ValueError(
                    "kv_pages=1 is only the reserved trash page; the "
                    "engine needs at least one allocatable page")
        if self.speculation_k < 0:
            raise ValueError(
                f"speculation_k must be >= 0 (draft tokens per tick; 0 "
                f"disables speculation), got {self.speculation_k}")
        if self.draft_config is not None:
            if not self.speculation_k:
                raise ValueError(
                    "draft_config is set but speculation_k=0; speculation "
                    "is off without draft tokens — set speculation_k >= 1 "
                    "or drop draft_config")
            if not isinstance(self.draft_config, dict) or not self.draft_config:
                raise ValueError(
                    f"draft_config must be a non-empty dict ({{'arch': "
                    f"preset[, 'reduced': bool]}} or ModelConfig field "
                    f"overrides), got {self.draft_config!r}")
        if dp_total is not None:
            span = self.span or dp_total
            if span & (span - 1):
                raise ValueError(f"span={span} must be a power of two (the "
                                 f"Adasum tree pairs lanes)")
            if dp_total > 1 and (span > dp_total or dp_total % span):
                raise ValueError(f"span={span} must divide dp={dp_total}")
            if dp_total > 1 and self.global_batch % dp_total:
                raise ValueError(f"global_batch={self.global_batch} not "
                                 f"divisible by dp={dp_total}")
            if self.backend == "rvh" and span != dp_total and self.strict:
                raise ValueError(
                    f"backend='rvh' needs one lane per DP rank (span={span}"
                    f", dp={dp_total}); drop strict=True to fall back to "
                    f"'gspmd_tree' with a warning")
            rows = self.global_batch
            if rows % span:
                raise ValueError(
                    f"global_batch={rows} not divisible by span={span}")
            lane_rows = rows // span
            if self.local_steps > 1 and lane_rows % self.local_steps:
                raise ValueError(
                    f"local_steps={self.local_steps} needs lane batch "
                    f"({lane_rows}) divisible by it")
            if self.accum_steps > 1 and lane_rows % self.accum_steps:
                raise ValueError(
                    f"accum_steps={self.accum_steps} needs lane batch "
                    f"({lane_rows}) divisible by it")
        return self

    def _validate_controller(self) -> None:
        """The controller knobs and the drivers' cross-field rules (the
        reference's, config.py:206-262)."""
        if self.grow_factor < 2:
            raise ValueError(f"grow_factor must be >= 2 (AdaBatch-style "
                             f"multiplicative growth), got {self.grow_factor}")
        if self.grow_span and self.grow_factor & (self.grow_factor - 1):
            raise ValueError(
                f"grow_factor={self.grow_factor} must be a power of two "
                f"when grow_span=True (the span must stay a power-of-two "
                f"divisor of dp); set grow_span=False for other factors")
        if self.grow_threshold <= 0:
            raise ValueError(f"grow_threshold must be > 0, got "
                             f"{self.grow_threshold}")
        if self.grow_patience < 1 or self.grow_cooldown < 0:
            raise ValueError("grow_patience must be >= 1 and grow_cooldown "
                             ">= 0")
        if self.max_global_batch < 0:
            raise ValueError(f"max_global_batch must be >= 0 (0 = "
                             f"uncapped), got {self.max_global_batch}")
        if not 0.0 <= self.noise_ema < 1.0:
            raise ValueError(f"noise_ema must be in [0, 1), got "
                             f"{self.noise_ema}")
        if self.shrink_threshold < 0:
            raise ValueError(f"shrink_threshold must be >= 0 (0 = shrink "
                             f"off), got {self.shrink_threshold}")
        if self.shrink_threshold and (self.shrink_threshold
                                      >= self.grow_threshold):
            raise ValueError(
                f"shrink_threshold={self.shrink_threshold} must stay "
                f"below grow_threshold={self.grow_threshold} (the bands "
                f"must not overlap or the controller oscillates)")
        if self.min_global_batch < 0:
            raise ValueError(f"min_global_batch must be >= 0, got "
                             f"{self.min_global_batch}")
        if self.lr_rescale not in ("adascale", "linear", "none"):
            raise ValueError(f"lr_rescale={self.lr_rescale!r}; expected "
                             f"adascale | linear | none")
        if self.adaptive_batch:
            if not self.ckpt_dir:
                raise ValueError("adaptive_batch=True needs ckpt_dir (a "
                                 "resize resumes from the checkpoint "
                                 "manifest)")
            if not self.combine_stats:
                raise ValueError("adaptive_batch=True needs "
                                 "combine_stats=True (the controller is "
                                 "driven by the combiner's noise signal)")
            if self.combine_delay:
                raise ValueError(
                    "adaptive_batch and combine_delay are mutually "
                    "exclusive: CombineStats are collected on the "
                    "synchronous combine paths only (the delayed carry's "
                    "dots describe the previous round)")
            if self.elastic:
                raise ValueError(
                    "adaptive_batch and elastic are mutually exclusive "
                    "drivers (fit_adaptive vs fit_elastic) — straggler "
                    "shrink + noise growth composition is not supported "
                    "yet")
        if self.elastic and not self.ckpt_dir:
            raise ValueError("elastic=True needs ckpt_dir (restarts "
                             "resume from the checkpoint manifest)")

    def rank_mesh(self, world: int):
        """The (data, model) grid of `world` ranks or devices
        (`launch.mesh.Mesh`; session.py:155-160 of the reference)."""
        from repro_torch.launch.mesh import make_local_mesh
        if self.model_mesh < 1 or self.data_mesh < 0:
            raise ValueError(f"data_mesh={self.data_mesh} (0: every rank "
                             f"left) and model_mesh={self.model_mesh} (>= 1)")
        data = self.data_mesh or max(1, world // self.model_mesh)
        mesh = make_local_mesh(data, self.model_mesh, world)
        if mesh.size != world:
            raise not_ported(
                f"a {data} x {self.model_mesh} (data, model) grid on "
                f"{world} ranks", ITEM_SHARDING, "every rank takes part: "
                "data_mesh x model_mesh must be the rank count")
        return mesh

    def model_config(self, model_size: int = 1):
        """The ModelConfig of `arch` (its reduced preset under
        `reduced`), its heads padded for `model_size` under
        `pad_heads`."""
        from repro_torch.configs.base import (get_config, get_reduced,
                                              pad_heads_for_tp)
        cfg = (get_reduced(self.arch) if self.reduced
               else get_config(self.arch))
        if self.pad_heads:
            cfg = pad_heads_for_tp(cfg, model_size)
        return cfg

    def serve_max_len(self) -> int:
        """The per-slot cache capacity the serve engine builds: `max_len`
        (0 => seq_len), rounded UP to a page multiple under
        kv_layout='paged' so logical rows tile pages exactly."""
        n = self.max_len or self.seq_len
        if self.kv_layout == "paged" and self.page_size > 0:
            n = -(-n // self.page_size) * self.page_size
        return n

    # ------------------------------------------------------------ round-trip
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EngineConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown EngineConfig keys: {sorted(unknown)}")
        return cls(**d)

    # ---------------------------------------------------------------- presets
    @classmethod
    def preset(cls, arch: str, **overrides) -> "EngineConfig":
        """Per-arch preset (the reference's table) + overrides."""
        from repro_torch.configs.base import canonical
        base = dict(_PRESETS.get(canonical(arch), {}))
        base["arch"] = arch
        base.update(overrides)
        return cls(**base)

    # ----------------------------------------------------------- conversions
    def run_policy(self) -> RunPolicy:
        """Project onto the RunPolicy consumed by the step builder."""
        return RunPolicy(
            span=self.span, fsdp=self.fsdp, scatter_grads=self.scatter_grads,
            backend=self.backend, optimizer=self.optimizer,
            param_dtype=self.param_dtype, local_steps=self.local_steps,
            combine_delay=self.combine_delay,
            combine_op=self.combine, attn_chunk=self.attn_chunk,
            accum_steps=self.accum_steps, accum_dtype=self.accum_dtype,
            opt_state_dtype=self.opt_state_dtype, pad_heads=self.pad_heads,
            combine_point=self.combine_point, per_layer=self.per_layer,
            acc_dtype=self.acc_dtype, use_pallas=self.use_pallas,
            compress=self.compress, fused_combine=self.fused_combine,
            fusion_threshold_mb=self.fusion_threshold_mb,
            combine_stats=self.combine_stats)

    def data_config(self, vocab_size: int) -> DataConfig:
        return DataConfig(seq_len=self.seq_len,
                          global_batch=self.global_batch,
                          vocab_size=vocab_size, seed=self.data_seed,
                          kind=self.data_kind, path=self.data_path or None)

    # ------------------------------------------------------------------- CLI
    @classmethod
    def from_cli(cls, argv=None, **defaults) -> "EngineConfig":
        """Parse the train CLI into a config. Flags override the per-arch
        preset, which overrides the dataclass defaults. Flags of later
        slices are parsed, and `validate` refuses them."""
        ap = argparse.ArgumentParser(description="repro_torch train CLI")
        ap.add_argument("--arch", required="arch" not in defaults)
        ap.add_argument("--reduced", action="store_true", default=None,
                        help="use the reduced config (CPU-scale)")
        ap.add_argument("--steps", type=int, default=None)
        ap.add_argument("--seq", type=int, default=None, dest="seq_len")
        ap.add_argument("--batch", type=int, default=None,
                        dest="global_batch")
        ap.add_argument("--lr", type=float, default=None)
        ap.add_argument("--optimizer", default=None)
        ap.add_argument("--combine", default=None,
                        help="adasum | sum | mean | any registry entry")
        ap.add_argument("--backend", default=None,
                        choices=["rvh", "gspmd_tree", "fused", "linear"])
        ap.add_argument("--no-fused-combine", action="store_true",
                        help="per-leaf reference tree instead of the "
                        "bucketed single-pass combine")
        ap.add_argument("--fusion-threshold-mb", type=int, default=None,
                        dest="fusion_threshold_mb")
        ap.add_argument("--span", type=int, default=None)
        ap.add_argument("--local-steps", type=int, default=None,
                        dest="local_steps")
        ap.add_argument("--combine-delay", type=int, default=None,
                        dest="combine_delay", choices=[0, 1])
        ap.add_argument("--accum-steps", type=int, default=None,
                        dest="accum_steps")
        ap.add_argument("--no-per-layer", action="store_true",
                        help="whole-model Adasum granularity (§3.6 ablation)")
        ap.add_argument("--acc-dtype", default=None, dest="acc_dtype")
        ap.add_argument("--use-pallas", action="store_true", default=None,
                        dest="use_pallas")
        ap.add_argument("--compress", default=None, choices=list(_COMPRESS),
                        help="int8: quantized RVH wire payloads")
        ap.add_argument("--strict", action="store_true", default=None,
                        help="error (not warn) on degraded fallbacks")
        ap.add_argument("--data-mesh", type=int, default=None,
                        dest="data_mesh")
        ap.add_argument("--model-mesh", type=int, default=None,
                        dest="model_mesh")
        ap.add_argument("--ckpt-dir", default=None, dest="ckpt_dir")
        ap.add_argument("--ckpt-every", type=int, default=None,
                        dest="ckpt_every")
        ap.add_argument("--log-every", type=int, default=None,
                        dest="log_every")
        ap.add_argument("--data-seed", type=int, default=None,
                        dest="data_seed")
        ap.add_argument("--no-prefetch", action="store_true",
                        help="synchronous batch pulls (disable the "
                        "double-buffered prefetch stage)")
        ap.add_argument("--prefetch-depth", type=int, default=None,
                        dest="prefetch_depth",
                        help="speculative batches in flight (1 = "
                        "double-buffered)")
        ap.add_argument("--device-stage", action="store_true", default=None,
                        dest="device_stage",
                        help="the prefetch thread copies batches to the "
                        "card on a side stream instead of host staging")
        ap.add_argument("--sync-checkpoint", action="store_true",
                        help="block the step loop on checkpoint writes")
        ap.add_argument("--elastic", action="store_true", default=None,
                        help="straggler flag => checkpoint + halve-DP "
                        "restart (needs --ckpt-dir)")
        ap.add_argument("--no-combine-stats", action="store_true",
                        help="drop the CombineStats per-step metrics")
        ap.add_argument("--adaptive-batch", action="store_true",
                        default=None, dest="adaptive_batch",
                        help="noise-adaptive controller: grow batch/span "
                        "when measured gradient noise exceeds the band "
                        "(needs --ckpt-dir)")
        ap.add_argument("--grow-factor", type=int, default=None,
                        dest="grow_factor",
                        help="batch multiplier per adaptive resize")
        ap.add_argument("--grow-threshold", type=float, default=None,
                        dest="grow_threshold",
                        help="resize while ema noise_scale > threshold * "
                        "global_batch")
        ap.add_argument("--grow-patience", type=int, default=None,
                        dest="grow_patience",
                        help="consecutive in-band steps before a resize")
        ap.add_argument("--grow-cooldown", type=int, default=None,
                        dest="grow_cooldown",
                        help="steps after a resize before re-arming")
        ap.add_argument("--max-global-batch", type=int, default=None,
                        dest="max_global_batch",
                        help="adaptive controller batch cap (0 = uncapped)")
        ap.add_argument("--no-grow-span", action="store_true",
                        help="adaptive resizes grow only the batch, "
                        "never the Adasum span")
        ap.add_argument("--shrink-threshold", type=float, default=None,
                        dest="shrink_threshold",
                        help="adaptive shrink band: halve while ema "
                        "noise_scale < threshold * global_batch (0 = off)")
        ap.add_argument("--min-global-batch", type=int, default=None,
                        dest="min_global_batch",
                        help="adaptive controller shrink floor (0 = span "
                        "floor only)")
        ap.add_argument("--lr-rescale", default=None, dest="lr_rescale",
                        choices=["adascale", "linear", "none"],
                        help="LR rule at an adaptive resize")
        ap.add_argument("--noise-ema", type=float, default=None,
                        dest="noise_ema",
                        help="noise-scale EMA decay in [0, 1)")
        ap.add_argument("--hot-reload", action="store_true", default=None,
                        dest="hot_reload",
                        help="serving: pick up new checkpoints mid-stream")
        args, extra = ap.parse_known_args(argv)
        if extra:
            raise SystemExit(f"unknown arguments: {extra}")

        cfg = cls.preset(args.arch or defaults.get("arch", ""))
        over: Dict[str, Any] = dict(defaults)
        for f in dataclasses.fields(cls):
            v = getattr(args, f.name, None)
            if v is not None:
                over[f.name] = v
        if args.no_per_layer:
            over["per_layer"] = False
        if args.no_fused_combine:
            over["fused_combine"] = False
        if args.no_prefetch:
            over["prefetch"] = False
        if args.sync_checkpoint:
            over["async_checkpoint"] = False
        if args.no_combine_stats:
            over["combine_stats"] = False
        if args.no_grow_span:
            over["grow_span"] = False
        # local CLI runs: the pod-scale FSDP/ZeRO-2 presets are switched
        # off, as the reference's CLI does
        over.setdefault("fsdp", False)
        over.setdefault("scatter_grads", False)
        return dataclasses.replace(cfg, **over).validate()


# Per-arch presets — the reference's table (config.py:580-600), derived
# there from a TPU memory budget; kept as is so a preset means the same
# run in both packages. Across ranks fsdp and scatter_grads shard the data
# axis (`parallel.zero`); on one device they, and pad_heads, change
# nothing; there backend='rvh' with span > 1 falls back to gspmd_tree.
_PRESETS: Dict[str, Dict[str, Any]] = {
    "hymba_1p5b":            dict(backend="rvh", pad_heads=True),
    "moonshot_v1_16b_a3b":   dict(span=4, fsdp=True, scatter_grads=True,
                                  backend="gspmd_tree"),
    "mixtral_8x22b":         dict(span=2, fsdp=True, scatter_grads=True,
                                  backend="gspmd_tree",
                                  param_dtype="bfloat16", attn_chunk=256,
                                  accum_steps=8, accum_dtype="bfloat16",
                                  opt_state_dtype="bfloat16",
                                  pad_heads=True),
    "llava_next_34b":        dict(span=4, fsdp=True, scatter_grads=True,
                                  backend="gspmd_tree", accum_steps=4,
                                  pad_heads=True),
    "gemma_7b":              dict(backend="rvh"),
    "minitron_4b":           dict(backend="rvh", pad_heads=True),
    "minicpm3_4b":           dict(backend="rvh"),
    "qwen3_32b":             dict(span=4, fsdp=True, scatter_grads=True,
                                  backend="gspmd_tree", accum_steps=4,
                                  pad_heads=True),
    "seamless_m4t_large_v2": dict(backend="rvh"),
    "rwkv6_7b":              dict(backend="rvh"),
}
