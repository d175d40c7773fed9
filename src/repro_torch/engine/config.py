"""EngineConfig, serve fields only (the port's subset of
`repro/engine/config.py`).

Field names, defaults and checks match the reference, so a serving
config means the same in both packages. The training, combiner and
data fields come with the training slice. Serve options a later slice
brings raise `NotImplementedError` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses

from repro_torch.runtime import ITEM_SERVING_EXTRAS, not_ported

PARAM_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # ---- model ----
    arch: str = ""              # registry id ("qwen3-32b", ...); "" => the
                                # caller passes a built Model
    reduced: bool = False       # CPU-scale reduced variant of `arch`
    param_dtype: str = "float32"
    seq_len: int = 256          # max_len=0 falls back to it

    # ---- serving (engine/serving.ServeEngine) ----
    max_slots: int = 8          # continuous-batching decode slot pool
    max_len: int = 0            # per-slot cache capacity; 0 => seq_len
                                # (rounded up to a page multiple — see
                                # serve_max_len())
    prefill_mode: str = "auto"  # 'parallel' (one fused forward) | 'auto'
    kv_layout: str = "paged"    # the paged page-pool arena
    page_size: int = 16         # tokens per KV page
    kv_pages: int = 0           # physical pages in the arena (incl. the
                                # reserved trash page); 0 => enough for
                                # every slot at full capacity
    prefix_sharing: bool = True # map page-aligned shared prompt prefixes
                                # onto the same read-only pages; prefill
                                # computes only the unshared tail

    def validate(self) -> "EngineConfig":
        """Cross-field checks; returns self so it chains."""
        if self.param_dtype not in PARAM_DTYPES:
            raise ValueError(f"param_dtype={self.param_dtype!r}; expected "
                             f"one of {PARAM_DTYPES}")
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_len < 0:
            raise ValueError(f"max_len must be >= 0, got {self.max_len}")
        if self.prefill_mode == "scan":
            raise not_ported("prefill_mode='scan' (the fused decode-scan "
                             "prefill of recurrent families)",
                             ITEM_SERVING_EXTRAS)
        if self.prefill_mode not in ("auto", "parallel"):
            raise ValueError(f"prefill_mode={self.prefill_mode!r}; "
                             f"expected auto | parallel | scan")
        if self.kv_layout == "dense":
            raise not_ported("kv_layout='dense'", ITEM_SERVING_EXTRAS)
        if self.kv_layout != "paged":
            raise ValueError(f"kv_layout={self.kv_layout!r}; "
                             f"expected paged | dense")
        if self.page_size < 1:
            raise ValueError(
                f"page_size must be >= 1 for kv_layout='paged', got "
                f"{self.page_size} (each KV page holds page_size token rows)")
        if self.kv_pages < 0:
            raise ValueError(f"kv_pages must be >= 0 (0 = full "
                             f"provisioning), got {self.kv_pages}")
        if self.kv_pages == 1:
            raise ValueError(
                "kv_pages=1 is only the reserved trash page; the engine "
                "needs at least one allocatable page")
        return self

    def serve_max_len(self) -> int:
        """The per-slot cache capacity the serve engine builds: `max_len`
        (0 => seq_len), rounded UP to a page multiple so logical rows
        tile pages exactly."""
        n = self.max_len or self.seq_len
        return -(-n // self.page_size) * self.page_size
