"""repro_torch.engine.serving — request-level serving.

    ServeEngine      submit/step/drain engine: continuous batching over a
                     paged (or dense) KV cache, fused or stepped prefill,
                     shared-prefix reuse, recompute preemption,
                     speculative decoding, deadlines / drain / pressure
                     ladder, checkpoint serving and hot-reload
    HotReloader      polls a checkpoint manager, restores new params
    GenerationRequest / RequestHandle
                     the request/response surface (streaming callbacks)
    ContinuousBatchingScheduler
                     host-side slot admission/retirement policy
    PagePool         host-side paged-KV allocator (refcounts, COW,
                     trash page 0)
    PrefixIndex      shared-prefix page registry (exact byte-chain keys,
                     LRU eviction)
    PressureLadder   graceful-degradation levels under pool/queue pressure
    insert_rows / select_rows / slot_positions
                     the slotted-cache device primitives (the paged ones
                     live in .slots too)
"""
from .engine import ServeEngine
from .reload import HotReloader
from .scheduler import (ContinuousBatchingScheduler, GenerationRequest,
                        PrefixIndex, PressureLadder, RequestHandle)
from .slots import PagePool, insert_rows, select_rows, slot_positions

__all__ = ["ServeEngine", "HotReloader", "GenerationRequest",
           "RequestHandle", "ContinuousBatchingScheduler", "PagePool",
           "PrefixIndex", "PressureLadder", "insert_rows", "select_rows",
           "slot_positions"]
