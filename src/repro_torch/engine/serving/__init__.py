"""repro_torch.engine.serving — request-level serving (slice 1).

    ServeEngine      submit/step/drain engine: continuous batching over a
                     paged KV cache, fused prefill, shared-prefix reuse,
                     checkpoint serving and hot-reload
    HotReloader      polls a checkpoint manager, restores new params
    GenerationRequest / RequestHandle
                     the request/response surface (streaming callbacks)
    ContinuousBatchingScheduler
                     host-side slot admission/retirement policy
    PagePool         host-side paged-KV allocator (refcounts, COW,
                     trash page 0)
    PrefixIndex      shared-prefix page registry (exact byte-chain keys,
                     LRU eviction)
"""
from .engine import ServeEngine
from .reload import HotReloader
from .scheduler import (ContinuousBatchingScheduler, GenerationRequest,
                        PrefixIndex, RequestHandle)
from .slots import PagePool

__all__ = ["ServeEngine", "HotReloader", "GenerationRequest",
           "RequestHandle", "ContinuousBatchingScheduler", "PagePool",
           "PrefixIndex"]
