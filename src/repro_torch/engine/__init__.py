"""repro_torch.engine — the port's engine surface (slice 1: serving).

  config    EngineConfig, serve fields
  build     batched decode steps and per-slot token sampling
  serving   ServeEngine — continuous batching over a paged KV cache
"""
from .config import EngineConfig
from .build import (make_batched_decode_step, make_sampling_decode_step,
                    sample_logits)
from .serving import GenerationRequest, RequestHandle, ServeEngine

__all__ = ["EngineConfig", "ServeEngine", "GenerationRequest",
           "RequestHandle", "make_batched_decode_step",
           "make_sampling_decode_step", "sample_logits"]
