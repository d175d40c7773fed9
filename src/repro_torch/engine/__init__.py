"""repro_torch.engine — the port's engine surface (slices 1-2: serving,
one-device training).

  config    EngineConfig, train and serve fields
  build     the one-device training runtime; decode steps and sampling
  registry  string-keyed combiners (sum, mean, adasum-gspmd/-fused/-linear)
  session   TrainSession — config -> model, runtime, data, state, fit()
  serving   ServeEngine — continuous batching over a paged KV cache
"""
from .config import EngineConfig
from .build import (EngineWarning, Runtime, build_runtime,
                    make_batched_decode_step, make_sampling_decode_step,
                    sample_logits)
from .registry import (available_combiners, make_combiner,
                       register_combiner)
from .session import (Callback, LoggingCallback, TrainSession,
                      default_callbacks)
from .serving import GenerationRequest, RequestHandle, ServeEngine

__all__ = ["EngineConfig", "ServeEngine", "GenerationRequest",
           "RequestHandle", "make_batched_decode_step",
           "make_sampling_decode_step", "sample_logits", "EngineWarning",
           "Runtime", "build_runtime", "available_combiners",
           "make_combiner", "register_combiner", "Callback",
           "LoggingCallback", "TrainSession", "default_callbacks"]
