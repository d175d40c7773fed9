"""repro_torch.engine — the port's engine surface (serving; training with
the lanes stacked on one device or one lane per rank).

  config    EngineConfig, train and serve fields
  build     the training runtime (stacked lanes, or ranks over a Comm);
            decode, serve, verify and draft steps, and sampling
  registry  string-keyed combiners (sum, mean, adasum-gspmd/-fused/
            -linear, adasum-rvh across ranks)
  session   TrainSession — config -> model, runtime, data, state, fit(),
            checkpoints; the loop's callbacks; ServeSession, the legacy
            batch-serving surface
  pipeline  StepPipeline — resume, prefetch, callbacks, writer barriers;
            fit_elastic (shrink on node loss / a flagged straggler, grow
            back when capacity returns)
  serving   ServeEngine — continuous batching over a paged or dense KV
            cache, speculation, preemption, deadlines and drain, the
            pressure ladder, checkpoint serving and hot-reload
"""
from .config import EngineConfig
from .build import (EngineWarning, Runtime, build_runtime,
                    make_batched_decode_step, make_sampling_decode_step,
                    make_serve_step, sample_logits)
from .registry import (available_combiners, make_combiner,
                       register_combiner)
from .session import (Callback, CheckpointCallback, FailureInjectionCallback,
                      LoggingCallback, ServeSession, StragglerCallback,
                      TrainSession, default_callbacks)
from .pipeline import StepPipeline, fit_elastic
from .serving import (GenerationRequest, HotReloader, PressureLadder,
                      RequestHandle, ServeEngine)

__all__ = ["EngineConfig", "ServeEngine", "ServeSession", "GenerationRequest",
           "RequestHandle", "PressureLadder", "make_serve_step",
           "make_batched_decode_step",
           "make_sampling_decode_step", "sample_logits", "EngineWarning",
           "Runtime", "build_runtime", "available_combiners",
           "make_combiner", "register_combiner", "Callback",
           "LoggingCallback", "CheckpointCallback", "StragglerCallback",
           "FailureInjectionCallback", "TrainSession", "default_callbacks",
           "StepPipeline", "fit_elastic", "HotReloader"]
