"""repro_torch.control — gradient-noise-adaptive batch/span control (the
port of `repro/control`).

Adasum's combiner already computes the pairwise gradient dot products
that measure lane orthogonality; this package turns that free signal
into a controller that grows global batch / Adasum span as measured
noise rises (AdaBatch x AdaScale x Adasum), executing each growth
through the save -> rebuild -> resume machinery.

    noise.py      CombineStats -> noise-scale / gain metrics, NoiseEMA
    controller.py EMA + hysteresis schedule -> ResizePlan decisions
    resize.py     plan execution: fit_adaptive / ControllerCallback /
                  apply_resize / log_effective
    telemetry.py  git SHA + config-hash run fingerprinting

Import layering: noise/controller/telemetry sit below the engine
(importable from repro_torch.engine.build); resize drives the engine and
is loaded lazily here so `import repro_torch.control` never recurses
into a partially-initialized engine package.
"""
from .noise import STAT_KEYS, NoiseEMA, gain_for_factor, summarize_stats
from .controller import BatchController, ControllerConfig
from .telemetry import config_hash, git_sha, run_fingerprint

_LAZY = ("ControllerCallback", "apply_resize", "fit_adaptive",
         "log_effective")

__all__ = ["STAT_KEYS", "NoiseEMA", "gain_for_factor", "summarize_stats",
           "BatchController", "ControllerConfig", "config_hash", "git_sha",
           "run_fingerprint", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        from . import resize
        return getattr(resize, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
