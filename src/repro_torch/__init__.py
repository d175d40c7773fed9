"""repro_torch — the PyTorch/CUDA port of `repro`, slice by slice.

This package imports `torch` and `numpy` only. It never imports `jax`
and nothing of `repro`: what it needs from the JAX package it keeps as
its own copy, with the same module names so each counterpart is easy to
find (`configs/`, `models/`, `kernels/`, `engine/`, `engine/serving/`,
`launch/`).

Slice 1 (this package today) is the serving path of a dense GQA decoder:
paged continuous batching with shared-prefix reuse, whose prefill and
decode attention run in hand-written CUDA kernels on an H100
(`kernels/csrc/flash_attention.cu`). Entry points run on `cuda` unless
the caller passes `device="cpu"`; see `runtime.resolve_device`.
"""
