"""repro_torch — the PyTorch/CUDA port of `repro`, slice by slice.

This package imports `torch` and `numpy` only. It never imports `jax`
and nothing of `repro`: what it needs from the JAX package it keeps as
its own copy, with the same module names so each counterpart is easy to
find (`configs/`, `models/`, `kernels/`, `engine/`, `engine/serving/`,
`launch/`).

It serves dense GQA decoders (paged continuous batching with
shared-prefix reuse, prefill and decode attention in hand-written CUDA
kernels, `kernels/csrc/flash_attention.cu`) and trains them with Adasum:
the lanes stacked on one device, or one lane per rank over
`torch.distributed` with the paper's RVH (`core/rvh.py`), the block
kernels in `kernels/csrc/adasum.cu`. Entry points run on `cuda` unless
the caller passes `device="cpu"`; see `runtime.resolve_device`.
"""
