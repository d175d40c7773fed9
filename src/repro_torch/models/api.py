"""Model API for the attention families — dense GQA, MLA and MoE
decoders (the port's `repro/models/api.py`):

    model = build_model(cfg)
    params = model.init(generator)               # on cuda by default
    loss, metrics = model.loss(params, batch)    # training (plain attention)
    logits, cache = model.prefill_cache(params, tokens, lengths, max_len)
    logits, cache = model.decode_step(params, tokens, cache)
    logits, cache = model.verify_step(params, tokens_k1, cache)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import (ITEM_FAMILIES, ITEM_SHARDING, DeviceLike,
                                 make_generator, not_ported, resolve_device)
from . import attention as ATT
from . import transformer as TF


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable          # (generator=None, device=None) -> params
    forward: Callable       # (params, tokens) -> logits [B,T,V]
    # (params, batch, max_len, per_slot=False, paged=None) -> cache
    init_cache: Callable
    decode_step: Callable   # (params, tokens, cache) -> (logits, cache)
    # fused serving prefill: (params, tokens [B,P], lengths [B], max_len
    # [, prefix_kv, prefix_len]) -> (last-position logits, dense rows)
    prefill_cache: Optional[Callable] = None
    loss: Optional[Callable] = None   # (params, batch) -> (total, metrics)
    # speculative verify: (params, tokens [B,T], cache) -> (logits
    # [B,T,V], cache with K/V rows written and pos unchanged)
    verify_step: Optional[Callable] = None
    attn_impl: str = "kernel"         # what serving attention runs through


def _check_family(cfg: ModelConfig) -> None:
    if (cfg.family not in ("dense", "moe")
            or cfg.attn_type not in ("gqa", "mla")
            or cfg.is_encoder_decoder or cfg.frontend != "none"):
        raise not_ported(f"{cfg.name} (family={cfg.family}, "
                         f"attn={cfg.attn_type})", ITEM_FAMILIES,
                         "the port runs dense and MoE decoders with GQA "
                         "or MLA attention")
    if cfg.orig_heads:
        raise not_ported("TP head padding (orig_heads)", ITEM_SHARDING)


def build_model(cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
                param_dtype=torch.float32, attn_impl: str = "kernel",
                attn_chunk: int = 512, remat: bool = True) -> Model:
    """attn_impl='kernel' routes serving GQA attention through the kernel
    wrappers (CUDA kernel on a card, plain version on the CPU); 'plain'
    runs the plain versions everywhere — the on-card reference for the
    kernels. MLA attention and the MoE dispatch are plain torch ops on
    every device. `loss` (training) always takes the plain attention
    path, `attn_chunk` query rows at a time (this bounds its attention
    memory; the result does not depend on it); remat recomputes each
    block in its backward pass."""
    _check_family(cfg)
    if attn_impl not in ATT.ATTN_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r}; one of {ATT.ATTN_IMPLS}")
    if attn_chunk < 1:
        raise ValueError(f"attn_chunk={attn_chunk} must be positive")

    def init(generator: Optional[torch.Generator] = None,
             device: DeviceLike = None):
        dev = resolve_device(device if device is not None or generator is None
                             else generator.device)
        gen = generator if generator is not None else make_generator(dev)
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, init on {dev}")
        return TF.init_params(cfg, gen, param_dtype, dev)

    def forward(params, tokens):
        return TF.forward(params, cfg, tokens, compute_dtype, attn_impl,
                          attn_chunk=attn_chunk)[0]

    def init_cache(params, batch, max_len, per_slot=False, paged=None):
        # cache rows live in the compute dtype, as in the reference
        return TF.init_decode_cache(cfg, batch, max_len, compute_dtype,
                                    params["embed"]["table"].device,
                                    per_slot, paged)

    def decode_step(params, tokens, cache):
        return TF.decode_step(params, cfg, tokens, cache, compute_dtype,
                              attn_impl)

    def prefill_cache(params, tokens, lengths, max_len, prefix_kv=None,
                      prefix_len=0):
        return TF.prefill_decode_cache(
            params, cfg, tokens, lengths, max_len, compute_dtype, attn_impl,
            cache_dtype=compute_dtype, prefix_kv=prefix_kv,
            prefix_len=prefix_len)

    def loss(params, batch):
        return TF.lm_loss(params, cfg, batch, compute_dtype, attn_chunk,
                          remat=remat)

    def verify_step(params, tokens, cache):
        return TF.verify_step(params, cfg, tokens, cache, compute_dtype)

    return Model(cfg, init, forward, init_cache, decode_step, prefill_cache,
                 loss, verify_step, attn_impl)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count from the params spec; active_only counts
    the routed experts a token uses (api.py:160)."""
    _check_family(cfg)
    return TF.count_params(cfg, active_only)
