"""Model API over every family the JAX package has — dense GQA, MLA and
MoE decoders, the SSM (rwkv), the hybrid (hymba), the vision frontend
(llava) and the encoder-decoder (seamless) (the port's
`repro/models/api.py`):

    model = build_model(cfg)
    params = model.init(generator)               # on cuda by default
    loss, metrics = model.loss(params, batch)    # training (plain attention)
    # across ranks the step adds fsdp= (its layer gather), token_group=
    # (the ranks splitting the rows), `parallel.zero`, and tp= (the
    # model group of a dense, MoE, MLA or vision-frontend decoder,
    # `parallel.tp`; a batch's frontend_embeds go through the projector
    # on the rank's shards)
    logits, cache = model.prefill_cache(params, tokens, lengths, max_len)
    logits, cache = model.decode_step(params, tokens, cache)
    logits, cache = model.verify_step(params, tokens_k1, cache)

`prefill_cache` and `verify_step` are None where the reference's are:
for ssm and hybrid (recurrent state is neither captured from the
parallel forward nor rolled back by a pos rewrite) and for the
encoder-decoder. An encoder-decoder's `init_cache` takes the frames
(`frontend_embeds=`) or the encoder output (`enc_out=`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import (ITEM_SHARDING, DeviceLike, make_generator,
                                 not_ported, resolve_device)
from . import attention as ATT
from . import encdec as ED
from . import transformer as TF


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable          # (generator=None, device=None) -> params
    forward: Callable       # (params, tokens[, frontend_embeds]) -> logits
    # (params, batch, max_len, per_slot=False, paged=None) -> cache; an
    # encoder-decoder's: (params, batch, max_len, enc_out=None,
    # frontend_embeds=None)
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
    # `init`'s leaves one at a time, in the order they are drawn:
    # (generator=None, device=None) -> iterator of (path, leaf)
    init_leaves: Optional[Callable] = None


def _init_fn(cfg: ModelConfig, param_dtype, draw=TF.init_params):
    """`Model.init` (`draw=TF.init_leaves`: `Model.init_leaves`)."""
    def init(generator: Optional[torch.Generator] = None,
             device: DeviceLike = None):
        dev = resolve_device(device if device is not None or generator is None
                             else generator.device)
        gen = generator if generator is not None else make_generator(dev)
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, init on {dev}")
        return draw(cfg, gen, param_dtype, dev)
    return init


def _build_encdec(cfg: ModelConfig, compute_dtype, param_dtype,
                  attn_impl: str, attn_chunk: int, remat: bool) -> Model:
    """The encoder-decoder branch (api.py:58-90): plain torch throughout,
    as the reference's is plain `jnp`."""
    def forward(params, tokens, frontend_embeds=None):
        enc = ED.encode(params, cfg, frontend_embeds, compute_dtype,
                        attn_chunk)
        return ED.decode_train(params, cfg, enc, tokens, compute_dtype,
                               attn_chunk)

    def init_cache(params, batch, max_len, enc_out=None,
                   frontend_embeds=None):
        if enc_out is None:
            if frontend_embeds is None:
                raise ValueError(f"{cfg.name}: an encoder-decoder cache "
                                 f"needs frontend_embeds or enc_out")
            enc_out = ED.encode(params, cfg, frontend_embeds, compute_dtype,
                                attn_chunk)
        return ED.init_cache(params, cfg, enc_out, max_len)

    def decode_step(params, tokens, cache):
        return ED.decode_step(params, cfg, tokens, cache, compute_dtype)

    def loss(params, batch, *, fsdp=None, token_group=None):
        if fsdp is not None:
            raise not_ported("fsdp with the encoder-decoder's own training "
                             "loop", ITEM_SHARDING)
        return ED.encdec_loss(params, cfg, batch, compute_dtype, attn_chunk,
                              remat, token_group=token_group)

    return Model(cfg, _init_fn(cfg, param_dtype), forward, init_cache,
                 decode_step, None, loss, None, attn_impl,
                 _init_fn(cfg, param_dtype, TF.init_leaves))


def build_model(cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
                param_dtype=torch.float32, attn_impl: str = "kernel",
                attn_chunk: int = 512, remat: bool = True) -> Model:
    """attn_impl='kernel' routes serving GQA attention through the kernel
    wrappers (CUDA kernel on a card, plain version on the CPU); 'plain'
    runs the plain versions everywhere — the on-card reference for the
    kernels. MLA attention, the MoE dispatch, the SSM mixers and the
    encoder-decoder are plain torch ops on every device. `loss`
    (training) always takes the plain attention path, `attn_chunk` query
    rows at a time (this bounds its attention memory; the result does not
    depend on it); remat recomputes each block in its backward pass."""
    if attn_impl not in ATT.ATTN_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r}; one of {ATT.ATTN_IMPLS}")
    if attn_chunk < 1:
        raise ValueError(f"attn_chunk={attn_chunk} must be positive")
    if cfg.is_encoder_decoder:
        return _build_encdec(cfg, compute_dtype, param_dtype, attn_impl,
                             attn_chunk, remat)

    def forward(params, tokens, frontend_embeds=None):
        return TF.forward(params, cfg, tokens, compute_dtype, attn_impl,
                          attn_chunk=attn_chunk,
                          frontend_embeds=frontend_embeds)[0]

    def init_cache(params, batch, max_len, per_slot=False, paged=None,
                   **_):
        # cache rows live in the compute dtype, as in the reference;
        # frontend embeddings are not fed to the decode cache, as the
        # reference's do not (session.py:420-440)
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

    def loss(params, batch, *, fsdp=None, token_group=None, tp=None):
        return TF.lm_loss(params, cfg, batch, compute_dtype, attn_chunk,
                          remat=remat, fsdp=fsdp, token_group=token_group,
                          tp=tp)

    def verify_step(params, tokens, cache):
        return TF.verify_step(params, cfg, tokens, cache, compute_dtype)

    if cfg.family in ("ssm", "hybrid"):         # api.py:134
        prefill_cache = verify_step = None
    return Model(cfg, _init_fn(cfg, param_dtype), forward, init_cache,
                 decode_step, prefill_cache, loss, verify_step, attn_impl,
                 _init_fn(cfg, param_dtype, TF.init_leaves))


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count from the params spec; active_only counts
    the routed experts a token uses (api.py:160)."""
    return TF.count_params(cfg, active_only)
