"""Decoder-only LM assembly for the dense family (the port's subset of
`repro/models/transformer.py`):

    x += attn(norm(x));  x += mlp(norm(x))

Block params are stacked `[L, ...]` as in the reference (one leaf per
weight, layer on axis 0); a Python loop over layers takes the place of
`lax.scan`, reading each layer as views `blocks[...][l]`. Decode caches
stack the same way: `DecodeCache.layers = {"attn": PagedKVCache}` with
arenas `[L, num_pages, page_size, KV, Dh]`, page tables `[L, B, P]` and
positions `[L, B]`, or `{"attn": KVCache}` with dense rows
`[L, B, cap, KV, Dh]` and positions `[L, B]` (per slot) or `[L]`.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from . import attention as ATT
from . import layers as L

PyTree = Any


# ------------------------------------------------------------------- params
def param_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """The params tree as (shape, init, fan_in) leaves — init is 'dense'
    (truncated normal, std 1/sqrt(fan_in)), 'embed' (std 0.02) or
    'ones'. The layout is `transformer.init_params`' leaf for leaf."""
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh, f, Lyr, V = cfg.resolved_head_dim, cfg.d_ff, cfg.n_layers, \
        cfg.vocab_size
    attn = {"wq": ((Lyr, d, h * dh), "dense", d),
            "wk": ((Lyr, d, kv * dh), "dense", d),
            "wv": ((Lyr, d, kv * dh), "dense", d),
            "wo": ((Lyr, h * dh, d), "dense", h * dh)}
    if cfg.qk_norm:
        attn["q_norm"] = ((Lyr, dh), "ones", 0)
        attn["k_norm"] = ((Lyr, dh), "ones", 0)
    spec = {
        "embed": {"table": ((V, d), "embed", 0)},
        "final_norm": {"scale": ((d,), "ones", 0)},
        "blocks": {
            "norm1": {"scale": ((Lyr, d), "ones", 0)},
            "attn": attn,
            "norm2": {"scale": ((Lyr, d), "ones", 0)},
            "mlp": {"w_gate": ((Lyr, d, f), "dense", d),
                    "w_up": ((Lyr, d, f), "dense", d),
                    "w_down": ((Lyr, f, d), "dense", f)},
        },
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"w": ((d, V), "dense", d)}
    return spec


def _init_leaf(shape, kind, fan_in, dtype, generator, device):
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    std = 0.02 if kind == "embed" else 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(shape, dtype=dtype, device=device)
    # stacked leaves draw one layer at a time: the fp32 draw is one layer
    rows = [out] if kind == "embed" or len(shape) == 2 else list(out)
    for r in rows:
        t = torch.empty(r.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                                    generator=generator)
        r.copy_(t)
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                param_dtype=torch.float32,
                device: Optional[torch.device] = None) -> PyTree:
    """Random weights from `generator`, drawn on its device (the numbers
    differ from the JAX package's: weights cross frameworks only through
    `repro_torch.bridge`)."""
    device = generator.device if device is None else device

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return _init_leaf(*node, param_dtype, generator, device)
    return build(param_spec(cfg))


def count_params(cfg: ModelConfig) -> int:
    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        return int(np.prod(node[0]))
    return count(param_spec(cfg))


def layer_params(blocks: PyTree, l: int) -> PyTree:
    """Layer l's params as views of the stacked [L, ...] leaves."""
    return {k: layer_params(v, l) if isinstance(v, dict) else v[l]
            for k, v in blocks.items()}


# ------------------------------------------------------------------- blocks
def block_apply(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, compute_dtype=torch.bfloat16,
                attn_impl: str = "kernel", return_kv: bool = False,
                prefix_kv=None, attn_chunk: int = 512):
    """One block on [B,T,D] -> [B,T,D] (plus this block's RoPE'd (k, v)
    with return_kv). prefix_kv: this block's cached shared-prefix pair
    for the extend prefill (`positions` then starts at its length)."""
    h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    a = ATT.gqa_forward(params["attn"], cfg, h, positions, compute_dtype,
                        attn_impl, return_kv=return_kv, prefix_kv=prefix_kv,
                        attn_chunk=attn_chunk)
    if return_kv:
        a, kv = a
    x = x + a
    h = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
    x = x + L.mlp_apply(params["mlp"], h, cfg.mlp_type, compute_dtype)
    return (x, kv) if return_kv else x


def _logits(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
            compute_dtype) -> torch.Tensor:
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x, compute_dtype)
    return L.lm_head(params["lm_head"], x, compute_dtype)


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            compute_dtype=torch.bfloat16, attn_impl: str = "kernel",
            remat: bool = False, attn_chunk: int = 512) -> torch.Tensor:
    """tokens [B,T] -> logits [B,T,V] fp32 (the reference also returns
    the MoE aux loss, which the dense family does not have). remat:
    recompute each block in the backward pass instead of keeping its
    activations (`jax.checkpoint` per block, transformer.py:175).
    attn_chunk: query rows per chunk of the plain attention path."""
    x = L.embed(params["embed"], tokens, compute_dtype)
    positions = torch.arange(x.shape[1], dtype=torch.float32,
                             device=x.device)
    for l in range(cfg.n_layers):
        bp = layer_params(params["blocks"], l)
        if remat:
            x = checkpoint(block_apply, bp, cfg, x, positions, compute_dtype,
                           attn_impl, attn_chunk=attn_chunk,
                           use_reentrant=False)
        else:
            x = block_apply(bp, cfg, x, positions, compute_dtype, attn_impl,
                            attn_chunk=attn_chunk)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x, compute_dtype)


def lm_loss(params: PyTree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            compute_dtype=torch.bfloat16, attn_chunk: int = 512,
            aux_weight: float = 0.01, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (transformer.py:226-255). batch: tokens
    [B,T], labels [B,T] (-100 = masked). Attention runs the plain
    `_chunked_attention` on every device, as the reference's training
    loss does: the flash kernel is forward-only. Returns (total, {'loss',
    'aux'}); the dense family's aux loss is 0."""
    logits = forward(params, cfg, batch["tokens"], compute_dtype, "plain",
                     remat, attn_chunk)
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    nll = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                          labels.clamp(min=0).reshape(-1), reduction="none")
    loss = (nll * mask.reshape(-1)).sum() / mask.sum().clamp(min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


# ------------------------------------------------------------------- decode
class DecodeCache(NamedTuple):
    """Per-layer caches stacked on a leading L axis (the reference's
    `dense_layers` segment belongs to MoE configs, a later slice)."""
    layers: PyTree


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device: torch.device, per_slot: bool = False,
                      paged: Optional[Tuple[int, int]] = None
                      ) -> DecodeCache:
    """All zero. paged=(page_size, num_pages): per-layer page arenas
    `[L, num_pages, page_size, KV, Dh]`, int32 page tables
    `[L, B, pages_per_slot]` (every entry at trash page 0) and positions
    `[L, B]`. Otherwise dense rows `[L, B, cap, KV, Dh]` with positions
    `[L, B]` under per_slot (the serving layout: the slot axis is axis 1
    of every leaf) or `[L]` (the legacy batch loop)."""
    if paged is not None:
        ps, num_pages = paged
        one = ATT.init_paged_kv_cache(cfg, batch, max_len, ps, num_pages,
                                      dtype, device)
    else:
        one = ATT.init_kv_cache(cfg, batch, max_len, dtype, device, per_slot)
    Lyr = cfg.n_layers
    return DecodeCache({"attn": type(one)(
        *(t.unsqueeze(0).repeat((Lyr,) + (1,) * t.dim()) for t in one))})


def _cache_rows(t: torch.Tensor, lengths: torch.Tensor, cap: int,
                rolling: bool, cache_dtype, offset: int = 0) -> torch.Tensor:
    """Place captured per-position tensors [L,B,P,...] into fixed-capacity
    cache rows [L,B,cap,...].

    Linear layout (full attention, or a rolling buffer that fits the whole
    prompt): row p holds position p; rows >= length are dead weight the
    per-slot pos mask excludes. Rolling layout (SWA, prompt longer than
    the window): row r holds the most recent prompt position p with
    p % cap == r — exactly what cap sequential decode writes would leave.

    offset: absolute position of t[..., 0] (extend-prefill: the tail
    starts after a cached shared prefix; linear layout only)."""
    Lyr, B, P = t.shape[:3]
    tail = t.shape[3:]
    if not rolling or cap >= offset + P:
        if cap < offset + P:
            raise ValueError(f"cache capacity {cap} < prompt bucket "
                             f"{offset}+{P}")
        out = torch.zeros((Lyr, B, cap) + tail, dtype=cache_dtype,
                          device=t.device)
        out[:, :, offset:offset + P] = t.to(cache_dtype)
        return out
    if offset:
        raise ValueError("rolling prefill cannot extend a shared prefix")
    last = (lengths.long() - 1)[:, None]                     # [B,1]
    idx = torch.arange(cap, device=t.device)[None, :]        # [1,cap]
    p_r = last - torch.remainder(last - idx, cap)            # winner per row
    valid = p_r >= 0
    take = torch.clamp(p_r, 0, P - 1).reshape((1, B, cap) + (1,) * len(tail))
    rows = torch.gather(t, 2, take.expand((Lyr, B, cap) + tail))
    mask = valid.reshape((1, B, cap) + (1,) * len(tail))
    return torch.where(mask, rows, torch.zeros((), dtype=t.dtype,
                                               device=t.device)
                       ).to(cache_dtype)


def prefill_decode_cache(params: PyTree, cfg: ModelConfig,
                         tokens: torch.Tensor, lengths: torch.Tensor,
                         max_len: int, compute_dtype=torch.bfloat16,
                         attn_impl: str = "kernel",
                         cache_dtype=torch.bfloat16, prefix_kv=None,
                         prefix_len: int = 0
                         ) -> Tuple[torch.Tensor, DecodeCache]:
    """Fused serving prefill: ONE full-sequence forward that computes the
    last-prompt-position logits and every layer's K/V rows.

    tokens: [B,P] prompts right-padded to a common bucket length (causal
    attention makes the padding inert); lengths: [B] true prompt lengths.
    Returns (logits [B,1,V] at position lengths-1, DecodeCache of dense
    KVCache rows [L,B,cap,KV,Dh] with pos = prefix_len + lengths).

    Shared-prefix extend: with `prefix_kv` (a DecodeCache of per-layer
    prefix pairs [L, 1|B, prefix_len, KV, Dh], as `gather_prefix`
    returns, or the bare pair) the tokens are the UNSHARED TAIL only —
    positions start at `prefix_len`, the forward attends to
    prefix + tail, and the rows hold the tail at its absolute
    positions."""
    if prefix_kv is not None and (prefix_len <= 0 or cfg.sliding_window):
        raise ValueError("prefix extend needs prefix_len > 0 and full "
                         "attention")
    B, P = tokens.shape
    x = L.embed(params["embed"], tokens, compute_dtype)
    positions = torch.arange(prefix_len, prefix_len + P, dtype=torch.float32,
                             device=x.device)
    pfx = None
    if prefix_kv is not None:
        pfx = prefix_kv.layers if isinstance(prefix_kv, DecodeCache) \
            else prefix_kv
        pfx = pfx["attn"] if isinstance(pfx, dict) else pfx
    ks, vs = [], []
    for l in range(cfg.n_layers):
        x, (k, v) = block_apply(
            layer_params(params["blocks"], l), cfg, x, positions,
            compute_dtype, attn_impl, return_kv=True,
            prefix_kv=None if pfx is None else (pfx[0][l], pfx[1][l]))
        ks.append(k)
        vs.append(v)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    rows = torch.arange(B, device=x.device)
    last = x[rows, lengths.long() - 1][:, None]
    logits = _logits(params, cfg, last, compute_dtype)

    cap = ATT.paged_capacity(cfg, max_len)
    rolling = bool(cfg.sliding_window)
    pos = (prefix_len + lengths.to(torch.int32))[None, :].repeat(
        cfg.n_layers, 1)
    att = ATT.KVCache(
        _cache_rows(torch.stack(ks), lengths, cap, rolling, cache_dtype,
                    prefix_len),
        _cache_rows(torch.stack(vs), lengths, cap, rolling, cache_dtype,
                    prefix_len), pos)
    return logits, DecodeCache({"attn": att})


def _layer_cache(att, l: int):
    """Layer l's cache as views of the stacked leaves (in-place writes
    land in the stack)."""
    return type(att)(*(t[l] for t in att))


def _block_decode(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                  cache, compute_dtype, attn_impl: str) -> torch.Tensor:
    """One token through one block. x: [B,1,D]; `cache` is this layer's
    paged or dense cache (its rows are written in place)."""
    h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if isinstance(cache, ATT.PagedKVCache):
        a, _ = ATT.gqa_paged_decode_step(params["attn"], cfg, h, cache,
                                         compute_dtype, attn_impl)
    else:
        a, _ = ATT.gqa_decode_step(params["attn"], cfg, h, cache,
                                   compute_dtype)
    x = x + a
    h = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + L.mlp_apply(params["mlp"], h, cfg.mlp_type, compute_dtype)


def decode_step(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                cache: DecodeCache, compute_dtype=torch.bfloat16,
                attn_impl: str = "kernel"
                ) -> Tuple[torch.Tensor, DecodeCache]:
    """tokens [B,1] -> (logits [B,1,V] fp32, cache), over a paged or a
    dense cache. The rows are written in place; the returned cache
    shares them and carries pos + 1."""
    att = cache.layers["attn"]
    x = L.embed(params["embed"], tokens, compute_dtype)
    for l in range(cfg.n_layers):
        x = _block_decode(layer_params(params["blocks"], l), cfg, x,
                          _layer_cache(att, l), compute_dtype, attn_impl)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (_logits(params, cfg, x, compute_dtype),
            DecodeCache({"attn": att._replace(pos=att.pos + 1)}))


def _block_verify(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                  cache, compute_dtype) -> torch.Tensor:
    """T speculative tokens through one block. x: [B,T,D]."""
    h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if isinstance(cache, ATT.PagedKVCache):
        a, _ = ATT.gqa_paged_verify_step(params["attn"], cfg, h, cache,
                                         compute_dtype)
    else:
        a, _ = ATT.gqa_verify_step(params["attn"], cfg, h, cache,
                                   compute_dtype)
    x = x + a
    h = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + L.mlp_apply(params["mlp"], h, cfg.mlp_type, compute_dtype)


def verify_step(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                cache: DecodeCache, compute_dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, DecodeCache]:
    """Speculative verification (transformer.py:517): tokens [B,T] =
    [last committed token, draft_1..draft_{T-1}] -> (logits [B,T,V]
    fp32, cache). ONE forward scores all T positions and writes their
    K/V rows in place; `pos` is UNCHANGED — the caller advances it by
    accepted + 1 (`engine/build.make_verify_step`), which is both the
    accept and the rollback."""
    att = cache.layers["attn"]
    x = L.embed(params["embed"], tokens, compute_dtype)
    for l in range(cfg.n_layers):
        x = _block_verify(layer_params(params["blocks"], l), cfg, x,
                          _layer_cache(att, l), compute_dtype)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x, compute_dtype), cache
