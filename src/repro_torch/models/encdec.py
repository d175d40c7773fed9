"""Encoder-decoder assembly (the port of `repro/models/encdec.py`, the
seamless-m4t-large-v2 backbone).

The speech frontend is a stub, as in the reference: the caller delivers
precomputed frame embeddings [B, S, frontend_dim], and a linear
projector maps them into the encoder. Encoder blocks are bidirectional
self-attention + MLP (RoPE on the frame positions); decoder blocks are
causal self-attention + cross-attention + MLP. Decode keeps a dense
self K/V cache (one shared position) beside the cross K/V computed once
from the encoder output.

Everything here is plain torch, as the reference's is plain `jnp`: no
kernel is called on these paths.

Mirrored on purpose: `init_cache` computes the cross K/V in bf16 and
its self cache defaults to bf16 whatever the compute dtype
(encdec.py:187-198), so an fp32 decode does not equal an fp32
`decode_train` to fp32 precision — in the reference as here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from . import attention as ATT
from . import layers as L

PyTree = Any


# ------------------------------------------------------------------- params
def param_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """`init_params` (encdec.py:60) as (shape, init, fan_in) leaves (see
    `transformer.param_spec`): `_enc_block_init` and `_dec_block_init`
    stacked over their layers, `_xattn_init` inside the decoder's."""
    from .transformer import _attn_spec, _mlp_spec
    d, V, f = cfg.d_model, cfg.vocab_size, cfg.d_ff
    hd = cfg.n_heads * cfg.resolved_head_dim
    fd = cfg.frontend_dim or d

    def norm(Lyr=None):
        return {"scale": (((Lyr, d) if Lyr else (d,)), "ones", 0)}
    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    return {
        "frontend_proj": ((fd, d), "dense", fd),
        "enc_blocks": {"norm1": norm(Le), "attn": _attn_spec(cfg, Le),
                       "norm2": norm(Le), "mlp": _mlp_spec(Le, d, f)},
        "enc_norm": norm(),
        "embed": {"table": ((V, d), "embed", 0)},
        "dec_blocks": {"norm1": norm(Ld), "attn": _attn_spec(cfg, Ld),
                       "norm_x": norm(Ld),
                       "xattn": {"wq": ((Ld, d, hd), "dense", d),
                                 "wk": ((Ld, d, hd), "dense", d),
                                 "wv": ((Ld, d, hd), "dense", d),
                                 "wo": ((Ld, hd, d), "dense", hd)},
                       "norm2": norm(Ld), "mlp": _mlp_spec(Ld, d, f)},
        "final_norm": norm(),
        "lm_head": {"w": ((d, V), "dense", d)},
    }


def _layers(blocks: PyTree):
    from .transformer import _stack_layers, layer_params
    return [layer_params(blocks, l) for l in range(_stack_layers(blocks))]


# ------------------------------------------------------------- attention
def _cross_attention(params, cfg, x, kv_k, kv_v, compute_dtype):
    """x: [B,T,D]; kv_k/kv_v: [B,S,H,Dh] precomputed from the encoder
    output (encdec.py:77). Scores in fp32, probabilities cast to the
    value dtype before P.V."""
    B, T, _ = x.shape
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    q = (x.to(compute_dtype) @ params["wq"].to(compute_dtype)
         ).reshape(B, T, h, dh)
    scores = torch.einsum("bthd,bshd->bhts", q.float(),
                          kv_k.float()) * (1.0 / math.sqrt(dh))
    probs = torch.softmax(scores, dim=-1).to(kv_v.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs, kv_v).reshape(B, T, h * dh)
    return out.to(compute_dtype) @ params["wo"].to(compute_dtype)


def cross_kv(params, cfg, enc_out, compute_dtype):
    B, S, _ = enc_out.shape
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    e = enc_out.to(compute_dtype)
    k = (e @ params["wk"].to(compute_dtype)).reshape(B, S, h, dh)
    v = (e @ params["wv"].to(compute_dtype)).reshape(B, S, h, dh)
    return k, v


def _run(body, bp, y, remat: bool):
    if remat:
        return checkpoint(body, bp, y, use_reentrant=False)
    return body(bp, y)


# --------------------------------------------------------------- forward
def encode(params: PyTree, cfg: ModelConfig, frames: torch.Tensor,
           compute_dtype=torch.bfloat16, attn_chunk: int = 512,
           remat: bool = False) -> torch.Tensor:
    """frames: [B,S,frontend_dim] -> encoder states [B,S,D]
    (encdec.py:98): bidirectional attention with RoPE on the frame
    positions, `attn_chunk` query rows at a time."""
    x = frames.to(compute_dtype) @ params["frontend_proj"].to(compute_dtype)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.float32, device=x.device)
    hh, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def body(bp, y):
        h = L.rmsnorm(bp["norm1"], y, cfg.norm_eps)
        B, T, _ = h.shape
        hc = h.to(compute_dtype)
        att = bp["attn"]
        q = (hc @ att["wq"].to(compute_dtype)).reshape(B, T, hh, dh)
        k = (hc @ att["wk"].to(compute_dtype)).reshape(B, T, kv, dh)
        v = (hc @ att["wv"].to(compute_dtype)).reshape(B, T, kv, dh)
        q = L.apply_rope(q, positions[None, :], cfg.rope_theta)
        k = L.apply_rope(k, positions[None, :], cfg.rope_theta)
        a = ATT._chunked_attention(q, k, v, positions, positions,
                                   causal=False, window=0, chunk=attn_chunk)
        y = y + a.reshape(B, T, hh * dh) @ att["wo"].to(compute_dtype)
        h = L.rmsnorm(bp["norm2"], y, cfg.norm_eps)
        return y + L.mlp_apply(bp["mlp"], h, cfg.mlp_type, compute_dtype)

    for bp in _layers(params["enc_blocks"]):
        x = _run(body, bp, x, remat)
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def decode_train(params: PyTree, cfg: ModelConfig, enc_out: torch.Tensor,
                 tokens: torch.Tensor, compute_dtype=torch.bfloat16,
                 attn_chunk: int = 512, remat: bool = False,
                 last_only: bool = False) -> torch.Tensor:
    """Teacher-forced decoder (encdec.py:135). tokens: [B,T] -> logits
    [B,T,V] fp32 (the last position alone with last_only)."""
    x = L.embed(params["embed"], tokens, compute_dtype)
    positions = torch.arange(x.shape[1], dtype=torch.float32,
                             device=x.device)

    def body(bp, y):
        h = L.rmsnorm(bp["norm1"], y, cfg.norm_eps)
        y = y + ATT.gqa_forward(bp["attn"], cfg, h, positions,
                                compute_dtype, "plain",
                                attn_chunk=attn_chunk)
        h = L.rmsnorm(bp["norm_x"], y, cfg.norm_eps)
        kk, vv = cross_kv(bp["xattn"], cfg, enc_out, compute_dtype)
        y = y + _cross_attention(bp["xattn"], cfg, h, kk, vv, compute_dtype)
        h = L.rmsnorm(bp["norm2"], y, cfg.norm_eps)
        return y + L.mlp_apply(bp["mlp"], h, cfg.mlp_type, compute_dtype)

    for bp in _layers(params["dec_blocks"]):
        x = _run(body, bp, x, remat)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:, :]
    return L.lm_head(params["lm_head"], x, compute_dtype)


def encdec_loss(params: PyTree, cfg: ModelConfig,
                batch: Dict[str, torch.Tensor], compute_dtype=torch.bfloat16,
                attn_chunk: int = 512, remat: bool = True, token_group=None):
    """Cross entropy of the decoder over `batch` (frontend_embeds [B,S,F],
    tokens, labels with -100 masked): (loss, {'loss', 'aux' = 0});
    token_group: `transformer.masked_nll`'s."""
    from .transformer import masked_nll
    enc = encode(params, cfg, batch["frontend_embeds"], compute_dtype,
                 attn_chunk, remat)
    logits = decode_train(params, cfg, enc, batch["tokens"], compute_dtype,
                          attn_chunk, remat)
    loss = masked_nll(logits, batch["labels"], token_group)
    return loss, {"loss": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=loss.device)}


# ---------------------------------------------------------------- decode
class EncDecCache(NamedTuple):
    self_cache: Any          # KVCache stacked [L, ...], pos [L]
    cross_k: torch.Tensor    # [L, B, S, H, Dh]
    cross_v: torch.Tensor


def init_cache(params: PyTree, cfg: ModelConfig, enc_out: torch.Tensor,
               max_len: int, dtype=torch.bfloat16) -> EncDecCache:
    """A zero self cache with one shared position, and every decoder
    layer's cross K/V of `enc_out`, computed in bf16 (encdec.py:187)."""
    B = enc_out.shape[0]
    one = ATT.init_kv_cache(cfg, B, max_len, dtype, enc_out.device)
    Ld = cfg.n_layers
    selfc = ATT.KVCache(*(t.unsqueeze(0).repeat((Ld,) + (1,) * t.dim())
                          for t in one))
    pairs = [cross_kv(bp["xattn"], cfg, enc_out, torch.bfloat16)
             for bp in _layers(params["dec_blocks"])]
    ck = torch.stack([k for k, _ in pairs]).to(dtype)
    cv = torch.stack([v for _, v in pairs]).to(dtype)
    return EncDecCache(selfc, ck, cv)


def decode_step(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                cache: EncDecCache, compute_dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, EncDecCache]:
    """tokens [B,1] -> (logits [B,1,V] fp32, cache) (encdec.py:201).
    The self rows are written in place; the returned cache shares them
    with pos + 1."""
    x = L.embed(params["embed"], tokens, compute_dtype)
    sc = cache.self_cache
    for l, bp in enumerate(_layers(params["dec_blocks"])):
        h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
        a, _ = ATT.gqa_decode_step(bp["attn"], cfg, h,
                                   ATT.KVCache(sc.k[l], sc.v[l], sc.pos[l]),
                                   compute_dtype)
        x = x + a
        h = L.rmsnorm(bp["norm_x"], x, cfg.norm_eps)
        x = x + _cross_attention(bp["xattn"], cfg, h, cache.cross_k[l],
                                 cache.cross_v[l], compute_dtype)
        h = L.rmsnorm(bp["norm2"], x, cfg.norm_eps)
        x = x + L.mlp_apply(bp["mlp"], h, cfg.mlp_type, compute_dtype)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.lm_head(params["lm_head"], x, compute_dtype)
    return logits, cache._replace(self_cache=sc._replace(pos=sc.pos + 1))
