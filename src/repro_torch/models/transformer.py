"""Decoder-only LM assembly for every decoder family (the port of
`repro/models/transformer.py`):

    dense / moe : x += attn(norm(x));  x += mlp|moe(norm(x))
    hybrid      : x += (attn(norm(x)) + mamba(norm(x))) / 2   (hymba)
                  x += mlp(norm(x))
    ssm (rwkv)  : x += time_mix(norm(x));  x += channel_mix(norm(x))

`attn` is GQA or MLA (`cfg.attn_type`), and a MoE config's blocks route
through `moe.moe_apply`, which also returns the load-balance aux loss
that `lm_loss` adds with weight `aux_weight`. A MoE config with
`first_dense_layers > 0` keeps its first layers as a second stack,
`params["dense_blocks"]` (dense MLP blocks), run before `blocks`. A
frontend config (llava's vision stub) carries a `projector` that maps
precomputed patch embeddings into model space; `forward` / `lm_loss`
prepend them to the token embeddings.

Block params are stacked `[L, ...]` as in the reference (one leaf per
weight, layer on axis 0); a Python loop over layers takes the place of
`lax.scan`, reading each layer as views `blocks[...][l]`. Decode caches
stack the same way, one segment per block stack: `DecodeCache.layers`
for `blocks` and `DecodeCache.dense_layers` (the same shape, or None)
for `dense_blocks`. A segment is `{"attn": cache}` for the attention
families, `{"attn": cache, "mamba": MambaState}` for the hybrid and a
bare `RWKVState` for rwkv — the reference's layout. The attention cache
is a `PagedKVCache` (arenas `[L, num_pages, page_size, KV, Dh]`, page
tables `[L, B, P]`, positions `[L, B]`), a `KVCache` (dense rows
`[L, B, cap, KV, Dh]`, positions `[L, B]` per slot or `[L]`), or their
MLA counterparts `PagedMLACache` / `MLACache`, whose rows hold the
latent `c_kv` and the rope key. Recurrent state is dense per slot under
every layout (it is O(1) a slot), with the slot axis at 1 like every
other per-slot leaf.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from . import attention as ATT
from . import layers as L
from . import moe as MOE
from . import ssm as SSM

PyTree = Any


# ------------------------------------------------------------------- params
def _attn_spec(cfg: ModelConfig, Lyr: int) -> Dict[str, Any]:
    d, h = cfg.d_model, cfg.n_heads
    if cfg.attn_type == "mla":                       # attention.py:70
        qk_n, qk_r, vh = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
        ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
        return {"q_down": ((Lyr, d, ql), "dense", d),
                "q_up": ((Lyr, ql, h * (qk_n + qk_r)), "dense", ql),
                "kv_down": ((Lyr, d, kl + qk_r), "dense", d),
                "kv_up": ((Lyr, kl, h * (qk_n + vh)), "dense", kl),
                "wo": ((Lyr, h * vh, d), "dense", h * vh),
                "q_norm": {"scale": ((Lyr, ql), "ones", 0)},
                "kv_norm": {"scale": ((Lyr, kl), "ones", 0)}}
    kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    attn = {"wq": ((Lyr, d, h * dh), "dense", d),
            "wk": ((Lyr, d, kv * dh), "dense", d),
            "wv": ((Lyr, d, kv * dh), "dense", d),
            "wo": ((Lyr, h * dh, d), "dense", h * dh)}
    if cfg.qk_norm:
        attn["q_norm"] = ((Lyr, dh), "ones", 0)
        attn["k_norm"] = ((Lyr, dh), "ones", 0)
    return attn


def _mlp_spec(Lyr: int, d: int, f: int) -> Dict[str, Any]:
    return {"w_gate": ((Lyr, d, f), "dense", d),
            "w_up": ((Lyr, d, f), "dense", d),
            "w_down": ((Lyr, f, d), "dense", f)}


def _block_spec(cfg: ModelConfig, Lyr: int, moe_block: bool):
    d = cfg.d_model
    norm = lambda: {"scale": ((Lyr, d), "ones", 0)}
    if cfg.family == "ssm":                          # transformer.py:35
        return {"norm1": norm(), "time": SSM.rwkv_time_spec(cfg, Lyr),
                "norm2": norm(), "chan": SSM.rwkv_chan_spec(cfg, Lyr)}
    spec = {"norm1": norm(), "attn": _attn_spec(cfg, Lyr), "norm2": norm()}
    if cfg.family == "hybrid":
        spec["mamba"] = SSM.mamba_spec(cfg, Lyr)
    if not moe_block:
        spec["mlp"] = _mlp_spec(Lyr, d, cfg.d_ff)
        return spec
    # moe.py:26: the router at std 0.02; the stacked expert weights
    # [E, ...] take the reference's fan-in rule, the leading axis (E)
    E, ff = cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    moe = {"router": ((Lyr, d, E), "router", 0),
           "w_gate": ((Lyr, E, d, ff), "dense", E),
           "w_up": ((Lyr, E, d, ff), "dense", E),
           "w_down": ((Lyr, E, ff, d), "dense", E)}
    if cfg.n_shared_experts:
        moe["shared"] = _mlp_spec(Lyr, d, ff * cfg.n_shared_experts)
    spec["moe"] = moe
    return spec


def param_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """The params tree as (shape, init, fan_in) leaves — init is 'dense'
    (truncated normal, std 1/sqrt(fan_in)), 'embed' or 'router'
    (std 0.02), 'lora' (std 0.01), 'ones', or a number every element
    takes. The layout is `transformer.init_params`' (or, for an
    encoder-decoder, `encdec.init_params`') leaf for leaf: a MoE
    config's first `first_dense_layers` blocks are the separate
    `dense_blocks` stack."""
    if cfg.is_encoder_decoder:
        from . import encdec as ED
        return ED.param_spec(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    spec = {"embed": {"table": ((V, d), "embed", 0)},
            "final_norm": {"scale": ((d,), "ones", 0)}}
    if cfg.n_experts:
        n_dense = cfg.first_dense_layers
        if n_dense:
            spec["dense_blocks"] = _block_spec(cfg, n_dense, False)
        spec["blocks"] = _block_spec(cfg, cfg.n_layers - n_dense, True)
    else:
        spec["blocks"] = _block_spec(cfg, cfg.n_layers, False)
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"w": ((d, V), "dense", d)}
    fd = cfg.frontend_dim
    if cfg.frontend == "vision":                     # transformer.py:138
        spec["projector"] = {"w1": ((fd, d), "dense", fd),
                             "w2": ((d, d), "dense", d)}
    elif cfg.frontend == "audio":
        spec["projector"] = {"w1": ((fd, d), "dense", fd)}
    return spec


def _init_leaf(shape, kind, fan_in, dtype, generator, device):
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if not isinstance(kind, str):
        # a constant; through fp32, as the reference builds e.g. its
        # conv taps (1/K in fp32, then the param dtype)
        return torch.full(shape, float(kind), dtype=torch.float32,
                          device=device).to(dtype)
    std = {"embed": 0.02, "router": 0.02, "lora": 0.01}.get(kind) \
        or 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(shape, dtype=dtype, device=device)
    # stacked leaves draw one layer at a time: the fp32 draw is one layer,
    # made in place where the leaf is fp32
    rows = [out] if kind == "embed" or len(shape) == 2 else list(out)
    for r in rows:
        t = r if dtype == torch.float32 else torch.empty(
            r.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                                    generator=generator)
        if t is not r:
            r.copy_(t)
    return out


def init_leaves(cfg: ModelConfig, generator: torch.Generator,
                param_dtype=torch.float32,
                device: Optional[torch.device] = None):
    """`init_params`' leaves one at a time, in the order they are drawn:
    (path, leaf) pairs, each leaf made when it is asked for, so a caller
    that keeps only a part of each holds one whole leaf at a time."""
    device = generator.device if device is None else device
    # TP head padding (pad_heads_for_tp): a padded q head adds exactly
    # nothing, its wo rows zero (attention.py:49-67)
    pad = (cfg.orig_heads and cfg.orig_heads < cfg.n_heads
           and cfg.attn_type == "gqa")

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v, path + (k,))
            return
        x = _init_leaf(*node, param_dtype, generator, device)
        if pad and path[0] in ("dense_blocks", "blocks") \
                and path[1:] == ("attn", "wo"):
            x[:, cfg.orig_heads * cfg.resolved_head_dim:] = 0
        yield path, x
    yield from walk(param_spec(cfg), ())


def init_params(cfg: ModelConfig, generator: torch.Generator,
                param_dtype=torch.float32,
                device: Optional[torch.device] = None) -> PyTree:
    """Random weights from `generator`, drawn on its device (the numbers
    differ from the JAX package's: weights cross frameworks only through
    `repro_torch.bridge`)."""
    params: Dict[str, Any] = {}
    for path, x in init_leaves(cfg, generator, param_dtype, device):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return params


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters in the spec (api.py:160). active_only: the leaves under
    `moe` named w_gate / w_up / w_down (the shared experts' included, as
    the reference counts them) scaled by n_experts_per_tok / n_experts."""
    total = expert = 0

    def walk(node, path):
        nonlocal total, expert
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        n = int(np.prod(node[0]))
        total += n
        if "moe" in path and path[-1] in ("w_gate", "w_up", "w_down"):
            expert += n
    walk(param_spec(cfg), ())
    if active_only and cfg.n_experts:
        frac = cfg.n_experts_per_tok / cfg.n_experts
        total = total - expert + int(expert * frac)
    return total


def layer_params(blocks: PyTree, l: int) -> PyTree:
    """Layer l's params as views of the stacked [L, ...] leaves."""
    return {k: layer_params(v, l) if isinstance(v, dict) else v[l]
            for k, v in blocks.items()}


def _stack_layers(blocks: PyTree) -> int:
    node = blocks
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.shape[0]


def _segments(params: PyTree, cfg: ModelConfig):
    """(cache segment, block stack, moe_block) in run order: a MoE
    config's dense prefix first (`dense_blocks` -> `dense_layers`), then
    `blocks` -> `layers`."""
    segs = []
    if "dense_blocks" in params:
        segs.append(("dense_layers", params["dense_blocks"], False))
    segs.append(("layers", params["blocks"], bool(cfg.n_experts)))
    return segs


# ------------------------------------------------------------------- blocks
def block_apply(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, moe_block: bool = False,
                compute_dtype=torch.bfloat16, attn_impl: str = "kernel",
                return_kv: bool = False, prefix_kv=None,
                attn_chunk: int = 512, token_group=None, tp=None):
    """One block on [B,T,D] -> ([B,T,D], aux loss[, kv]) (transformer.py
    :56). kv (with return_kv; attention families only) is this block's
    decode-cache contribution: the RoPE'd (k, v) for GQA, the latents
    (c_kv, k_rope) for MLA. prefix_kv: this block's cached shared-prefix
    pair for the extend prefill (`positions` then starts at its length).
    MLA attention and the SSM mixers are plain torch whatever `attn_impl`
    says (the reference has no kernel for them). token_group: the ranks
    splitting this call's rows (`parallel.zero.TokenGroup`), for the MoE
    dispatch's whole-microbatch capacity and statistics. tp: this
    rank's model group (`parallel.tp.TensorParallel`, at this block's
    stack; GQA or MLA attention, the dense MLP or the MoE, training),
    the params then its shards."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_kv and cfg.family in ("ssm", "hybrid"):
        raise ValueError("fused kv capture needs an attention family")
    if cfg.family == "ssm":
        h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
        x = x + SSM.rwkv_time_forward(params["time"], cfg, h, compute_dtype)
        h = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
        prev = torch.zeros((x.shape[0], 1, x.shape[-1]), dtype=h.dtype,
                           device=x.device)
        return x + SSM.rwkv_chan_forward(params["chan"], cfg, h, prev,
                                         compute_dtype), zero
    h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if tp is not None:
        fwd = ATT.mla_forward_tp if cfg.attn_type == "mla" else \
            ATT.gqa_forward_tp
        x = x + fwd(params["attn"], cfg, h, positions, compute_dtype, tp,
                    attn_chunk)
        h = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
        if moe_block:
            m, aux = MOE.moe_apply(params["moe"], cfg, h, compute_dtype,
                                   token_group=token_group, tp=tp)
            return x + m, aux
        return x + L.mlp_apply(params["mlp"], h, cfg.mlp_type,
                               compute_dtype, tp), zero
    if cfg.attn_type == "mla":
        a = ATT.mla_forward(params["attn"], cfg, h, positions, compute_dtype,
                            return_kv=return_kv, prefix_kv=prefix_kv,
                            attn_chunk=attn_chunk)
    else:
        a = ATT.gqa_forward(params["attn"], cfg, h, positions, compute_dtype,
                            attn_impl, return_kv=return_kv,
                            prefix_kv=prefix_kv, attn_chunk=attn_chunk)
    if return_kv:
        a, kv = a
    if cfg.family == "hybrid":
        a = (a + SSM.mamba_forward(params["mamba"], cfg, h,
                                   compute_dtype)) * 0.5
    x = x + a
    h = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
    if moe_block:
        m, aux = MOE.moe_apply(params["moe"], cfg, h, compute_dtype,
                               token_group=token_group)
    else:
        m = L.mlp_apply(params["mlp"], h, cfg.mlp_type, compute_dtype)
        aux = zero
    return (x + m, aux, kv) if return_kv else (x + m, aux)


def _logits(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
            compute_dtype) -> torch.Tensor:
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x, compute_dtype)
    return L.lm_head(params["lm_head"], x, compute_dtype)


def _logits_tp(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
               compute_dtype, tp) -> torch.Tensor:
    """The head on this rank's shard: logits sharded over the vocab
    (a vocab-sharded lm_head or tied table: column-parallel), or whole
    after a contraction all-reduce (a d-split table, an lm_head sharded
    on d_model), or whole from a whole weight."""
    if cfg.tie_embeddings:
        w, dim = params["embed"]["table"].T, tp.dim("embed", "table")
        dim = None if dim is None else 1 - dim
    else:
        w, dim = params["lm_head"]["w"], tp.dim("lm_head", "w")
    return tp.linear(x.to(compute_dtype), w.to(compute_dtype),
                     dim).float()


def vocab_sharded(cfg: ModelConfig, tp) -> bool:
    """Whether `forward(..., tp=tp)` gives this rank's vocab slice of
    the logits (else the whole logits)."""
    if cfg.tie_embeddings:
        return tp.dim("embed", "table") == 0
    return tp.dim("lm_head", "w") == 1


def project_frontend(params: PyTree, cfg: ModelConfig, embeds: torch.Tensor,
                     compute_dtype=torch.bfloat16, tp=None) -> torch.Tensor:
    """Modality stub -> model space (transformer.py:152). embeds:
    [B, S, frontend_dim]; vision: w2 · gelu(w1 · e), audio: w1 · e. tp:
    on this rank's shards (sharding.py:184-189), w1 column-parallel,
    gelu on the rank's columns, w2 row-parallel (a w1 that the axis
    does not cut is whole, and w2 then a contraction)."""
    proj = params["projector"]
    cd = compute_dtype
    if tp is None:
        x = embeds.to(cd) @ proj["w1"].to(cd)
        if "w2" in proj:
            x = F.gelu(x, approximate="tanh") @ proj["w2"].to(cd)
        return x
    d1 = tp.dim("projector", "w1")
    x = tp.linear(embeds.to(cd), proj["w1"].to(cd), d1,
                  gather_out="w2" not in proj)
    if "w2" in proj:
        x = tp.linear(F.gelu(x, approximate="tanh"), proj["w2"].to(cd),
                      tp.dim("projector", "w2"), sharded_in=d1 == 1)
    return x


def _gathered_block(fs, blocks: PyTree, key: str, l: int, *args, **kw):
    """`block_apply` on layer l of a sharded stack, gathered here (inside
    the layer's checkpoint, so its recompute gathers again)."""
    return block_apply(fs.layer(blocks, key, l), *args, **kw)


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            compute_dtype=torch.bfloat16, attn_impl: str = "kernel",
            remat: bool = False, attn_chunk: int = 512,
            frontend_embeds: Optional[torch.Tensor] = None, *,
            fsdp=None, token_group=None, tp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,T] (+ frontend_embeds [B,S,frontend_dim] projected and
    prepended) -> (logits [B,S+T,V] fp32, aux loss summed over the MoE
    blocks; 0 without experts). remat: recompute each block in the
    backward pass instead of keeping its activations (`jax.checkpoint`
    per block, transformer.py:175). attn_chunk: query rows per chunk of
    the plain attention path.

    fsdp (an FSDP step across ranks, `parallel.zero.RankPlan.fsdp_step`):
    the params hold this rank's pieces, and `fsdp.tree(node, path)` /
    `fsdp.layer(blocks, key, l)` gather them: the embedding, lm_head and
    projector at their use, each block's layer just before it runs,
    inside its checkpoint. token_group: the ranks splitting this call's
    rows (`block_apply`). tp: a tensor-parallel forward on this rank's
    shards (the projector, and `block_apply` at each block's stack); the
    logits are then this rank's vocab slice where `vocab_sharded` says
    so."""
    fs, grp = fsdp, token_group
    whole = (lambda name: params[name]) if fs is None else \
        (lambda name: fs.tree(params[name], (name,)))
    emb = whole("embed")       # gathered once for a tied head's two uses
    x = L.embed(emb, tokens, compute_dtype, tp)
    if frontend_embeds is not None:
        x = torch.cat([project_frontend({"projector": whole("projector")},
                                        cfg, frontend_embeds, compute_dtype,
                                        tp), x], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.float32,
                             device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg, blocks, moe_block in _segments(params, cfg):
        key = "dense_blocks" if seg == "dense_layers" else "blocks"
        for l in range(_stack_layers(blocks)):
            if fs is None:
                fn, head = block_apply, (
                    layer_params(blocks, l) if tp is None
                    else tp.at(key).layer(blocks, l),)
            else:
                fn, head = _gathered_block, (fs, blocks, key, l)
            args = head + (cfg, x, positions, moe_block, compute_dtype,
                           attn_impl)
            kw = dict(attn_chunk=attn_chunk, token_group=grp,
                      tp=None if tp is None else tp.at(key))
            if remat:
                x, a = checkpoint(fn, *args, use_reentrant=False, **kw)
            else:
                x, a = fn(*args, **kw)
            aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = {"embed": emb} if cfg.tie_embeddings else \
        {"lm_head": whole("lm_head")}
    if tp is not None:
        return _logits_tp(head, cfg, x, compute_dtype, tp), aux
    return _logits(head, cfg, x, compute_dtype), aux


def masked_nll(logits: torch.Tensor, labels: torch.Tensor,
               token_group=None, tp=None) -> torch.Tensor:
    """Mean next-token cross entropy over the labels >= 0 (-100 =
    masked), in fp32. With a `token_group` (`parallel.zero.TokenGroup`)
    the mean is over the labels of the whole microbatch the group's
    ranks split (this rank's share of it). With `tp`, `logits` are this
    rank's vocab slice and the cross entropy is vocab-parallel: the row
    maximum, the sum of exponentials and the target logit are each
    all-reduced over the model group; no rank holds the whole logits."""
    labels = labels.long()
    mask = (labels >= 0).float()
    if tp is not None:
        nll = _vocab_parallel_nll(logits, labels, tp)
    else:
        nll = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                              labels.clamp(min=0).reshape(-1),
                              reduction="none")
    count = mask.sum()
    if token_group is not None:
        count = token_group.sum(count)
    return (nll * mask.reshape(-1)).sum() / count.clamp(min=1.0)


def _vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                        tp) -> torch.Tensor:
    """-log softmax(logits)[label] per row, the vocab split over the
    model group (rank m holds columns [m·V/M, (m+1)·V/M))."""
    n = logits.shape[-1]
    lf = logits.float().reshape(-1, n)
    lab = labels.reshape(-1) - tp.index * n
    mine = (lab >= 0) & (lab < n)
    mx = tp.max(lf.max(dim=-1).values.detach())
    total = tp.reduce(torch.exp(lf - mx[:, None]).sum(dim=-1))
    tgt = lf.gather(1, lab.clamp(0, n - 1)[:, None])[:, 0] * mine.float()
    return torch.log(total) + mx - tp.reduce(tgt)


def lm_loss(params: PyTree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            compute_dtype=torch.bfloat16, attn_chunk: int = 512,
            aux_weight: float = 0.01, remat: bool = True, *,
            fsdp=None, token_group=None, tp=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy plus `aux_weight` times the MoE aux loss
    (transformer.py:226-255). batch: tokens [B,T], labels [B,T] (-100 =
    masked), optional frontend_embeds (their positions take label -100).
    Attention runs the plain `_chunked_attention` on every device, as
    the reference's training loss does: the flash kernel is
    forward-only. fsdp, token_group, tp: a step across ranks (`forward`,
    `masked_nll`). Returns (total, {'loss', 'aux'})."""
    logits, aux = forward(params, cfg, batch["tokens"], compute_dtype,
                          "plain", remat, attn_chunk,
                          frontend_embeds=batch.get("frontend_embeds"),
                          fsdp=fsdp, token_group=token_group, tp=tp)
    labels = batch["labels"]
    pad = logits.shape[1] - labels.shape[1]
    if pad:                               # frontend positions prepended
        labels = torch.cat([torch.full((labels.shape[0], pad), -100,
                                       dtype=labels.dtype,
                                       device=labels.device), labels], 1)
    loss = masked_nll(logits, labels, token_group,
                      tp if tp is not None and vocab_sharded(cfg, tp)
                      else None)
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


# ------------------------------------------------------------------- decode
class DecodeCache(NamedTuple):
    """Per-layer caches stacked on a leading L axis, one segment per
    block stack: `layers` for `blocks`, `dense_layers` for a MoE
    config's `dense_blocks` (None without). A segment is a dict of
    cache nodes ({"attn": ...}, plus "mamba" for the hybrid) or one
    bare node (rwkv's RWKVState)."""
    layers: PyTree
    dense_layers: Optional[PyTree] = None


ATTN_CACHES = (ATT.KVCache, ATT.PagedKVCache, ATT.MLACache,
               ATT.PagedMLACache)
PAGED_CACHES = (ATT.PagedKVCache, ATT.PagedMLACache)


def _map_seg(fn: Callable, seg, *rest):
    if isinstance(seg, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in seg.items()}
    return fn(seg, *rest)


def map_nodes(fn: Callable, cache: DecodeCache,
              *rest: DecodeCache) -> DecodeCache:
    """A DecodeCache whose every node (attention cache or recurrent
    state) of every segment is fn(that node, the same node of each of
    `rest`)."""
    def one(name):
        seg = getattr(cache, name)
        if seg is None:
            return None
        return _map_seg(fn, seg, *(getattr(r, name) for r in rest))
    return DecodeCache(one("layers"), one("dense_layers"))


def map_segments(fn: Callable, cache: DecodeCache,
                 *rest: DecodeCache) -> DecodeCache:
    """`map_nodes` over the attention caches only; the recurrent nodes
    are `cache`'s own."""
    return map_nodes(lambda n, *r: fn(n, *r)
                     if isinstance(n, ATTN_CACHES) else n, cache, *rest)


def cache_nodes(cache: DecodeCache) -> List[Any]:
    """Every node of every segment present, in run order."""
    out = []
    for seg in (cache.dense_layers, cache.layers):
        if seg is not None:
            out += list(seg.values()) if isinstance(seg, dict) else [seg]
    return out


def cache_segments(cache: DecodeCache) -> List[Any]:
    """The attention caches of every segment present, in run order."""
    return [n for n in cache_nodes(cache) if isinstance(n, ATTN_CACHES)]


def _one_layer_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device: torch.device, per_slot: bool, paged):
    """transformer.py:258: rwkv's state; else the attention cache, with
    the hybrid's mamba state beside it (per-slot positions whenever the
    attention is paged)."""
    if cfg.family == "ssm":
        return SSM.rwkv_init_state(cfg, batch, dtype, device, per_slot)
    if paged is not None:
        ps, num_pages = paged
        init = (ATT.init_paged_mla_cache if cfg.attn_type == "mla"
                else ATT.init_paged_kv_cache)
        att = init(cfg, batch, max_len, ps, num_pages, dtype, device)
    else:
        init = ATT.init_mla_cache if cfg.attn_type == "mla" \
            else ATT.init_kv_cache
        att = init(cfg, batch, max_len, dtype, device, per_slot)
    seg = {"attn": att}
    if cfg.family == "hybrid":
        seg["mamba"] = SSM.mamba_init_state(cfg, batch, dtype, device,
                                            per_slot or paged is not None)
    return seg


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device: torch.device, per_slot: bool = False,
                      paged: Optional[Tuple[int, int]] = None
                      ) -> DecodeCache:
    """All zero. paged=(page_size, num_pages): per-layer page arenas
    `[L, num_pages, page_size, ...]`, int32 page tables
    `[L, B, pages_per_slot]` (every entry at trash page 0) and positions
    `[L, B]`. Otherwise dense rows `[L, B, cap, ...]` with positions
    `[L, B]` under per_slot (the serving layout: the slot axis is axis 1
    of every leaf) or `[L]` (the legacy batch loop). Recurrent state
    (rwkv, the hybrid's mamba heads) is `[L, B, ...]` under every
    layout. A MoE config with a dense prefix gets its `dense_layers`
    segment of the same kind."""
    one = _one_layer_cache(cfg, batch, max_len, dtype, device, per_slot,
                           paged)

    def stack(n):
        return _map_seg(lambda node: type(node)(
            *(t.unsqueeze(0).repeat((n,) + (1,) * t.dim()) for t in node)),
            one)
    n_dense = cfg.first_dense_layers if cfg.n_experts else 0
    return DecodeCache(stack(cfg.n_layers - n_dense),
                       stack(n_dense) if n_dense else None)


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
    """Fused serving prefill (transformer.py:339): ONE full-sequence
    forward that computes the last-prompt-position logits and every
    layer's cache rows, in both segments.

    tokens: [B,P] prompts right-padded to a common bucket length (causal
    attention makes the padding inert — but MoE routes the pad tokens
    too, and they take expert capacity, as in the reference); lengths:
    [B] true prompt lengths. Returns (logits [B,1,V] at position
    lengths-1, DecodeCache of dense rows — KVCache [L,B,cap,KV,Dh] or
    MLACache [L,B,max_len,·] — with pos = prefix_len + lengths).

    Shared-prefix extend: with `prefix_kv` (a DecodeCache of per-layer
    prefix pairs [L, 1|B, prefix_len, ...] in each segment, as
    `gather_prefix` returns, or the bare pair of a one-segment model)
    the tokens are the UNSHARED TAIL only — positions start at
    `prefix_len`, the forward attends to prefix + tail, and the rows
    hold the tail at its absolute positions."""
    if prefix_kv is not None and (prefix_len <= 0 or cfg.sliding_window):
        raise ValueError("prefix extend needs prefix_len > 0 and full "
                         "attention")
    B, P = tokens.shape
    x = L.embed(params["embed"], tokens, compute_dtype)
    positions = torch.arange(prefix_len, prefix_len + P, dtype=torch.float32,
                             device=x.device)
    # accept both the bare per-layer pair and the {"attn": pair} segments
    # that gather_prefix produces
    seg = lambda s: s["attn"] if isinstance(s, dict) else s
    pfx: Dict[str, Any] = {}
    if isinstance(prefix_kv, DecodeCache):
        pfx = {name: seg(getattr(prefix_kv, name))
               for name in ("layers", "dense_layers")
               if getattr(prefix_kv, name) is not None}
    elif prefix_kv is not None:
        pfx = {"layers": seg(prefix_kv)}
    kvs: Dict[str, list] = {}
    for name, blocks, moe_block in _segments(params, cfg):
        p_seg, pairs = pfx.get(name), []
        for l in range(_stack_layers(blocks)):
            x, _, kv = block_apply(
                layer_params(blocks, l), cfg, x, positions, moe_block,
                compute_dtype, attn_impl, return_kv=True,
                prefix_kv=None if p_seg is None else (p_seg[0][l],
                                                      p_seg[1][l]))
            pairs.append(kv)
        kvs[name] = pairs
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    rows = torch.arange(B, device=x.device)
    last = x[rows, lengths.long() - 1][:, None]
    logits = _logits(params, cfg, last, compute_dtype)

    def seg_cache(pairs):
        a, b = (torch.stack([p[i] for p in pairs]) for i in (0, 1))
        pos = (prefix_len + lengths.to(torch.int32))[None, :].repeat(
            len(pairs), 1)
        if cfg.attn_type == "mla":
            return {"attn": ATT.MLACache(
                _cache_rows(a, lengths, max_len, False, cache_dtype,
                            prefix_len),
                _cache_rows(b, lengths, max_len, False, cache_dtype,
                            prefix_len), pos)}
        cap = ATT.paged_capacity(cfg, max_len)
        rolling = bool(cfg.sliding_window)
        return {"attn": ATT.KVCache(
            _cache_rows(a, lengths, cap, rolling, cache_dtype, prefix_len),
            _cache_rows(b, lengths, cap, rolling, cache_dtype, prefix_len),
            pos)}
    dense = seg_cache(kvs["dense_layers"]) if "dense_layers" in kvs \
        else None
    return logits, DecodeCache(seg_cache(kvs["layers"]), dense)


def _layer_cache(seg, l: int):
    """Layer l's segment as views of the stacked leaves (in-place writes
    land in the stack)."""
    return _map_seg(lambda node: type(node)(*(t[l] for t in node)), seg)


def _write_state(dst, src) -> None:
    """Copy a new recurrent state into the cache's views, in place
    (every field but pos, which `decode_step` advances)."""
    for d, s in zip(dst[:-1], src[:-1]):
        d.copy_(s)


_DECODE = {ATT.PagedKVCache: ATT.gqa_paged_decode_step,
           ATT.KVCache: ATT.gqa_decode_step,
           ATT.PagedMLACache: ATT.mla_paged_decode_step,
           ATT.MLACache: ATT.mla_decode_step}
_VERIFY = {ATT.PagedKVCache: ATT.gqa_paged_verify_step,
           ATT.KVCache: ATT.gqa_verify_step,
           ATT.PagedMLACache: ATT.mla_paged_verify_step,
           ATT.MLACache: ATT.mla_verify_step}


def _ffn(params: PyTree, cfg: ModelConfig, x: torch.Tensor, moe_block: bool,
         compute_dtype) -> torch.Tensor:
    """x + mlp|moe(norm2(x)) (the aux loss of a serving call is unused,
    as in the reference's `_block_decode` / `_block_verify`)."""
    h = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
    if moe_block:
        return x + MOE.moe_apply(params["moe"], cfg, h, compute_dtype)[0]
    return x + L.mlp_apply(params["mlp"], h, cfg.mlp_type, compute_dtype)


def _block_decode(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                  cache, moe_block: bool, compute_dtype,
                  attn_impl: str) -> torch.Tensor:
    """One token through one block (transformer.py:420). x: [B,1,D];
    `cache` is this layer's segment: rwkv's state, or {"attn": any of
    the four attention caches[, "mamba": state]}. Rows and states are
    written in place. Only the GQA paged step goes through a kernel."""
    if cfg.family == "ssm":
        h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
        t_out, st = SSM.rwkv_decode_step(params["time"], cfg, h, cache,
                                         compute_dtype)
        x = x + t_out
        h = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
        c_out = SSM.rwkv_chan_forward(params["chan"], cfg, h,
                                      cache.x_chan[:, None], compute_dtype)
        _write_state(cache, st._replace(x_chan=h[:, 0]))
        return x + c_out
    h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    att = cache["attn"]
    step = _DECODE[type(att)]
    if isinstance(att, ATT.PagedKVCache):
        a, _ = step(params["attn"], cfg, h, att, compute_dtype, attn_impl)
    else:
        a, _ = step(params["attn"], cfg, h, att, compute_dtype)
    if cfg.family == "hybrid":
        m, ms = SSM.mamba_decode_step(params["mamba"], cfg, h,
                                      cache["mamba"], compute_dtype)
        a = (a + m) * 0.5
        _write_state(cache["mamba"], ms)
    return _ffn(params, cfg, x + a, moe_block, compute_dtype)


def decode_step(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                cache: DecodeCache, compute_dtype=torch.bfloat16,
                attn_impl: str = "kernel"
                ) -> Tuple[torch.Tensor, DecodeCache]:
    """tokens [B,1] -> (logits [B,1,V] fp32, cache), over a paged or a
    dense cache, through both segments. Rows and recurrent states are
    written in place; the returned cache shares them and carries every
    node's pos + 1."""
    x = L.embed(params["embed"], tokens, compute_dtype)
    for name, blocks, moe_block in _segments(params, cfg):
        seg = getattr(cache, name)
        for l in range(_stack_layers(blocks)):
            x = _block_decode(layer_params(blocks, l), cfg, x,
                              _layer_cache(seg, l), moe_block,
                              compute_dtype, attn_impl)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (_logits(params, cfg, x, compute_dtype),
            map_nodes(lambda a: a._replace(pos=a.pos + 1), cache))


def _block_verify(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                  cache, moe_block: bool, compute_dtype) -> torch.Tensor:
    """T speculative tokens through one block (transformer.py:489). x:
    [B,T,D]."""
    h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    a, _ = _VERIFY[type(cache)](params["attn"], cfg, h, cache,
                                compute_dtype)
    return _ffn(params, cfg, x + a, moe_block, compute_dtype)


def verify_step(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                cache: DecodeCache, compute_dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, DecodeCache]:
    """Speculative verification (transformer.py:517): tokens [B,T] =
    [last committed token, draft_1..draft_{T-1}] -> (logits [B,T,V]
    fp32, cache). ONE forward scores all T positions and writes their
    rows in place, in both segments; `pos` is UNCHANGED — the caller
    advances it by accepted + 1 (`engine/build.make_verify_step`), which
    is both the accept and the rollback."""
    x = L.embed(params["embed"], tokens, compute_dtype)
    for name, blocks, moe_block in _segments(params, cfg):
        att = getattr(cache, name)["attn"]
        for l in range(_stack_layers(blocks)):
            x = _block_verify(layer_params(blocks, l), cfg, x,
                              _layer_cache(att, l), moe_block,
                              compute_dtype)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x, compute_dtype), cache
