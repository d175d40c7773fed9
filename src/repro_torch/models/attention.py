"""Attention for the decoders (the port of `repro/models/attention.py`):
GQA (with qk-norm and sliding windows) and MLA (multi-head latent
attention, minicpm3), each with a prefill forward, decode over a dense
per-slot cache or a page arena, and the multi-token speculative verify
over either.

MLA runs on plain torch ops everywhere, as the reference runs it on
plain `jnp` (only its GQA paths call the Pallas kernels): the prefill
materialises per-head k/v from the latent and takes the chunked exact
attention; decode and verify attend in the latent space (the absorbed
form), so the cache holds only the compressed latent `c_kv [.., kv_lora]`
and the shared rope key `k_rope [.., qk_rope]`. MLA has no window: its
layout is always linear.

Routing of the attention core (`attn_impl`):
  * "kernel" (the default) — the wrappers in `repro_torch.kernels`: on a
    CUDA tensor every prefill goes through the flash kernel at any T
    (the kernel masks ragged edges), the shared-prefix extend prefill
    included (the kernel takes q_offset = prefix length), and every
    paged decode through the paged-decode kernel. On a CPU tensor the
    same wrappers compute their plain versions.
  * "plain" — the plain versions on any device (the on-card reference
    `chip_smoke.py` compares the kernels against).

Paged layout as in the reference: K/V rows live in per-layer arenas
`[num_pages, page_size, KV, Dh]`, addressed through int32 page tables
[B, pages_per_slot]; physical page 0 is the trash page that free slots
and unallocated entries point at.

In place, unlike the reference: JAX rebuilds each arena and dense cache
functionally (`.at[].set`, attention.py:258-263, :352-356). Copying a
cache every decode step would swamp the card, so the steps here write
the new K/V rows into the cache tensors with `index_put_` and return the
same tensors with a new `pos`. Rows a verify writes beyond the accepted
prefix stay behind as garbage, masked by `pos` exactly as the
reference's are, and the next writes overwrite them. A caller that
decodes one cache under two param versions (a hot-reload transition
tick) keeps each version's rows apart itself (`engine/serving/engine.py`).
"""
from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as FA
from . import layers as L

PyTree = Any
ATTN_IMPLS = ("kernel", "plain")


def _flash(attn_impl: str, attn_chunk: int = 512):
    if attn_impl == "kernel":
        return FA.flash_attention
    return functools.partial(FA.flash_attention_ref, chunk=attn_chunk)


def _paged(attn_impl: str):
    return FA.paged_decode_attention if attn_impl == "kernel" \
        else FA.paged_decode_attention_ref


def convert_gqa_params(p: PyTree, cfg: ModelConfig, cfg_pad: ModelConfig,
                       dtype=torch.float32) -> PyTree:
    """Exact weight conversion for `pad_heads_for_tp` (attention.py:85-118
    of the reference) of one layer's GQA params, or of the stacked
    [L, ...] leaves: kv heads are block-duplicated f = kv2/kv times;
    the r-th real q head of kv group j goes to slot j·(h2/kv) + r, so
    the q -> kv map is kept; padded q slots get zero wq columns and zero
    wo rows (exactly no contribution)."""
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    h2, kv2 = cfg_pad.n_heads, cfg_pad.n_kv_heads
    f = kv2 // kv
    G, G2 = h // kv, h2 // kv2
    if kv2 != kv * f or h2 != kv * f * G2 or G > f * G2:
        raise ValueError(f"{cfg_pad.name}: {h2}/{kv2} heads are not a "
                         f"padding of {h}/{kv}")
    wq, wo = p["wq"], p["wo"]
    lead = wq.shape[:-2]
    d = wq.shape[-2]
    slots = torch.tensor([(i // G) * (f * G2) + i % G for i in range(h)],
                         device=wq.device)
    wq2 = torch.zeros(lead + (d, h2, dh), dtype=dtype, device=wq.device)
    wq2[..., slots, :] = wq.reshape(lead + (d, h, dh)).to(dtype)
    wo2 = torch.zeros(lead + (h2, dh, wo.shape[-1]), dtype=dtype,
                      device=wo.device)
    wo2[..., slots, :, :] = wo.reshape(lead + (h, dh, -1)).to(dtype)

    def dup(w):
        w = w.reshape(lead + (d, kv, dh)).repeat_interleave(f, dim=-2)
        return w.reshape(lead + (d, kv2 * dh))

    return dict(p, wq=wq2.reshape(lead + (d, h2 * dh)), wk=dup(p["wk"]),
                wv=dup(p["wv"]), wo=wo2.reshape(lead + (h2 * dh, -1)))


# ------------------------------------------------------- chunked core attn
# the reference's query-chunked exact attention on explicit positions; one
# implementation, beside the kernel it is the plain version of
_chunked_attention = FA.chunked_attention


# ------------------------------------------------------------- GQA forward
def _qkv(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor, compute_dtype):
    """Projections, qk-norm and RoPE. positions broadcastable to [B, T]."""
    B, T, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    x = x.to(compute_dtype)
    q = (x @ params["wq"].to(compute_dtype)).reshape(B, T, h, dh)
    k = (x @ params["wk"].to(compute_dtype)).reshape(B, T, kv, dh)
    v = (x @ params["wv"].to(compute_dtype)).reshape(B, T, kv, dh)
    if cfg.qk_norm:
        q = L.headwise_rmsnorm(params["q_norm"], q)
        k = L.headwise_rmsnorm(params["k_norm"], k)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, compute_dtype=torch.bfloat16,
                attn_impl: str = "kernel", return_kv: bool = False,
                prefix_kv=None, attn_chunk: int = 512):
    """Prefill forward. x: [B,T,D]; positions: [T] (fp32, contiguous from
    positions[0]). attn_chunk: query rows per chunk of the plain path.

    return_kv: also return the RoPE'd (k, v) a decode cache stores.
    prefix_kv: (k, v) [B|1, S0, KV, Dh] of a cached shared prefix at
    positions 0..S0-1; `positions` then starts at S0 and the tail
    attends to prefix + tail through the flash path with q_offset = S0
    (the reference sends this case to `_chunked_attention`,
    attention.py:193-206 — same math on the same positions)."""
    B, T, _ = x.shape
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _qkv(params, cfg, x, positions[None, :], compute_dtype)
    flash = _flash(attn_impl, attn_chunk)
    if prefix_kv is not None:
        if cfg.sliding_window:
            raise ValueError("shared-prefix extend needs full attention "
                             "(rolling pages churn)")
        pk, pv = prefix_kv
        S0 = pk.shape[1]
        k_att = torch.cat([pk.to(k.dtype).expand(B, -1, -1, -1), k], dim=1)
        v_att = torch.cat([pv.to(v.dtype).expand(B, -1, -1, -1), v], dim=1)
        out = flash(q, k_att, v_att, causal=True, window=0, q_offset=S0)
    else:
        out = flash(q, k, v, causal=True, window=cfg.sliding_window)
    out = out.reshape(B, T, h * dh) @ params["wo"].to(compute_dtype)
    if return_kv:
        return out, (k, v)
    return out


def gqa_forward_tp(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, compute_dtype, tp,
                   attn_chunk: int = 512) -> torch.Tensor:
    """The training forward of `gqa_forward` on this rank's shards
    (`parallel.tp`), plain attention. Each projection takes the
    collective its spec gives:
      * q: h/M local heads (column) where the model axis divides h;
        else the whole q (contraction, or whole weights), and the
        attention core then runs whole on every rank, its wo d-split or
        whole (the reference's sharding.py:6-11);
      * k, v: kv/M local heads where M divides kv; else the whole k, v,
        of which a rank with local q heads takes the kv heads they read
        (repeated per q head where its heads straddle a kv group);
        whole k, v beside whole q are gathered whole;
      * wo: row-parallel over local heads.
    qk-norm's scales on local heads sum their gradients over the group
    (`tp.copy`)."""
    B, T, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    cd = compute_dtype
    x = x.to(cd)
    dq, dk, dv, do = (tp.dim("attn", n) for n in ("wq", "wk", "wv", "wo"))
    xc = tp.copy(x) if 1 in (dq, dk, dv) else None
    xs = tp.scatter(x, -1) if 0 in (dq, dk, dv) else None

    def proj(w, d):
        w = w.to(cd)
        if d == 1:
            return xc @ w
        if d == 0:
            return tp.reduce(xs @ w)
        return x @ w

    q_local, kv_local = dq == 1, dk == 1
    hl = h // tp.size if q_local else h
    kl = kv // tp.size if kv_local else kv
    q = proj(params["wq"], dq).reshape(B, T, hl, dh)
    k = proj(params["wk"], dk).reshape(B, T, kl, dh)
    v = proj(params["wv"], dv).reshape(B, T, kl, dh)
    if cfg.qk_norm:
        qn, kn = params["q_norm"], params["k_norm"]
        q = L.headwise_rmsnorm(tp.copy(qn) if q_local else qn, q)
        k = L.headwise_rmsnorm(tp.copy(kn) if kv_local else kn, k)
    pos = positions[None, :]
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    if q_local and not kv_local:
        # whole k, v: the kv heads this rank's q heads read
        G = h // kv
        heads = torch.arange(tp.index * hl, (tp.index + 1) * hl,
                             device=x.device) // G
        if hl % G == 0:
            heads = heads[::G]
        elif G % hl == 0:
            heads = heads[:1]
        k, v = tp.copy(k)[:, :, heads], tp.copy(v)[:, :, heads]
    elif not q_local and kv_local:
        k, v = tp.gather(k, 2), tp.gather(v, 2)
    out = FA.flash_attention_ref(q, k, v, causal=True,
                                 window=cfg.sliding_window, chunk=attn_chunk)
    out = out.reshape(B, T, hl * dh)
    wo = params["wo"].to(cd)
    if do == 0:
        return tp.reduce(out @ wo)
    if do == 1:
        return tp.gather(tp.copy(out) @ wo, -1)
    return out @ wo


# --------------------------------------------------------------- KV caches
class KVCache(NamedTuple):
    """Dense per-slot rows: the decode cache of kv_layout='dense' and the
    draft, and what the prefill emits before the engine scatters it into
    the page arena. Inside a DecodeCache every field gains a leading
    layer axis."""
    k: torch.Tensor      # [B, cap, KV, Dh] (RoPE'd at write)
    v: torch.Tensor      # [B, cap, KV, Dh]
    pos: torch.Tensor    # int32 tokens seen: [B] per slot, or a scalar


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device: torch.device, per_slot: bool = False) -> KVCache:
    """Zero rows [B, cap, KV, Dh] (cap: the window for SWA, else
    max_len); pos int32 [B] with per_slot, else one scalar."""
    cap = paged_capacity(cfg, max_len)
    kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    return KVCache(
        torch.zeros((batch, cap, kv, dh), dtype=dtype, device=device),
        torch.zeros((batch, cap, kv, dh), dtype=dtype, device=device),
        torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                    device=device))


def _write_row(pos: torch.Tensor, cap: int, cfg: ModelConfig) -> torch.Tensor:
    """The cache row position `pos` writes: rolling for SWA, clamped to
    the last row otherwise."""
    return pos % cap if cfg.sliding_window > 0 else torch.clamp(pos,
                                                                max=cap - 1)


def gqa_decode_step(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                    cache: KVCache, compute_dtype=torch.bfloat16
                    ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode over the dense cache. x: [B,1,D].

    cache.pos scalar: every row at the same position (the legacy batch
    loop). cache.pos [B]: slotted serving — each row writes and masks at
    its own position. Writes the new K/V rows in place; returns (out
    [B,1,D], cache with pos + 1 and the same row tensors)."""
    B = x.shape[0]
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    cap = cache.k.shape[1]
    pos = cache.pos
    per_slot = pos.dim() == 1
    posv = (pos[:, None] if per_slot else pos.reshape(1, 1)).float()
    q, k, v = _qkv(params, cfg, x, posv, compute_dtype)
    row = _write_row(pos, cap, cfg)
    if per_slot:
        rows_b = torch.arange(B, device=x.device)
        cache.k.index_put_((rows_b, row.long()), k[:, 0].to(cache.k.dtype))
        cache.v.index_put_((rows_b, row.long()), v[:, 0].to(cache.v.dtype))
    else:
        cache.k.index_copy_(1, row.reshape(1).long(), k.to(cache.k.dtype))
        cache.v.index_copy_(1, row.reshape(1).long(), v.to(cache.v.dtype))
    out = FA.masked_decode_attention(q[:, 0], cache.k, cache.v, pos,
                                     rolling=cfg.sliding_window > 0)
    out = out.reshape(B, 1, h * dh).to(compute_dtype) \
        @ params["wo"].to(compute_dtype)
    return out, cache._replace(pos=pos + 1)


class PagedKVCache(NamedTuple):
    """GQA cache over a global page arena (vLLM-style PagedAttention).

    Logical row r of slot b lives at arena[page_table[b, r // ps], r % ps]
    where ps = page_size; pages_per_slot * ps == the dense capacity.
    Inside a DecodeCache every field gains a leading layer axis."""
    k: torch.Tensor           # [num_pages, page_size, KV, Dh] (RoPE'd)
    v: torch.Tensor           # [num_pages, page_size, KV, Dh]
    page_table: torch.Tensor  # int32 [B, pages_per_slot]; 0 = trash page
    pos: torch.Tensor         # int32 [B] tokens seen


def paged_capacity(cfg: ModelConfig, max_len: int) -> int:
    """The dense capacity a paged slot must reproduce (rolling window
    for SWA, max_len otherwise)."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_paged_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                        page_size: int, num_pages: int, dtype,
                        device: torch.device) -> PagedKVCache:
    cap = paged_capacity(cfg, max_len)
    if page_size <= 0 or cap % page_size:
        raise ValueError(f"capacity {cap} is not a multiple of page_size "
                         f"{page_size}")
    kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    return PagedKVCache(
        torch.zeros((num_pages, page_size, kv, dh), dtype=dtype,
                    device=device),
        torch.zeros((num_pages, page_size, kv, dh), dtype=dtype,
                    device=device),
        torch.zeros((batch, cap // page_size), dtype=torch.int32,
                    device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def _paged_slot(table: torch.Tensor, row: torch.Tensor, ps: int):
    """(physical page, offset) per slot for logical row `row` [B]."""
    pg = torch.gather(table, 1, (row // ps)[:, None].long())[:, 0]
    return pg, row % ps


def _paged_write(arena: torch.Tensor, pg: torch.Tensor, off: torch.Tensor,
                 val: torch.Tensor) -> None:
    """Write one row per slot at (page, offset), IN PLACE. Free slots'
    tables point at trash page 0, so their garbage writes are inert."""
    arena.index_put_((pg.long(), off.long()), val.to(arena.dtype))


def gqa_paged_decode_step(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                          cache: PagedKVCache, compute_dtype=torch.bfloat16,
                          attn_impl: str = "kernel"
                          ) -> Tuple[torch.Tensor, PagedKVCache]:
    """One-token decode over the paged arena. x: [B,1,D]. Writes the new
    K/V rows into the arena in place; returns (out [B,1,D], cache with
    pos + 1 and the same arena tensors)."""
    B = x.shape[0]
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    ps = cache.k.shape[1]
    cap = cache.page_table.shape[1] * ps
    pos = cache.pos
    q, k, v = _qkv(params, cfg, x, pos[:, None].float(), compute_dtype)
    row = _write_row(pos, cap, cfg)
    pg, off = _paged_slot(cache.page_table, row, ps)
    _paged_write(cache.k, pg, off, k[:, 0])
    _paged_write(cache.v, pg, off, v[:, 0])
    out = _paged(attn_impl)(q[:, 0].contiguous(), cache.k, cache.v,
                            cache.page_table, pos,
                            rolling=cfg.sliding_window > 0)
    out = out.reshape(B, 1, h * dh).to(compute_dtype) \
        @ params["wo"].to(compute_dtype)
    return out, cache._replace(pos=pos + 1)


# ------------------------------------------------- speculative verification
#
# Multi-token verify for speculative decoding (attention.py:412-532): x
# holds the embeds of [last committed token, draft_1 .. draft_{T-1}] and
# row b scores positions pos_b..pos_b+T-1 against the cache in ONE
# forward. All T K/V rows are written first, then query t masks rows at
# positions > pos_b + t to NEG_INF — the key set a one-token decode at
# pos_b + t sees. The returned cache keeps `pos` UNCHANGED: the caller
# commits the accepted prefix by rewriting pos (and, paged, page-table
# values); rejected rows beyond the new pos stay as masked garbage.
#
# Caller contract (the engine runs a plain tick otherwise): per-slot pos
# [B], and pos + T - 1 < capacity for every live row — no rolling wrap
# and no clamping, so live rows are written at exactly pos + t.

def _verify_rows(cfg: ModelConfig, pos: torch.Tensor, T: int, cap: int):
    """(absolute positions [B,T], write rows [B,T]). For live rows
    rows == positions; the mod/min only keeps free-slot rows in bounds."""
    post = pos.long()[:, None] + torch.arange(T, device=pos.device)
    return post, _write_row(post, cap, cfg)


def _verify_valid(cfg: ModelConfig, post: torch.Tensor, cap: int):
    """Validity [B,T,cap]: query t sees exactly the rows a one-token
    decode at pos+t would (rolling or linear)."""
    B, T = post.shape
    idx = torch.arange(cap, device=post.device)
    posb = post[:, :, None]                                  # [B,T,1]
    if cfg.sliding_window:
        slot_pos = posb - torch.remainder(posb - idx[None, None, :], cap)
    else:
        slot_pos = idx[None, None, :].expand(B, T, cap)
    return (slot_pos >= 0) & (slot_pos <= posb)


def _gqa_verify_attend(params: PyTree, cfg: ModelConfig, q: torch.Tensor,
                       kfull: torch.Tensor, vfull: torch.Tensor,
                       valid: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Masked multi-position GQA attention: q [B,T,H,Dh] against dense
    rows [B,cap,KV,Dh] under `valid` [B,T,cap]; scores in fp32, masked to
    NEG_INF, softmax, probabilities cast to the value dtype; then `wo`."""
    B, T = q.shape[:2]
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(B, T, kvh, h // kvh, dh)
    scores = torch.einsum("btkgd,bskd->btkgs", qg.float(),
                          kfull.float()) * scale
    scores = torch.where(valid[:, :, None, None, :], scores, FA.NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(vfull.dtype)
    out = torch.einsum("btkgs,bskd->btkgd", probs, vfull).reshape(B, T,
                                                                  h * dh)
    return out.to(compute_dtype) @ params["wo"].to(compute_dtype)


def gqa_verify_step(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                    cache: KVCache, compute_dtype=torch.bfloat16
                    ) -> Tuple[torch.Tensor, KVCache]:
    """T-token verify over the dense slotted cache. x: [B,T,D]. Writes
    rows pos..pos+T-1 in place; returns (out [B,T,D], cache, pos
    unchanged)."""
    B, T, _ = x.shape
    cap = cache.k.shape[1]
    post, row = _verify_rows(cfg, cache.pos, T, cap)
    q, k, v = _qkv(params, cfg, x, post.float(), compute_dtype)
    rows_b = torch.arange(B, device=x.device)[:, None].expand(B, T)
    cache.k.index_put_((rows_b, row), k.to(cache.k.dtype))
    cache.v.index_put_((rows_b, row), v.to(cache.v.dtype))
    out = _gqa_verify_attend(params, cfg, q, cache.k, cache.v,
                             _verify_valid(cfg, post, cap), compute_dtype)
    return out, cache


def gqa_paged_verify_step(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                          cache: PagedKVCache, compute_dtype=torch.bfloat16
                          ) -> Tuple[torch.Tensor, PagedKVCache]:
    """T-token verify over the paged arena: the math of `gqa_verify_step`
    on each slot's gathered pages (free slots write through trash page 0,
    inert as ever). Returns (out [B,T,D], cache, pos unchanged)."""
    B, T, _ = x.shape
    kvh, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    ps = cache.k.shape[1]
    cap = cache.page_table.shape[1] * ps
    post, row = _verify_rows(cfg, cache.pos, T, cap)
    q, k, v = _qkv(params, cfg, x, post.float(), compute_dtype)
    pgs = torch.gather(cache.page_table.long(), 1, row // ps)
    offs = row % ps
    cache.k.index_put_((pgs, offs), k.to(cache.k.dtype))
    cache.v.index_put_((pgs, offs), v.to(cache.v.dtype))
    idx = cache.page_table.long()
    kfull = cache.k[idx].reshape(B, cap, kvh, dh)
    vfull = cache.v[idx].reshape(B, cap, kvh, dh)
    out = _gqa_verify_attend(params, cfg, q, kfull, vfull,
                             _verify_valid(cfg, post, cap), compute_dtype)
    return out, cache


# ---------------------------------------------------------------- MLA path
class MLACache(NamedTuple):
    """Dense per-slot latent rows (attention.py:605). Inside a
    DecodeCache every field gains a leading layer axis."""
    c_kv: torch.Tensor    # [B, cap, kv_lora]
    k_rope: torch.Tensor  # [B, cap, qk_rope] (RoPE'd at write)
    pos: torch.Tensor     # int32 tokens seen: [B] per slot, or a scalar


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device: torch.device, per_slot: bool = False) -> MLACache:
    return MLACache(
        torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dtype,
                    device=device),
        torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                    device=device))


class PagedMLACache(NamedTuple):
    """The MLA latent cache over a page arena (attention.py:305), with
    the addressing of `PagedKVCache`."""
    c_kv: torch.Tensor        # [num_pages, page_size, kv_lora]
    k_rope: torch.Tensor      # [num_pages, page_size, qk_rope]
    page_table: torch.Tensor  # int32 [B, pages_per_slot]; 0 = trash page
    pos: torch.Tensor         # int32 [B]


def init_paged_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                         page_size: int, num_pages: int, dtype,
                         device: torch.device) -> PagedMLACache:
    if page_size <= 0 or max_len % page_size:
        raise ValueError(f"capacity {max_len} is not a multiple of "
                         f"page_size {page_size}")
    return PagedMLACache(
        torch.zeros((num_pages, page_size, cfg.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((num_pages, page_size, cfg.qk_rope_head_dim),
                    dtype=dtype, device=device),
        torch.zeros((batch, max_len // page_size), dtype=torch.int32,
                    device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def _mla_qkv(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, compute_dtype):
    """(q_nope [B,T,H,n], q_rope [B,T,H,r] RoPE'd, c_kv [B,T,kv_lora]
    normed, k_rope [B,T,r] RoPE'd) of x [B,T,D] already in the compute
    dtype; positions broadcastable to [B, T]."""
    B, T, _ = x.shape
    h = cfg.n_heads
    qk_n, qk_r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = L.rmsnorm(params["q_norm"], x @ params["q_down"].to(compute_dtype),
                   cfg.norm_eps)
    q = (cq @ params["q_up"].to(compute_dtype)).reshape(B, T, h, qk_n + qk_r)
    q_nope, q_rope = q[..., :qk_n], q[..., qk_n:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_full = x @ params["kv_down"].to(compute_dtype)
    c_kv = L.rmsnorm(params["kv_norm"], ckv_full[..., :cfg.kv_lora_rank],
                     cfg.norm_eps)
    k_rope = ckv_full[..., cfg.kv_lora_rank:][:, :, None, :]  # 1 shared head
    k_rope = L.apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, compute_dtype=torch.bfloat16,
                return_kv: bool = False, prefix_kv=None,
                attn_chunk: int = 512):
    """Training / prefill MLA (attention.py:636): per-head k/v
    materialised from the latent, then the chunked exact attention with
    q/k head dim qk_nope + qk_rope and v head dim v_head.

    return_kv: also return the latents (c_kv, k_rope) a decode cache
    stores. prefix_kv: (c_kv, k_rope) [B|1, S0, ...] of a cached shared
    prefix; `positions` then starts at S0 (the extend prefill computes
    the tail only)."""
    B, T, _ = x.shape
    h = cfg.n_heads
    qk_n, qk_r, vh = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    x = x.to(compute_dtype)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, cfg, x,
                                            positions[None, :], compute_dtype)
    c_all, r_all, positions_k = c_kv, k_rope, positions
    if prefix_kv is not None:
        pc, pr = prefix_kv
        S0 = pc.shape[1]
        c_all = torch.cat([pc.to(c_kv.dtype).expand(B, -1, -1), c_kv], dim=1)
        r_all = torch.cat([pr.to(k_rope.dtype).expand(B, -1, -1), k_rope],
                          dim=1)
        positions_k = torch.cat([torch.arange(S0, dtype=positions.dtype,
                                              device=positions.device),
                                 positions])
    S = c_all.shape[1]
    kv = (c_all @ params["kv_up"].to(compute_dtype)).reshape(B, S, h,
                                                             qk_n + vh)
    k_nope, v = kv[..., :qk_n], kv[..., qk_n:]
    # the shared rope key joins every head's key by concatenation
    k = torch.cat([k_nope, r_all[:, :, None, :].expand(B, S, h, qk_r)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = _chunked_attention(q, k, v, positions, positions_k, causal=True,
                             window=0, chunk=attn_chunk)
    out = out.reshape(B, T, h * vh) @ params["wo"].to(compute_dtype)
    if return_kv:
        return out, (c_kv, k_rope)
    return out


def mla_forward_tp(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, compute_dtype, tp,
                   attn_chunk: int = 512) -> torch.Tensor:
    """The training forward of `mla_forward` on this rank's shards
    (`parallel.tp`, the reference's specs, sharding.py:173-178):
      * q_down column-parallel where the axis divides q_lora_rank, its
        latent gathered whole (q_norm is an RMSNorm over the whole
        latent), else a contraction; kv_down a contraction, the whole
        [kv_lora + rope] latent on every rank, then kv_norm;
      * q_up and kv_up column-parallel over h/M local heads (each head's
        columns contiguous) where the axis divides the heads, else
        contractions and every head on every rank;
      * wo row-parallel over local heads, else d-split out.
    The shared rope key is whole on every rank; beside local heads it
    goes through `tp.copy`, so its gradient is the group's sum."""
    B, T, _ = x.shape
    h = cfg.n_heads
    qk_n, qk_r, vh = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    cd = compute_dtype
    x = x.to(cd)
    dim = lambda n: tp.dim("attn", n)
    w = lambda n: params[n].to(cd)
    pos = positions[None, :]
    cq = L.rmsnorm(params["q_norm"],
                   tp.linear(x, w("q_down"), dim("q_down"), gather_out=True),
                   cfg.norm_eps)
    local = dim("q_up") == 1
    hl = h // tp.size if local else h
    q = tp.linear(cq, w("q_up"), dim("q_up")).reshape(B, T, hl, qk_n + qk_r)
    q_nope, q_rope = q[..., :qk_n], q[..., qk_n:]
    q_rope = L.apply_rope(q_rope, pos, cfg.rope_theta)
    ckv_full = tp.linear(x, w("kv_down"), dim("kv_down"))
    c_kv = L.rmsnorm(params["kv_norm"], ckv_full[..., :cfg.kv_lora_rank],
                     cfg.norm_eps)
    k_rope = ckv_full[..., cfg.kv_lora_rank:][:, :, None, :]
    k_rope = L.apply_rope(k_rope, pos, cfg.rope_theta)[:, :, 0]
    if local:
        k_rope = tp.copy(k_rope)
    kv = tp.linear(c_kv, w("kv_up"), dim("kv_up")).reshape(B, T, hl,
                                                           qk_n + vh)
    k_nope, v = kv[..., :qk_n], kv[..., qk_n:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, T, hl, qk_r)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = _chunked_attention(q, k, v, positions, positions, causal=True,
                             window=0, chunk=attn_chunk)
    return tp.linear(out.reshape(B, T, hl * vh), w("wo"), dim("wo"),
                     sharded_in=local, gather_out=True)


def _mla_attend(params: PyTree, cfg: ModelConfig, q_nope: torch.Tensor,
                q_rope: torch.Tensor, cfull: torch.Tensor,
                rfull: torch.Tensor, valid: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    """Absorbed-latent attention (attention.py:533-556, :707-723): q
    [B,T,H,·] against the latent rows [B,cap,·] under `valid`
    [B|1,T,cap]. q_nope folds into the latent space through kv_up's key
    half; scores in fp32, masked to NEG_INF, softmax, probabilities cast
    to the cache dtype; the latent context maps back through kv_up's
    value half, then `wo`."""
    B, T = q_nope.shape[:2]
    h = cfg.n_heads
    qk_n, qk_r, vh, r = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
    kv_up = params["kv_up"].to(compute_dtype).reshape(r, h, qk_n + vh)
    w_k, w_v = kv_up[..., :qk_n], kv_up[..., qk_n:]
    q_eff = torch.einsum("bthn,rhn->bthr", q_nope, w_k)
    scores = (torch.einsum("bthr,bsr->bths", q_eff.float(), cfull.float())
              + torch.einsum("bthr,bsr->bths", q_rope.float(),
                             rfull.float()))
    scores = scores / math.sqrt(qk_n + qk_r)
    scores = torch.where(valid[:, :, None, :], scores, FA.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    lat = torch.einsum("bths,bsr->bthr", probs.to(cfull.dtype), cfull)
    out = torch.einsum("bthr,rhv->bthv", lat, w_v).reshape(B, T, h * vh)
    return out.to(compute_dtype) @ params["wo"].to(compute_dtype)


def mla_decode_step(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                    cache: MLACache, compute_dtype=torch.bfloat16
                    ) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed-latent one-token decode over the dense latent cache
    (attention.py:679). cache.pos [B]: per slot; scalar: one shared
    position. Writes the new latent row in place; returns (out [B,1,D],
    cache with pos + 1 and the same row tensors)."""
    B = x.shape[0]
    cap = cache.c_kv.shape[1]
    pos = cache.pos
    per_slot = pos.dim() == 1
    posb = pos[:, None] if per_slot else pos.reshape(1, 1)       # [B|1, 1]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(
        params, cfg, x.to(compute_dtype), posb.float(), compute_dtype)
    row = _write_row(pos, cap, cfg)
    if per_slot:
        rows_b = torch.arange(B, device=x.device)
        cache.c_kv.index_put_((rows_b, row.long()),
                              c_kv[:, 0].to(cache.c_kv.dtype))
        cache.k_rope.index_put_((rows_b, row.long()),
                                k_rope[:, 0].to(cache.k_rope.dtype))
    else:
        cache.c_kv.index_copy_(1, row.reshape(1).long(),
                               c_kv.to(cache.c_kv.dtype))
        cache.k_rope.index_copy_(1, row.reshape(1).long(),
                                 k_rope.to(cache.k_rope.dtype))
    valid = torch.arange(cap, device=x.device)[None, :] <= posb  # [B|1,cap]
    out = _mla_attend(params, cfg, q_nope, q_rope, cache.c_kv, cache.k_rope,
                      valid[:, None, :], compute_dtype)
    return out, cache._replace(pos=pos + 1)


def _paged_latents(cache: PagedMLACache):
    """Each slot's latent rows gathered back into the dense layout:
    ([B, cap, kv_lora], [B, cap, qk_rope])."""
    idx = cache.page_table.long()
    B, P = idx.shape
    ps = cache.c_kv.shape[1]
    return (cache.c_kv[idx].reshape(B, P * ps, -1),
            cache.k_rope[idx].reshape(B, P * ps, -1))


def mla_paged_decode_step(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                          cache: PagedMLACache, compute_dtype=torch.bfloat16
                          ) -> Tuple[torch.Tensor, PagedMLACache]:
    """Absorbed-latent decode over the paged latent arena
    (attention.py:727): the math of the per-slot `mla_decode_step` on
    the page-gathered latents. Writes in place; returns (out [B,1,D],
    cache with pos + 1)."""
    ps = cache.c_kv.shape[1]
    cap = cache.page_table.shape[1] * ps
    pos = cache.pos
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(
        params, cfg, x.to(compute_dtype), pos[:, None].float(),
        compute_dtype)
    pg, off = _paged_slot(cache.page_table, _write_row(pos, cap, cfg), ps)
    _paged_write(cache.c_kv, pg, off, c_kv[:, 0])
    _paged_write(cache.k_rope, pg, off, k_rope[:, 0])
    cfull, rfull = _paged_latents(cache)
    valid = torch.arange(cap, device=x.device)[None, :] <= pos[:, None]
    out = _mla_attend(params, cfg, q_nope, q_rope, cfull, rfull,
                      valid[:, None, :], compute_dtype)
    return out, cache._replace(pos=pos + 1)


def _mla_verify_valid(post: torch.Tensor, cap: int) -> torch.Tensor:
    """[B,T,cap]: query t sees rows 0..pos+t (the linear layout)."""
    return torch.arange(cap, device=post.device)[None, None, :] \
        <= post[:, :, None]


def mla_verify_step(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                    cache: MLACache, compute_dtype=torch.bfloat16
                    ) -> Tuple[torch.Tensor, MLACache]:
    """T-token absorbed-latent verify over the dense slotted latent cache
    (attention.py:559). Writes rows pos..pos+T-1 in place; returns (out
    [B,T,D], cache, pos unchanged)."""
    B, T, _ = x.shape
    cap = cache.c_kv.shape[1]
    post, row = _verify_rows(cfg, cache.pos, T, cap)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(
        params, cfg, x.to(compute_dtype), post.float(), compute_dtype)
    rows_b = torch.arange(B, device=x.device)[:, None].expand(B, T)
    cache.c_kv.index_put_((rows_b, row), c_kv.to(cache.c_kv.dtype))
    cache.k_rope.index_put_((rows_b, row), k_rope.to(cache.k_rope.dtype))
    out = _mla_attend(params, cfg, q_nope, q_rope, cache.c_kv, cache.k_rope,
                      _mla_verify_valid(post, cap), compute_dtype)
    return out, cache


def mla_paged_verify_step(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                          cache: PagedMLACache, compute_dtype=torch.bfloat16
                          ) -> Tuple[torch.Tensor, PagedMLACache]:
    """T-token absorbed-latent verify over the paged latent arena
    (attention.py:579). Returns (out [B,T,D], cache, pos unchanged)."""
    B, T, _ = x.shape
    ps = cache.c_kv.shape[1]
    cap = cache.page_table.shape[1] * ps
    post, row = _verify_rows(cfg, cache.pos, T, cap)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(
        params, cfg, x.to(compute_dtype), post.float(), compute_dtype)
    pgs = torch.gather(cache.page_table.long(), 1, row // ps)
    offs = row % ps
    cache.c_kv.index_put_((pgs, offs), c_kv.to(cache.c_kv.dtype))
    cache.k_rope.index_put_((pgs, offs), k_rope.to(cache.k_rope.dtype))
    cfull, rfull = _paged_latents(cache)
    out = _mla_attend(params, cfg, q_nope, q_rope, cfull, rfull,
                      _mla_verify_valid(post, cap), compute_dtype)
    return out, cache
