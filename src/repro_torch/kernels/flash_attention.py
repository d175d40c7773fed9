"""Serving attention kernels: flash prefill and paged decode, each a
wrapper around a hand-written CUDA kernel (`csrc/flash_attention.cu`)
with its plain PyTorch version beside it.

Counterpart of `repro/kernels/flash_attention.py`, whose two Pallas
kernels these replace. Routing is by device only: a wrapper given CPU
tensors computes its plain version; given CUDA tensors it launches its
kernel or raises — there is no fallback. The plain versions follow the
JAX reference paths (`_chunked_attention`, attention.py:119; the gather
path of `gqa_paged_decode_step`, attention.py:391-409) step for step,
including the cast of the softmax probabilities to the value dtype
before P.V. The kernels follow the TPU kernels instead and keep P in
fp32, so in bf16 the two differ by bf16 rounding of P (the tolerance
`chip_smoke.py` states).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)     # the kernels' compiled head dims
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232_448                     # bytes a Hopper block may use

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        lib.flash_attention_fwd.argtypes = [_vp] * 4 + [_int] * 9 + [
            _float, _int, _vp]
        lib.flash_attention_fwd.restype = _int
        lib.paged_decode_fwd.argtypes = [_vp] * 6 + [_int] * 7 + [
            _float, _int, _vp]
        lib.paged_decode_fwd.restype = _int
        lib.paged_decode_smem_bytes.argtypes = [_int] * 3
        lib.paged_decode_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_no_grad(name: str, *tensors) -> None:
    """The kernels are forward-only and fill their output through ctypes,
    which autograd cannot see: a gradient through them would be cut
    silently. Refuse instead, on every device, before routing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (a forward-only kernel, as on the "
            f"TPU): call it under torch.no_grad(), or differentiate the "
            f"plain path (attn_impl='plain'; Model.loss uses it)")


def _check_common(name: str, tensors, float_names) -> None:
    dev = tensors[0].device
    _check(dev.type in ("cpu", "cuda"), f"{name}: unsupported device {dev}")
    for t in tensors:
        _check(t.device == dev, f"{name}: inputs on {dev} and {t.device}")
        _check(t.is_contiguous(), f"{name}: inputs must be contiguous")
    dts = {tensors[i].dtype for i in float_names}
    _check(len(dts) == 1 and next(iter(dts)) in DTYPES,
           f"{name}: q/k/v must share one dtype of {list(DTYPES)}, "
           f"got {sorted(map(str, dts))}")


# ------------------------------------------------------------ flash prefill
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      positions_q: torch.Tensor, positions_k: torch.Tensor,
                      *, causal: bool, window: int,
                      chunk: int = 512) -> torch.Tensor:
    """`_chunked_attention` (attention.py:119-164): q [B,T,H,Dh], k/v
    [B,S,KV,Dh] on explicit positions [T]/[S] -> [B,T,H,Dv]. Queries go
    in chunks of `chunk` rows, each with an exact softmax over the whole
    key axis (masked keys add exact zeros, so the chunk size does not
    change the math); probabilities are cast to the value dtype before
    P.V, as in the reference."""
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(Dh)
    kf = k.float()
    outs = []
    for c0 in range(0, T, chunk):
        n = min(chunk, T - c0)
        qi = q[:, c0:c0 + n].reshape(B, n, KV, G, Dh)
        pos_q = positions_q[c0:c0 + n]
        scores = torch.einsum("bckgd,bskd->bkgcs", qi.float(), kf) * scale
        mask = torch.ones((n, S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= positions_k[None, :] <= pos_q[:, None]
        if window > 0:
            mask &= positions_k[None, :] > pos_q[:, None] - window
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bkgcs,bskd->bckgd", probs, v)
        outs.append(out.reshape(B, n, H, v.shape[-1]))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0, chunk: int = 512) -> torch.Tensor:
    """Plain version: `chunked_attention` on query positions
    q_offset..q_offset+T-1 against key positions 0..S-1, `chunk` query
    rows at a time."""
    T, S = q.shape[1], k.shape[1]
    positions_q = torch.arange(q_offset, q_offset + T, device=q.device)
    positions_k = torch.arange(S, device=q.device)
    return chunked_attention(q, k, v, positions_q, positions_k,
                             causal=causal, window=window, chunk=chunk)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Forward GQA attention. q: [B,T,H,Dh]; k/v: [B,S,KV,Dh] (RoPE
    applied) -> [B,T,H,Dh] in q's dtype. Query row t sits at absolute
    position q_offset + t, key j at j: causal masks j > q_offset + t,
    `window` > 0 masks j <= q_offset + t - window. Any T and S (the
    kernel masks the ragged edges); head h reads KV head h // (H // KV)."""
    _check_no_grad("flash_attention", q, k, v)
    _check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
           f"flash_attention: q [B,T,H,Dh], k/v [B,S,KV,Dh]; got "
           f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    _check(k.shape[0] == B and k.shape[3] == Dh and KV > 0 and H % KV == 0,
           f"flash_attention: shapes {tuple(q.shape)} vs {tuple(k.shape)}")
    _check(T > 0 and S > 0 and q_offset >= 0 and window >= 0,
           f"flash_attention: T={T} S={S} q_offset={q_offset} "
           f"window={window}")
    _check_common("flash_attention", (q, k, v), (0, 1, 2))
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    _check(Dh in HEAD_DIMS, f"flash_attention: head_dim {Dh} not in "
           f"{HEAD_DIMS}")
    out = torch.empty_like(q)
    err = _kernels().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S, H,
        KV, Dh, int(causal), window, q_offset, 1.0 / math.sqrt(Dh),
        DTYPES[q.dtype], _stream(q))
    build.LAUNCHES["flash_attention"] += 1
    build.check(err, "flash_attention")
    return out


# ------------------------------------------------------------- paged decode
def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               page_table: torch.Tensor, pos: torch.Tensor,
                               *, rolling: bool = False) -> torch.Tensor:
    """Plain version: the gather path of `gqa_paged_decode_step`
    (attention.py:391-409) — gather each slot's pages back into the dense
    [B, cap] layout, mask by position, exact softmax. Returns [B,H,Dh] in
    the value dtype."""
    B, H, Dh = q.shape
    _, ps, KV, _ = k_pages.shape
    cap = page_table.shape[1] * ps
    idx = page_table.long()
    kfull = k_pages[idx].reshape(B, cap, KV, Dh)
    vfull = v_pages[idx].reshape(B, cap, KV, v_pages.shape[-1])
    rows = torch.arange(cap, device=q.device)
    posb = pos.long()[:, None]
    if rolling:
        slot_pos = posb - torch.remainder(posb - rows[None, :], cap)
    else:
        slot_pos = rows[None, :].expand(B, cap)
    valid = (slot_pos >= 0) & (slot_pos <= posb)
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, KV, H // KV, Dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          kfull.float()) * scale
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(vfull.dtype)
    return torch.einsum("bkgs,bskd->bkgd", probs, vfull).reshape(B, H, -1)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           pos: torch.Tensor, *,
                           rolling: bool = False) -> torch.Tensor:
    """One-token GQA decode over a paged KV arena. q: [B,H,Dh] (RoPE'd);
    k_pages/v_pages: [num_pages, page_size, KV, Dh] with the current
    token already written; page_table: int32 [B, pages_per_slot]; pos:
    int32 [B] tokens seen before this step (rows at slot positions
    0..pos are attended). rolling: sliding-window layout, logical row r
    holds the latest position p with p % cap == r. -> [B,H,Dh]."""
    _check_no_grad("paged_decode_attention", q, k_pages, v_pages)
    _check(q.dim() == 3 and k_pages.dim() == 4
           and k_pages.shape == v_pages.shape,
           f"paged_decode_attention: q [B,H,Dh], pages [NP,ps,KV,Dh]; got "
           f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
           f"{tuple(v_pages.shape)}")
    B, H, Dh = q.shape
    NP, ps, KV, _ = k_pages.shape
    _check(k_pages.shape[3] == Dh and KV > 0 and H % KV == 0,
           f"paged_decode_attention: shapes {tuple(q.shape)} vs "
           f"{tuple(k_pages.shape)}")
    _check(page_table.dim() == 2 and page_table.shape[0] == B
           and pos.shape == (B,) and page_table.dtype == torch.int32
           and pos.dtype == torch.int32,
           f"paged_decode_attention: page_table int32 [B,P], pos int32 [B]; "
           f"got {page_table.dtype}{tuple(page_table.shape)}, "
           f"{pos.dtype}{tuple(pos.shape)}")
    _check_common("paged_decode_attention",
                  (q, k_pages, v_pages, page_table, pos), (0, 1, 2))
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                          pos, rolling=rolling)
    _check(Dh in HEAD_DIMS, f"paged_decode_attention: head_dim {Dh} not "
           f"in {HEAD_DIMS}")
    lib = _kernels()
    smem = lib.paged_decode_smem_bytes(H // KV, ps, Dh)
    _check(smem <= MAX_SMEM, f"paged_decode_attention: page_size {ps}, "
           f"{H // KV} heads per group need {smem} B of shared memory")
    out = torch.empty_like(q)
    err = lib.paged_decode_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), pos.data_ptr(), out.data_ptr(), B, H, KV, Dh,
        ps, page_table.shape[1], int(rolling), 1.0 / math.sqrt(Dh),
        DTYPES[q.dtype], _stream(q))
    build.LAUNCHES["paged_decode_attention"] += 1
    build.check(err, "paged_decode_attention")
    return out
