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
before P.V.

Numerics of the kernels. Flash prefill in bf16 runs on the tensor cores
and, like the plain version, rounds the (unnormalised) probabilities P
to bf16 before P.V, accumulating in fp32; the TPU kernel kept P in fp32.
fp32 inputs go to a CUDA-core kernel that keeps everything in fp32 (a
dispatch by dtype: TF32 tensor cores would not meet the fp32 tolerance).
Paged decode in bf16 also runs its products on the tensor cores and
rounds P to bf16 before P.V, as the plain version does, accumulating in
fp32; the TPU kernel kept P in fp32. fp32 inputs go to a CUDA-core form
of the same kernel, all in fp32. Its split-K partials are merged in a
fixed order: equal inputs give equal bits.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Tuple

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
        lib.paged_decode_fwd.argtypes = [_vp] * 8 + [_int] * 9 + [
            _float, _int, _vp]
        lib.paged_decode_fwd.restype = _int
        lib.paged_decode_smem_bytes.argtypes = [_int] * 2
        lib.paged_decode_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on t's device: what
    `torch.cuda.current_stream(t.device).cuda_stream` gives, without
    building a Stream object on every launch (host time of the order of
    the decode kernel's own time on the card)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _check(cond: bool, msg: Callable[[], str]) -> None:
    """Raise ValueError(msg()) unless cond. The message is built only on
    failure: the checks run on every decode step, where formatting
    shapes and devices would cost more host time than the kernel."""
    if not cond:
        raise ValueError(msg())


def _check_no_grad(name: str, *tensors) -> None:
    """The kernels are forward-only and fill their output through ctypes,
    which autograd cannot see: a gradient through them would be cut
    silently. Refuse instead, on every device, before routing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (a forward-only kernel, as on the "
            f"TPU): call it under torch.no_grad(), or differentiate the "
            f"plain path (attn_impl='plain'; Model.loss uses it)")


def _check_kernel_inputs(name: str, tensors, Dh: int) -> None:
    """What the CUDA kernels take beyond `_check_common`: a compiled head
    dim, and 16-byte aligned storage (TMA boxes and 16-byte vector loads
    read from the start of every tensor)."""
    _check(Dh in HEAD_DIMS,
           lambda: f"{name}: head_dim {Dh} not in {HEAD_DIMS}")
    _check(all(t.data_ptr() % 16 == 0 for t in tensors),
           lambda: f"{name}: inputs must start on a 16-byte boundary")


def _check_common(name: str, tensors, n_float: int) -> None:
    """One device (cpu or cuda) and contiguous storage for all `tensors`;
    the first `n_float` share one dtype of DTYPES. The passing path is
    kept lean: it runs once per layer and decode step."""
    dev, dt = tensors[0].device, tensors[0].dtype
    ok = dev.type in ("cpu", "cuda") and dt in DTYPES
    for i, t in enumerate(tensors):
        if not ok:
            break
        ok = t.device == dev and t.is_contiguous() and (
            i >= n_float or t.dtype == dt)
    if ok:
        return
    _check(dev.type in ("cpu", "cuda"),
           lambda: f"{name}: unsupported device {dev}")
    for t in tensors:
        _check(t.device == dev,
               lambda: f"{name}: inputs on {dev} and {t.device}")
        _check(t.is_contiguous(),
               lambda: f"{name}: inputs must be contiguous")
    dts = sorted(str(t.dtype) for t in tensors[:n_float])
    raise ValueError(f"{name}: q/k/v must share one dtype of "
                     f"{list(DTYPES)}, got {dts}")


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
           lambda: f"flash_attention: q [B,T,H,Dh], k/v [B,S,KV,Dh]; "
           f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    _check(k.shape[0] == B and k.shape[3] == Dh and KV > 0 and H % KV == 0,
           lambda: f"flash_attention: shapes {tuple(q.shape)} vs "
           f"{tuple(k.shape)}")
    _check(T > 0 and S > 0 and q_offset >= 0 and window >= 0,
           lambda: f"flash_attention: T={T} S={S} q_offset={q_offset} "
           f"window={window}")
    _check_common("flash_attention", (q, k, v), 3)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    _check_kernel_inputs("flash_attention", (q, k, v), Dh)
    out = torch.empty_like(q)
    err = _kernels().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S, H,
        KV, Dh, int(causal), window, q_offset, 1.0 / math.sqrt(Dh),
        DTYPES[q.dtype], _stream(q))
    build.LAUNCHES["flash_attention"] += 1
    build.check(err, "flash_attention")
    return out


# ------------------------------------------------------------- paged decode
SPLIT_CTAS_PER_SM = 4      # split-K target: pass-1 blocks per SM


def decode_plan(B: int, KV: int, P: int, sms: int) -> Tuple[int, int]:
    """(splits, pages per split) of the split-K paged decode: one block
    per (KV head, slot, split), each split a contiguous run of a slot's
    P logical pages (the last one may be shorter). Where B*KV blocks
    already fill the `sms` SMs, one split (pass 1 writes the output and
    pass 2 does not run). Else about SPLIT_CTAS_PER_SM blocks per SM:
    splits past a slot's position exit at once, and a slot is often
    half full, so this keeps ~2 working blocks per SM."""
    if B * KV >= sms or P <= 1:
        return 1, P
    want = -(-SPLIT_CTAS_PER_SM * sms // (B * KV))
    pps = max(1, -(-P // want))
    return -(-P // pps), pps


def decode_workspace_shapes(B: int, KV: int, G: int, Dh: int,
                            nsplit: int):
    """fp32 partials of pass 1: acc [B, KV, splits, G, Dh] (unnormalised
    P.V) and (m, l) [B, KV, splits, G, 2] (running max in log2 units,
    running sum)."""
    return (B, KV, nsplit, G, Dh), (B, KV, nsplit, G, 2)


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _decode_setup(B: int, H: int, KV: int, Dh: int, P: int,
                  device_index: int) -> Tuple[int, int, int, int]:
    """Per shape, once: the shared-memory check, the split plan and the
    workspace size -> (splits, pages per split, acc floats, workspace
    floats). Cached because a decode step calls the wrapper once per
    layer and the kernel takes a few microseconds."""
    G = H // KV
    smem = _kernels().paged_decode_smem_bytes(G, Dh)
    _check(smem <= MAX_SMEM,
           lambda: f"paged_decode_attention: {G} heads per group at "
           f"head_dim {Dh} need {smem} B of shared memory")
    nsplit, pps = decode_plan(B, KV, P, _sm_count(
        torch.device("cuda", device_index)))
    acc_shape, ml_shape = decode_workspace_shapes(B, KV, G, Dh, nsplit)
    n_acc = math.prod(acc_shape)
    return nsplit, pps, n_acc, n_acc + math.prod(ml_shape)


def masked_decode_attention(q: torch.Tensor, kfull: torch.Tensor,
                            vfull: torch.Tensor, pos: torch.Tensor, *,
                            rolling: bool = False) -> torch.Tensor:
    """One-token GQA attention over dense per-slot rows: q [B,H,Dh]
    against kfull/vfull [B,cap,KV,Dh] (the current token already
    written), rows at slot positions 0..pos attended, the rest masked to
    NEG_INF; pos int [B] (per slot) or a scalar (every row at one
    position). The masked exact softmax of `gqa_decode_step`
    (attention.py:266-277), probabilities cast to the value dtype before
    P.V. Returns [B,H,Dv] in the value dtype."""
    B, H, Dh = q.shape
    cap, KV = kfull.shape[1], kfull.shape[2]
    rows = torch.arange(cap, device=q.device)
    posb = pos.long().reshape(-1, 1)                         # [B|1, 1]
    if rolling:
        slot_pos = posb - torch.remainder(posb - rows[None, :], cap)
    else:
        slot_pos = rows[None, :].expand(posb.shape[0], cap)
    valid = (slot_pos >= 0) & (slot_pos <= posb)
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, KV, H // KV, Dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          kfull.float()) * scale
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(vfull.dtype)
    return torch.einsum("bkgs,bskd->bkgd", probs, vfull).reshape(B, H, -1)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               page_table: torch.Tensor, pos: torch.Tensor,
                               *, rolling: bool = False) -> torch.Tensor:
    """Plain version: the gather path of `gqa_paged_decode_step`
    (attention.py:391-409) — gather each slot's pages back into the dense
    [B, cap] layout, then `masked_decode_attention` (the dense decode's
    own math, so the two layouts agree bitwise). Returns [B,H,Dh] in the
    value dtype."""
    B, H, Dh = q.shape
    _, ps, KV, _ = k_pages.shape
    cap = page_table.shape[1] * ps
    idx = page_table.long()
    kfull = k_pages[idx].reshape(B, cap, KV, Dh)
    vfull = v_pages[idx].reshape(B, cap, KV, v_pages.shape[-1])
    return masked_decode_attention(q, kfull, vfull, pos, rolling=rolling)


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
           lambda: f"paged_decode_attention: q [B,H,Dh], pages "
           f"[NP,ps,KV,Dh]; got "
           f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
           f"{tuple(v_pages.shape)}")
    B, H, Dh = q.shape
    NP, ps, KV, _ = k_pages.shape
    _check(k_pages.shape[3] == Dh and KV > 0 and H % KV == 0,
           lambda: f"paged_decode_attention: shapes {tuple(q.shape)} vs "
           f"{tuple(k_pages.shape)}")
    _check(page_table.dim() == 2 and page_table.shape[0] == B
           and pos.shape == (B,) and page_table.dtype == torch.int32
           and pos.dtype == torch.int32,
           lambda: f"paged_decode_attention: page_table int32 [B,P], pos "
           f"int32 [B]; got {page_table.dtype}{tuple(page_table.shape)}, "
           f"{pos.dtype}{tuple(pos.shape)}")
    _check_common("paged_decode_attention",
                  (q, k_pages, v_pages, page_table, pos), 3)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                          pos, rolling=rolling)
    _check_kernel_inputs("paged_decode_attention", (q, k_pages, v_pages),
                         Dh)
    P = page_table.shape[1]
    nsplit, pps, n_acc, n_ws = _decode_setup(B, H, KV, Dh, P,
                                             q.get_device())
    out = torch.empty_like(q)
    acc_ptr = ml_ptr = None
    if nsplit > 1:             # one allocation holds both partials
        ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
        acc_ptr = ws.data_ptr()
        ml_ptr = acc_ptr + 4 * n_acc
    err = _kernels().paged_decode_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), pos.data_ptr(), out.data_ptr(), acc_ptr,
        ml_ptr, B, H, KV, Dh, ps, P, nsplit, pps, int(rolling),
        1.0 / math.sqrt(Dh), DTYPES[q.dtype], _stream(q))
    build.LAUNCHES["paged_decode_attention"] += 1
    build.check(err, "paged_decode_attention")
    return out
