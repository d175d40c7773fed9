"""Adasum block kernels: `block_dots` (per-block [a·b, a·a, b·b]) and
`block_combine` (per-block s1·a + s2·b), each a wrapper around a
hand-written CUDA kernel (`csrc/adasum.cu`) with its plain PyTorch
version beside it.

Counterpart of `repro/kernels/adasum_dots.py`, `adasum_combine.py`,
`ref.py` and `ops.py`. Routing is by device: a wrapper given CPU tensors
computes its plain version; given CUDA tensors it launches its kernel
or raises — there is no fallback — unless the caller asks for the
plain version.

Operands are either two 1-D contiguous buffers of n elements, or two
[p, L] views with unit inner stride and one common row stride — the
lane pairs of a fused bucket buffer [2p, L] seen as `buf.view(p, 2,
L)[:, 0]` and `[:, 1]`, so a tree level reads the pairs in place
instead of gathering each half into a copy. A [p, L] operand is the
reference's `y[:, 0].reshape(p * L)` (combine.py:274-276): blocks and
scalars run pair-major, and `block_combine` returns a contiguous
[p, L] (or [n]) result.

Numerics of `block_combine`: the TPU kernel computes in fp32 and casts
once to the buffer dtype (adasum_combine.py:21-27); its oracle
`combine_ref` computes in the buffer dtype (ref.py:19-28). The CUDA
kernel follows the TPU kernel. The plain arm follows the rule the caller
names (`fp32_math`), as the reference picks between kernel and oracle
by `use_pallas` (combine.py:244-249). For fp32 buffers the two agree to
about one ulp; for bf16 they differ by bf16 rounding.

`plain=True` takes the plain arm on any device: the on-card reference
the kernels are held to (`combine_impl="plain"`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import build

UNIT = 1024          # the TPU kernels' block granule (8 x 128 fp32 tile)
GRANULE = 256        # the CUDA kernels' granule: one 16-byte load a thread
BLOCK_ELEMS = 8192   # every layer starts at a multiple of this (ops.py)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
REF_PIECE = 1 << 24  # elements a plain block-dots pass casts at once

_vp, _int, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("adasum")
        lib.adasum_block_dots.argtypes = [_vp, _vp, _vp, _int, _i64, _i64,
                                          _int, _int, _vp]
        lib.adasum_block_dots.restype = _int
        lib.adasum_block_combine.argtypes = [_vp] * 5 + [_int, _i64, _i64,
                                                         _int, _int, _vp]
        lib.adasum_block_combine.restype = _int
        _lib = lib
    return _lib


def auto_block_elems(n: int, max_elems: int = 8192) -> int:
    """Largest multiple of UNIT (=1024) that divides `n`, capped at
    `max_elems` (adasum_dots.py:33): the `block_elems=None` rule."""
    if n <= 0 or n % UNIT:
        raise ValueError(
            f"buffer length {n} is not a positive multiple of {UNIT}; pad "
            f"it via fusion.make_layout(leaf_align={UNIT}) (or larger)")
    b = min(max_elems - max_elems % UNIT, n) or UNIT
    while b > UNIT and n % b:
        b -= UNIT
    return b


# ------------------------------------------------------------ plain versions
def block_dots_ref(a: torch.Tensor, b: torch.Tensor, block_elems: int,
                   acc_dtype=torch.float32) -> torch.Tensor:
    """Per-block [a·b, a·a, b·b] accumulated in acc_dtype: (n,) x2 ->
    (n // block_elems, 3). Cast a piece of REF_PIECE elements at a time,
    so an fp64 pass over a multi-GB bucket holds no fp64 copy of it."""
    n = a.shape[0]
    if n % block_elems:
        raise ValueError(f"n={n} is not a multiple of {block_elems}")
    out = torch.empty((n // block_elems, 3), dtype=acc_dtype,
                      device=a.device)
    step = max(REF_PIECE // block_elems, 1) * block_elems
    for s in range(0, n, step):
        af = a[s:s + step].to(acc_dtype).reshape(-1, block_elems)
        bf = b[s:s + step].to(acc_dtype).reshape(-1, block_elems)
        rows = slice(s // block_elems, s // block_elems + af.shape[0])
        out[rows, 0] = (af * bf).sum(-1)
        out[rows, 1] = (af * af).sum(-1)
        out[rows, 2] = (bf * bf).sum(-1)
        del af, bf
    return out


def combine_ref(a: torch.Tensor, b: torch.Tensor, s1b: torch.Tensor,
                s2b: torch.Tensor, block_elems: int) -> torch.Tensor:
    """s1[blk]*a + s2[blk]*b in the buffer dtype (the oracle's rule)."""
    nb = a.shape[0] // block_elems
    out = s1b[:, None].to(a.dtype) * a.reshape(nb, block_elems)
    out += s2b[:, None].to(b.dtype) * b.reshape(nb, block_elems)
    return out.reshape(-1)


def combine_fp32_ref(a: torch.Tensor, b: torch.Tensor, s1b: torch.Tensor,
                     s2b: torch.Tensor, block_elems: int) -> torch.Tensor:
    """s1[blk]*a + s2[blk]*b in fp32, cast once to a.dtype (the TPU
    kernel's rule)."""
    nb = a.shape[0] // block_elems
    out = s1b[:, None].float() * a.reshape(nb, block_elems).float()
    out += s2b[:, None].float() * b.reshape(nb, block_elems).float()
    return out.reshape(-1).to(a.dtype)


def segment_dots_ref(a, b, seg, num_segments, acc_dtype=torch.float32):
    """Direct per-segment dots (oracle for `adasum_segment_dots`)."""
    af, bf = a.to(acc_dtype), b.to(acc_dtype)
    prods = torch.stack([af * bf, af * af, bf * bf], dim=-1)
    out = torch.zeros((num_segments, 3), dtype=acc_dtype, device=a.device)
    return out.index_add_(0, seg.long(), prods)


def block_segment_dots_ref(a, b, block_seg, num_segments, block_elems,
                           acc_dtype=torch.float32):
    """Per-segment dots via per-block partials + a block-level segment
    reduction (valid under the FusionLayout alignment contract)."""
    blocks = block_dots_ref(a, b, block_elems, acc_dtype)
    out = torch.zeros((num_segments, 3), dtype=acc_dtype, device=a.device)
    return out.index_add_(0, block_seg.long(), blocks)


# ---------------------------------------------------------------- wrappers
def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _operands(name: str, a: torch.Tensor, b: torch.Tensor,
              block_elems: int):
    """Validate a pair of operands; returns (rows p, row length L, row
    stride)."""
    _check(a.device == b.device and a.device.type in ("cpu", "cuda"),
           f"{name}: operands on {a.device} and {b.device}")
    _check(a.dtype == b.dtype and a.dtype in DTYPES,
           f"{name}: operands must share one dtype of {list(DTYPES)}, got "
           f"{a.dtype}, {b.dtype}")
    _check(a.shape == b.shape and a.dim() in (1, 2),
           f"{name}: operands [n] or [p, L] of one shape, got "
           f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dim() == 1:
        _check(a.is_contiguous() and b.is_contiguous(),
               f"{name}: 1-D operands must be contiguous")
        p, L, stride = 1, a.shape[0], 0
    else:
        p, L = a.shape
        _check(a.stride(1) == 1 and b.stride(1) == 1
               and a.stride(0) == b.stride(0),
               f"{name}: [p, L] operands need unit inner stride and one row "
               f"stride, got {a.stride()}, {b.stride()}")
        stride = a.stride(0)
    _check(isinstance(block_elems, int) and block_elems > 0
           and block_elems % GRANULE == 0,
           f"{name}: block_elems={block_elems} must be a positive multiple "
           f"of {GRANULE}")
    _check(L > 0 and L % block_elems == 0,
           f"{name}: row length {L} is not a positive multiple of "
           f"block_elems={block_elems}")
    return p, L, stride


def _cuda_ready(name: str, a: torch.Tensor, b: torch.Tensor, L: int,
                stride: int):
    """What the kernels' 16-byte loads need beyond `_operands`."""
    _check(L < 2 ** 31, f"{name}: row length {L} >= 2^31")
    _check(a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
           and stride * a.element_size() % 16 == 0,
           f"{name}: operands and their row stride must be 16-byte aligned")


def _plain_rows(fn, a, b, *scalars):
    """A 1-D plain version on [n] operands, or on each pair row of [p, L]
    operands in turn (unit-stride views: no strided copy of the pairs);
    `scalars` are per-block and split by row with them."""
    if a.dim() == 1:
        return fn(a, b, *scalars)
    p = a.shape[0]
    rows = [s.reshape(p, -1) for s in scalars]
    return [fn(a[r], b[r], *(s[r] for s in rows)) for r in range(p)]


def block_dots(a: torch.Tensor, b: torch.Tensor, *,
               block_elems: Optional[int] = BLOCK_ELEMS,
               plain: bool = False,
               acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-block fp32 [Σa·b, Σa·a, Σb·b], both operands read once:
    [n] x2 -> [n // block_elems, 3], or [p, L] x2 -> [p * L //
    block_elems, 3] pair-major. block_elems=None: `auto_block_elems`.

    `acc_dtype` is the plain arm's accumulator (`plain=True`: e.g. fp64
    throughout, as the reference's `block_dots_ref(..., acc_dtype)`).
    The kernel, and its plain version on CPU tensors, accumulate in fp32
    as the TPU kernel does; a caller wanting fp64 there casts the fp32
    block partials."""
    if block_elems is None:
        block_elems = auto_block_elems(a.shape[-1])
    p, L, stride = _operands("block_dots", a, b, block_elems)
    if not plain:
        _check(acc_dtype == torch.float32,
               f"block_dots: the kernel accumulates in fp32, not "
               f"{acc_dtype}; cast its partials, or ask for plain=True")
    if plain or a.device.type == "cpu":
        out = _plain_rows(lambda x, y: block_dots_ref(x, y, block_elems,
                                                      acc_dtype), a, b)
        return out if a.dim() == 1 else torch.cat(out)
    _cuda_ready("block_dots", a, b, L, stride)
    out = torch.empty((p * (L // block_elems), 3), dtype=torch.float32,
                      device=a.device)
    err = _kernels().adasum_block_dots(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), p, L, stride,
        block_elems, DTYPES[a.dtype],
        torch.cuda.current_stream(a.device).cuda_stream)
    build.LAUNCHES["block_dots"] += 1
    build.check(err, "block_dots")
    return out


def block_combine(a: torch.Tensor, b: torch.Tensor, s1b: torch.Tensor,
                  s2b: torch.Tensor, *,
                  block_elems: Optional[int] = BLOCK_ELEMS,
                  fp32_math: bool = True, plain: bool = False
                  ) -> torch.Tensor:
    """out = s1b[blk]·a + s2b[blk]·b with one fp32 scalar pair per block
    ([nblk] each, pair-major for [p, L] operands) -> contiguous result of
    a's shape in a's dtype. block_elems=None derives the block from the
    scalar count. fp32_math selects the plain arm's rule (see the module
    docstring); the CUDA kernel always computes in fp32."""
    if block_elems is None:
        block_elems = a.numel() // max(s1b.shape[0], 1)
        auto_block_elems(block_elems)     # validates the granule contract
    p, L, stride = _operands("block_combine", a, b, block_elems)
    nblk = p * (L // block_elems)
    _check(s1b.shape == (nblk,) and s2b.shape == (nblk,)
           and s1b.device == a.device and s2b.device == a.device,
           f"block_combine: scalars must be [{nblk}] on {a.device}, got "
           f"{tuple(s1b.shape)}, {tuple(s2b.shape)}")
    if plain or a.device.type == "cpu":
        ref = combine_fp32_ref if fp32_math else combine_ref
        out = _plain_rows(lambda x, y, u, w: ref(x, y, u, w, block_elems),
                          a, b, s1b, s2b)
        return out if a.dim() == 1 else torch.stack(out)
    _cuda_ready("block_combine", a, b, L, stride)
    s1b = s1b.to(torch.float32).contiguous()
    s2b = s2b.to(torch.float32).contiguous()
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    err = _kernels().adasum_block_combine(
        a.data_ptr(), b.data_ptr(), s1b.data_ptr(), s2b.data_ptr(),
        out.data_ptr(), p, L, stride, block_elems, DTYPES[a.dtype],
        torch.cuda.current_stream(a.device).cuda_stream)
    build.LAUNCHES["block_combine"] += 1
    build.check(err, "block_combine")
    return out


# ------------------------------------------------ segment-level wrappers
class SegmentSum:
    """An order-fixed segment sum over the block axis for host segment
    ids (the reference's `jax.ops.segment_sum` over block partials).
    Each block lands in its own slot of a dense [num, width] grid, in
    block order within its segment (unique indices, no accumulation),
    and the grid is summed over its width: no atomics, so two runs give
    bitwise-equal sums on the card (`index_add_` on CUDA would not). The
    ids may repeat out of order (a chunk-major RVH bucket holds every
    layer once a chunk). The sum runs in the partials' dtype: fp64
    partials (the plain arm's, or the kernel's fp32 ones cast) give an
    fp64 sum."""

    def __init__(self, seg, num_segments: int, device):
        seg = np.asarray(seg, dtype=np.int64)
        counts = np.bincount(seg, minlength=num_segments)
        self.num = num_segments
        self.width = max(int(counts.max(initial=0)), 1)
        order = np.argsort(seg, kind="stable")
        pos = np.empty(len(seg), dtype=np.int64)
        pos[order] = np.arange(len(seg)) - (np.cumsum(counts)
                                            - counts)[seg[order]]
        self.seg = torch.as_tensor(seg, device=device)
        self.pos = torch.as_tensor(pos, device=device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., nblk, C] -> [..., num_segments, C]."""
        dense = x.new_zeros(x.shape[:-2] + (self.num, self.width)
                            + x.shape[-1:])
        dense[..., self.seg, self.pos, :] = x
        return dense.sum(-2)


def adasum_segment_dots(a: torch.Tensor, b: torch.Tensor, seg: torch.Tensor,
                        num_segments: int, acc_dtype=torch.float32,
                        block_elems: Optional[int] = BLOCK_ELEMS
                        ) -> torch.Tensor:
    """[n] x2 + seg [n] -> [num_segments, 3] per-segment [a·b, a·a, b·b]
    through `block_dots` (each block lies in one segment). The fp32
    block partials are cast to acc_dtype before the segment sum."""
    if block_elems is None:
        block_elems = auto_block_elems(a.shape[0])
    blocks = block_dots(a, b, block_elems=block_elems).to(acc_dtype)
    block_seg = seg[::block_elems].cpu().numpy()
    return SegmentSum(block_seg, num_segments, a.device)(blocks)


def adasum_combine(a: torch.Tensor, b: torch.Tensor, s1: torch.Tensor,
                   s2: torch.Tensor, seg: torch.Tensor,
                   block_elems: Optional[int] = BLOCK_ELEMS) -> torch.Tensor:
    """x' = s1[seg]·a + s2[seg]·b through `block_combine`."""
    if block_elems is None:
        block_elems = auto_block_elems(a.shape[0])
    block_seg = seg[::block_elems].long()
    return block_combine(a, b, s1[block_seg], s2[block_seg],
                         block_elems=block_elems)
