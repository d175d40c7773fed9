"""Shared building blocks: norms, RoPE, embeddings, gated MLPs (the
port's `repro/models/layers.py`).

Plain functions on tensors with the JAX package's parameter layout:
weights apply as `x @ W` with `W [in, out]`. Compute dtype is passed
explicitly; params live in param_dtype.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

PyTree = Any


# ---------------------------------------------------------------------- norm
def rmsnorm(params: PyTree, x: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def headwise_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """qk-norm (qwen3): RMS over the head_dim axis of [..., H, Dh]."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)


# ---------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [..., T, H, Dh]; positions broadcastable to [..., T]. Angles
    are fp32 products of fp32 positions, as in the reference."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                   # [Dh/2]
    ang = positions[..., :, None].float() * freqs             # [..., T, Dh/2]
    cos = torch.cos(ang)[..., :, None, :]                     # [..., T, 1, Dh/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------- mlp
def mlp_apply(params: PyTree, x: torch.Tensor, mlp_type: str = "swiglu",
              compute_dtype=torch.bfloat16, tp=None) -> torch.Tensor:
    """The gated MLP. tp (`parallel.tp.TensorParallel`): gate and up
    column-parallel, down row-parallel, where the model axis divides
    d_ff (else every rank runs it whole, as the reference's `_spec2`
    drops the axis)."""
    x = x.to(compute_dtype)
    split = tp is not None and tp.dim("mlp", "w_gate") is not None
    if split:
        x = tp.copy(x)
    g = x @ params["w_gate"].to(compute_dtype)
    u = x @ params["w_up"].to(compute_dtype)
    if mlp_type == "swiglu":
        a = F.silu(g)
    elif mlp_type == "geglu":
        a = F.gelu(g, approximate="tanh")
    else:
        raise KeyError(mlp_type)
    y = (a * u) @ params["w_down"].to(compute_dtype)
    return tp.reduce(y) if split else y


# ----------------------------------------------------------------- embedding
def embed(params: PyTree, tokens: torch.Tensor,
          compute_dtype=torch.bfloat16, tp=None) -> torch.Tensor:
    """The lookup. tp: a vocab-sharded table looks up the rank's rows
    and all-reduces; a d-split table all-gathers its columns."""
    dim = tp.dim("embed", "table") if tp is not None else None
    table = params["table"]
    if dim is None:
        return table[tokens.long()].to(compute_dtype)
    if dim == 1:
        return tp.gather(table[tokens.long()].to(compute_dtype), -1)
    n = table.shape[0]
    local = tokens.long() - tp.index * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].to(compute_dtype)
    return tp.reduce(rows * mine[..., None].to(compute_dtype))


def unembed(params: PyTree, x: torch.Tensor,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Logits in fp32 (tied embeddings)."""
    return (x.to(compute_dtype)
            @ params["table"].to(compute_dtype).T).float()


def lm_head(params: PyTree, x: torch.Tensor,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    return (x.to(compute_dtype) @ params["w"].to(compute_dtype)).float()
