"""Mixture-of-Experts layer (the port of `repro/models/moe.py`):
mixtral-8x22b (8 experts, top-2) and moonshot-v1-16b-a3b (64 experts,
top-6, plus shared experts).

Capacity dispatch exactly as the reference's, in plain torch ops (the
reference writes it in plain `jnp`, outside any Pallas kernel): a
softmax router in fp32, the top-k experts of each token with the lower
expert index first among equal probabilities (`jax.lax.top_k`'s order),
the top-k gates renormalised, each (token, k) pair's slot in its
expert's buffer from a cumsum over the one-hot choices in (token, k)
order, pairs at or past the capacity C dropped, the expert SwiGLU on
[S, E, C, D] buffers, and the gate-weighted sum over k in the expert
output's dtype. Expert weights are stacked [E, ...].

Capacity depends on the number of tokens in the call (N = B·T), so a
full-sequence call and a one-token call can drop different pairs; and
padding tokens are routed like real ones, taking expert slots.

On a model axis (`tp`, `parallel.tp.TensorParallel`) the router is
replicated, so every rank of the group computes the same dispatch on
the same whole activation. The experts split by `expert_partition`, as
the reference's specs put them (sharding.py:131-137): "expert" gives a
rank E/M whole experts, which gather only their own slots; "hidden"
splits every expert's d_ff (gate and up by columns, down by rows). The
reference's rule for "expert" does not exempt the layer axis of the
`blocks` stack, so where the axis divides the MoE layers it cuts that
axis instead of E: the rank holding a layer runs all its experts, the
others none (`TensorParallel.layer`). The shared experts split their
d_ff as the dense MLP's. Each rank's expert and
shared outputs are then parts of the whole, summed by one all-reduce
of [N, D] a block. The gate weights that scale a rank's part reach the
router through `tp.copy`, so their gradient is the group's sum; the aux
loss is whole on every rank and counts once.
"""
from __future__ import annotations

import functools
import math
import operator
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

PyTree = Any


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for a call over `n_tokens`: ceil(N·K/E·cf),
    rounded up to a multiple of 8, at least 8."""
    c = math.ceil(n_tokens * cfg.n_experts_per_tok / cfg.n_experts
                  * cfg.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` on the last axis: the k largest values, and among
    equal values the lower index first (a stable descending sort;
    `torch.topk` promises no order for ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
              compute_dtype=torch.bfloat16, local_shards: int = 1,
              token_group=None, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,T,D] -> (out [B,T,D] in x's dtype, aux load-balance loss, a
    fp32 scalar).

    local_shards > 1 (the reference's shard-local dispatch): the tokens
    are viewed as [local_shards, N/local_shards] rows and each row
    dispatches into its own capacity slice (capacity counted per row).
    It falls back to one row when N does not divide.

    token_group (a `parallel.zero.TokenGroup`): x is one member's rows of
    a call the group's ranks split in member order. Capacity counts the
    whole call's tokens, a pair's slot counts the pairs of the members
    before it, and the aux loss is this member's share of the whole
    call's (its router probabilities against the call's fractions): the
    call the reference makes, in parts.

    tp: this rank's model group, the expert and shared leaves its
    shards (module docstring)."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.n_experts_per_tok
    N = B * T
    grp = token_group
    S = local_shards if N % local_shards == 0 and grp is None else 1
    NL = N // S                                              # tokens a row
    C = capacity(cfg, NL * (grp.size if grp is not None else 1))
    xf = x.reshape(S, NL, D).to(compute_dtype)

    logits = (xf @ params["router"].to(compute_dtype)).float()
    probs = torch.softmax(logits, dim=-1)                    # [S, NL, E]
    gate_vals, expert_idx = top_k(probs, K)                  # [S, NL, K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # the slot of each (token, k) pair inside its row's expert buffer
    flat_idx = expert_idx.reshape(S, NL * K)
    onehot = F.one_hot(flat_idx, E).to(torch.int32)          # [S, NLK, E]
    pos_all = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos = torch.gather(pos_all, 2, flat_idx[..., None])[..., 0]
    if grp is None:
        keep = pos < C                                       # overflow drop
    else:           # the slot in the whole call's buffer decides the drop
        ahead = grp.before(onehot.sum(1))                    # [S, E]
        keep = pos + torch.gather(ahead, 1, flat_idx) < C
    slot = torch.where(keep, flat_idx * C + pos,
                       torch.full_like(pos, E * C))          # E*C = dropped

    # the model axis: this rank's experts [lo, lo + El) (all of them
    # unless the experts themselves are split), and whether its expert
    # and shared outputs are parts of the whole
    edim = tp.dim("moe", "w_gate") if tp is not None else None
    El = E // tp.size if edim == 0 else E
    lo = tp.index * El if edim == 0 else 0
    if edim == -1:          # the layer's owner holds all E, the rest none
        El = params["w_gate"].shape[0]
    split_e = edim is not None
    split_s = (cfg.n_shared_experts > 0 and tp is not None
               and tp.dim("moe", "shared", "w_gate") is not None)
    xs = tp.copy(xf) if split_e or split_s else xf

    # dispatch: each kept slot holds its token's id, the rest id NL (a
    # zero row); then gather the tokens into [S, El, C, D]
    token_of_pair = torch.arange(NL, device=x.device).repeat_interleave(
        K)[None].expand(S, NL * K)
    buf_tok = torch.full((S, E * C + 1), NL, dtype=torch.long,
                         device=x.device)
    buf_tok.scatter_(1, slot.long(), token_of_pair)
    buf_tok = buf_tok[:, lo * C:(lo + El) * C]
    # row gathers by advanced indexing, not torch.gather: on a card the
    # backward of indexing accumulates in a fixed order (gather's
    # scatter_add does not), so a training step repeats bitwise
    rows = torch.arange(S, device=x.device)[:, None]
    xe = xs if split_e else xf
    xpad = torch.cat([xe, xe.new_zeros((S, 1, D))], dim=1)
    de = xpad[rows, buf_tok].reshape(S, El, C, D)

    # the expert SwiGLU, batched over (S, El)
    wg = params["w_gate"].to(compute_dtype)
    wu = params["w_up"].to(compute_dtype)
    wd = params["w_down"].to(compute_dtype)
    h = F.silu(torch.einsum("secd,edf->secf", de, wg)) \
        * torch.einsum("secd,edf->secf", de, wu)
    ye = torch.einsum("secf,efd->secd", h, wd).reshape(S, El * C, D)

    # combine: each pair's slot output, weighted by its gate (cast to the
    # expert output's dtype first, as the reference does), summed over K;
    # a pair whose slot is another rank's takes the zero row
    mine = slot.long() - lo * C
    if El < E:
        mine = torch.where((mine >= 0) & (mine < El * C), mine,
                           torch.full_like(mine, El * C))
    ypad = torch.cat([ye, ye.new_zeros((S, 1, D))], dim=1)
    y_pair = ypad[rows, mine]                                # [S, NLK, D]
    w_pair = torch.where(keep, gate_vals.reshape(S, NL * K),
                         torch.zeros((), device=x.device))
    if split_e:
        w_pair = tp.copy(w_pair)
    out = (y_pair * w_pair[..., None].to(ye.dtype)).reshape(
        S, NL, K, D).sum(2)

    # the routed and shared outputs: parts of the whole (summed, then one
    # all-reduce over the model group) or whole on every rank
    parts, wholes = ([out], []) if split_e else ([], [out])
    if cfg.n_shared_experts:
        sh = params["shared"]
        xh = xs if split_s else xf
        g = F.silu(xh @ sh["w_gate"].to(compute_dtype)) \
            * (xh @ sh["w_up"].to(compute_dtype))
        (parts if split_s else wholes).append(
            g @ sh["w_down"].to(compute_dtype))
    if parts:
        wholes.append(tp.reduce(functools.reduce(operator.add, parts),
                                "moe_allreduce"))
    out = functools.reduce(operator.add, wholes)

    # Switch-style load-balance aux loss: E · Σ_e f_e · P_e / K
    if grp is None:
        f = F.one_hot(expert_idx, E).float().sum(2).mean(dim=(0, 1))
        pmean = probs.mean(dim=(0, 1))
        aux = E * torch.sum(f * pmean) / K
    else:
        n = N * grp.size
        f = grp.sum(F.one_hot(expert_idx, E).float().sum(dim=(0, 1, 2))) / n
        aux = E * torch.sum(f * probs.sum(dim=(0, 1)) / n) / K
    return out.reshape(B, T, D).to(x.dtype), aux
