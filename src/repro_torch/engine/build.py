"""Decode steps and token sampling for the serve engine (the port's
serving subset of `repro/engine/build.py`)."""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.models.api import Model


def _row_generator(device: torch.device, seed: int,
                   pos: int) -> torch.Generator:
    """One generator per (request seed, token position): token t of a
    request is a pure function of (seed, t), whatever the batch."""
    key = ((int(seed) & 0xFFFFFFFF) << 32) | (int(pos) & 0xFFFFFFFF)
    return torch.Generator(device=device).manual_seed(key)


def sample_logits(logits: torch.Tensor, seeds: Sequence[int],
                  pos: Sequence[int], temperature: Sequence[float],
                  top_k: Sequence[int], top_p: Sequence[float]
                  ) -> torch.Tensor:
    """Per-row token sampling: [B, V] logits -> [B] int32 tokens.

    Rows with temperature <= 0 take the greedy argmax (first index on
    ties, as `jnp.argmax`). Sampled rows apply temperature, then top-k
    (k == 0 disables) and nucleus top-p (p >= 1 disables) truncation,
    then a Gumbel-max draw from a generator seeded by (seed, pos). The
    policy rows are host sequences of length B. The draws cannot match
    the reference's `jax.random` noise; they are deterministic in the
    port."""
    B, V = logits.shape
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    ranks = torch.arange(V, device=logits.device)
    for b in range(B):
        t = float(temperature[b])
        if t <= 0:
            continue
        lg = logits[b].float() / max(t, 1e-6)
        xs, order = torch.sort(lg, descending=True, stable=True)
        k = int(top_k[b])
        if k > 0:
            xs = torch.where(ranks >= k, float("-inf"), xs)
        probs = torch.softmax(xs, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs     # exclusive prefix mass
        tp = float(top_p[b])
        if tp < 1.0:
            xs = torch.where(cum < tp, xs, float("-inf"))
        u = torch.rand(V, generator=_row_generator(logits.device, seeds[b],
                                                   pos[b]),
                       device=logits.device, dtype=torch.float32)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
        out[b] = order[torch.argmax(xs + gumbel)].to(torch.int32)
    return out


def make_batched_decode_step(model: Model):
    """Slotted greedy decode step for continuous batching: the paged
    cache carries a per-slot position vector, so one call advances B
    requests sitting at different sequence lengths. Rows whose slot is
    free compute garbage through trash page 0 that the next admission
    overwrites. Returns (next tokens int32 [B,1], cache)."""
    def decode_step(params, tokens, cache):
        logits, cache = model.decode_step(params, tokens, cache)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], cache
    return decode_step


def make_sampling_decode_step(model: Model):
    """`make_batched_decode_step` with per-slot sampling policies (host
    rows of length B; greedy rows stay argmax via `sample_logits`)."""
    def decode_step(params, tokens, cache, seeds, pos, temperature, top_k,
                    top_p):
        logits, cache = model.decode_step(params, tokens, cache)
        nxt = sample_logits(logits[:, -1, :], seeds, pos, temperature,
                            top_k, top_p)
        return nxt[:, None], cache
    return decode_step
