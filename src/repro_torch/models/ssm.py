"""State-space mixers (the port of `repro/models/ssm.py`): the Mamba2-style
SSD mixer (hymba's parallel SSM heads) and the RWKV6 "Finch" time and
channel mix with data-dependent decay.

As in the reference, both recurrences run in *chunked* form for training
and prefill: within a chunk of Q positions the recurrence is expanded
into an attention-like score matrix, and across chunks the fp32
recurrent state [B, heads, state, head_dim] is carried — here by a Python
loop over the chunks, where the reference scans. Decode steps take the
plain O(1) recurrence. Decays are kept as negative log-decays, and the
within-chunk ratios exp(cum_t - cum_s) are formed from pairwise
differences.

One deliberate difference: the reference takes `exp` of every pairwise
difference and then zeroes the upper triangle (`jnp.where(mask,
jnp.exp(diff), 0)`, ssm.py:113 and :243). There `diff` is positive, and
once a chunk's summed decay passes ~88 the exponent is inf; the forward
value is still right, but the backward pass multiplies the zeroed
cotangent by inf and the gradient is NaN. Here the exponent is masked to
-inf BEFORE `exp` (`_masked_exp`): the same forward values, and a finite
gradient whatever the decays.

The decode steps are functional (they return a new state);
`transformer._block_decode` writes it into the stacked cache in place.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from . import layers as L

PyTree = Any


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x [B,T,C], w [K,C] (K small, unrolled)."""
    K = w.shape[0]
    out = x * w[K - 1]
    for j in range(1, K):
        shifted = F.pad(x, (0, 0, j, 0))[:, :-j]
        out = out + shifted * w[K - 1 - j]
    return out


def _masked_exp(diff: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """exp(diff) where mask, exactly 0 elsewhere — masked before `exp`,
    so a large masked exponent never reaches the backward pass."""
    return torch.exp(diff.masked_fill(~mask, float("-inf")))


def _chunks(T: int, chunk: int) -> int:
    Q = min(chunk, T)
    assert T % Q == 0, (T, Q)
    return Q


# =====================================================================
# Mamba2-style SSD mixer (hymba SSM heads)
# =====================================================================
class MambaState(NamedTuple):
    S: torch.Tensor          # [B, H, N, P] fp32
    conv: torch.Tensor       # [B, K-1, d_inner] trailing inputs
    pos: torch.Tensor


def mamba_spec(cfg: ModelConfig, Lyr: int) -> dict:
    """`mamba_init` (ssm.py:47) as (shape, init, fan_in) spec entries,
    stacked over Lyr layers: dt_bias 0, A_log 0 (a = -1), D 1, the
    conv taps 1/K."""
    d = cfg.d_model
    H = cfg.ssm_heads or cfg.n_heads
    HP = H * (d // H)
    N = cfg.ssm_state
    return {"w_x": ((Lyr, d, HP), "dense", d),
            "w_z": ((Lyr, d, HP), "dense", d),
            "w_B": ((Lyr, d, N), "dense", d),
            "w_C": ((Lyr, d, N), "dense", d),
            "w_dt": ((Lyr, d, H), "dense", d),
            "dt_bias": ((Lyr, H), 0.0, 0),
            "A_log": ((Lyr, H), 0.0, 0),
            "D": ((Lyr, H), "ones", 0),
            "conv_w": ((Lyr, cfg.ssm_conv, HP), 1.0 / cfg.ssm_conv, 0),
            "norm": {"scale": ((Lyr, HP), "ones", 0)},
            "w_out": ((Lyr, HP, d), "dense", HP)}


def _mamba_features(params, cfg, x, compute_dtype):
    H = cfg.ssm_heads or cfg.n_heads
    P = x.shape[-1] // H
    x = x.to(compute_dtype)
    xs = x @ params["w_x"].to(compute_dtype)               # [B,T,HP]
    z = x @ params["w_z"].to(compute_dtype)
    Bm = x @ params["w_B"].to(compute_dtype)               # [B,T,N]
    Cm = x @ params["w_C"].to(compute_dtype)
    dt = F.softplus((x @ params["w_dt"].to(compute_dtype)).float()
                    + params["dt_bias"].float())           # [B,T,H]
    a = -torch.exp(params["A_log"].float())                # [H] < 0
    return xs, z, Bm, Cm, dt, a, H, P


def _mamba_out(params, cfg, y, xh, z, compute_dtype):
    """y + D·x, gated by silu(z), normed, projected out."""
    B, T = y.shape[:2]
    y = y + params["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, T, -1).to(compute_dtype) * F.silu(z)
    y = L.rmsnorm(params["norm"], y, cfg.norm_eps)
    return y @ params["w_out"].to(compute_dtype)


def mamba_forward(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                  compute_dtype=torch.bfloat16, chunk: int = 64
                  ) -> torch.Tensor:
    """Chunked SSD over [B,T,D] (ssm.py:81)."""
    B, T, _ = x.shape
    xs, z, Bm, Cm, dt, a, H, P = _mamba_features(params, cfg, x,
                                                 compute_dtype)
    xs = F.silu(_causal_conv(xs, params["conv_w"].to(compute_dtype)))
    xh = xs.reshape(B, T, H, P)
    N = Bm.shape[-1]
    llog = dt * a                                          # [B,T,H]
    u = xh.float() * dt[..., None]                         # [B,T,H,P]
    Q = _chunks(T, chunk)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    Bf, Cf = Bm.float(), Cm.float()
    S = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, T, Q):
        sl = slice(c0, c0 + Q)
        cum = torch.cumsum(llog[:, sl], dim=1)             # [B,Q,H]
        uq, Bq, Cq = u[:, sl], Bf[:, sl], Cf[:, sl]
        CB = torch.einsum("btn,bsn->bts", Cq, Bq)          # [B,Q,Q]
        M = _masked_exp(cum[:, :, None, :] - cum[:, None, :, :], mask)
        y_intra = torch.einsum("btsh,bshp->bthp", CB[..., None] * M, uq)
        y_state = torch.einsum("btn,bhnp->bthp", Cq, S) \
            * torch.exp(cum)[..., None]
        clast = cum[:, -1:, :]                             # [B,1,H]
        S = (torch.exp(clast)[:, 0, :, None, None] * S
             + torch.einsum("bsn,bshp->bhnp", Bq,
                            torch.exp(clast - cum)[..., None] * uq))
        ys.append(y_intra + y_state)
    y = torch.cat(ys, dim=1)
    return _mamba_out(params, cfg, y, xh, z, compute_dtype)


def mamba_init_state(cfg: ModelConfig, batch: int, dtype,
                     device: torch.device, per_slot: bool = False
                     ) -> MambaState:
    d = cfg.d_model
    H = cfg.ssm_heads or cfg.n_heads
    P = d // H
    return MambaState(
        torch.zeros((batch, H, cfg.ssm_state, P), dtype=torch.float32,
                    device=device),
        torch.zeros((batch, cfg.ssm_conv - 1, H * P), dtype=dtype,
                    device=device),
        torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                    device=device))


def mamba_decode_step(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                      state: MambaState, compute_dtype=torch.bfloat16
                      ) -> Tuple[torch.Tensor, MambaState]:
    """x: [B,1,D] -> (out [B,1,D], new state) (ssm.py:143)."""
    B = x.shape[0]
    xs, z, Bm, Cm, dt, a, H, P = _mamba_features(params, cfg, x,
                                                 compute_dtype)
    hist = torch.cat([state.conv.to(xs.dtype), xs], dim=1)   # [B,K,HP]
    w = params["conv_w"].to(compute_dtype)
    xs = F.silu(torch.einsum("bkc,kc->bc", hist, w))[:, None]
    xh = xs.reshape(B, H, P).float()
    decay = torch.exp(dt[:, 0] * a)                        # [B,H]
    u = xh * dt[:, 0, :, None]
    S = (decay[:, :, None, None] * state.S
         + torch.einsum("bn,bhp->bhnp", Bm[:, 0].float(), u))
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), S)
    out = _mamba_out(params, cfg, y[:, None], xh[:, None], z, compute_dtype)
    return out, MambaState(S, hist[:, 1:], state.pos + 1)


# =====================================================================
# RWKV6 (Finch): time-mix with data-dependent per-channel decay
# =====================================================================
class RWKVState(NamedTuple):
    S: torch.Tensor        # [B, H, K, V] wkv state, fp32
    x_time: torch.Tensor   # [B, D] previous token (time-mix shift)
    x_chan: torch.Tensor   # [B, D] previous token (channel-mix shift)
    pos: torch.Tensor


def rwkv_time_spec(cfg: ModelConfig, Lyr: int) -> dict:
    """`rwkv_time_init` (ssm.py:178) as spec entries: mu 0.5, decay_base
    -6, the decay LoRA at std 0.01, bonus 0, ln_x 1. The config's
    `rwkv_mix_lora` is unused, as in the reference."""
    d, K = cfg.d_model, cfg.rwkv_head_dim
    lora = cfg.rwkv_decay_lora
    return {"mu": ((Lyr, 5, d), 0.5, 0),
            "w_r": ((Lyr, d, d), "dense", d),
            "w_k": ((Lyr, d, d), "dense", d),
            "w_v": ((Lyr, d, d), "dense", d),
            "w_g": ((Lyr, d, d), "dense", d),
            "decay_base": ((Lyr, d), -6.0, 0),
            "decay_A": ((Lyr, d, lora), "lora", 0),
            "decay_B": ((Lyr, lora, d), "lora", 0),
            "bonus": ((Lyr, d // K, K), 0.0, 0),
            "ln_x": ((Lyr, d), "ones", 0),
            "w_o": ((Lyr, d, d), "dense", d)}


def rwkv_chan_spec(cfg: ModelConfig, Lyr: int) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {"mu": ((Lyr, 2, d), 0.5, 0),
            "w_r": ((Lyr, d, d), "dense", d),
            "w_k": ((Lyr, d, ff), "dense", d),
            "w_v": ((Lyr, ff, d), "dense", ff)}


def _rwkv_features(params, cfg, x, x_prev, compute_dtype):
    """x: [B,T,D]; x_prev: [B,1,D] the token before the window."""
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
    mu = params["mu"].to(compute_dtype)
    xr, xk, xv, xw, xg = (x + (shifted - x) * mu[i] for i in range(5))
    r = xr @ params["w_r"].to(compute_dtype)
    k = xk @ params["w_k"].to(compute_dtype)
    v = xv @ params["w_v"].to(compute_dtype)
    g = F.silu(xg @ params["w_g"].to(compute_dtype))
    # data-dependent decay (the Finch contribution): w = exp(-exp(...))
    dd = torch.tanh(xw @ params["decay_A"].to(compute_dtype)) \
        @ params["decay_B"].to(compute_dtype)
    logw = -torch.exp(torch.clamp(params["decay_base"].float() + dd.float(),
                                  -12.0, 2.0))             # [B,T,D] < 0
    return r, k, v, g, logw


def _rwkv_out(params, cfg, y, g, compute_dtype):
    y = L.rmsnorm({"scale": params["ln_x"]}, y.to(compute_dtype),
                  cfg.norm_eps)
    return (y * g) @ params["w_o"].to(compute_dtype)


def rwkv_time_forward(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                      compute_dtype=torch.bfloat16, chunk: int = 32
                      ) -> torch.Tensor:
    """Chunked time mix over [B,T,D] (ssm.py:216)."""
    B, T, d = x.shape
    K = cfg.rwkv_head_dim
    H = d // K
    x = x.to(compute_dtype)
    x_prev = torch.zeros((B, 1, d), dtype=compute_dtype, device=x.device)
    r, k, v, g, logw = _rwkv_features(params, cfg, x, x_prev, compute_dtype)
    r, k, v = (t.reshape(B, T, H, K).float() for t in (r, k, v))
    lw = logw.reshape(B, T, H, K)
    Q = _chunks(T, chunk)
    u = params["bonus"].float()                            # [H,K]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device),
                      diagonal=-1)[None, :, :, None, None]
    S = torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, T, Q):
        sl = slice(c0, c0 + Q)
        rq, kq, vq, lq = r[:, sl], k[:, sl], v[:, sl], lw[:, sl]
        cq = torch.cumsum(lq, dim=1)                       # inclusive
        cpq = cq - lq                                      # exclusive
        # strict-lower scores: A[t,s] = sum_k r_t k_s exp(cprev_t - c_s)
        W = _masked_exp(cpq[:, :, None] - cq[:, None], mask)
        A = (rq[:, :, None] * W * kq[:, None]).sum(-1)     # [B,Q,Q,H]
        diag = (rq * u * kq).sum(-1)                       # [B,Q,H]
        y = (torch.einsum("btsh,bshv->bthv", A, vq)
             + diag[..., None] * vq
             + torch.einsum("bthk,bhkv->bthv", rq * torch.exp(cpq), S))
        clast = cq[:, -1]                                  # [B,H,K]
        S = (torch.exp(clast)[..., None] * S
             + torch.einsum("bshk,bshv->bhkv",
                            torch.exp(clast[:, None] - cq) * kq, vq))
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(B, T, d)
    return _rwkv_out(params, cfg, y, g, compute_dtype)


def rwkv_chan_forward(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                      x_prev: torch.Tensor, compute_dtype=torch.bfloat16
                      ) -> torch.Tensor:
    """x: [B,T,D]; x_prev [B,1,D] (ssm.py:282)."""
    x = x.to(compute_dtype)
    shifted = torch.cat([x_prev.to(compute_dtype), x[:, :-1]], dim=1)
    mu = params["mu"].to(compute_dtype)
    xr = x + (shifted - x) * mu[0]
    xk = x + (shifted - x) * mu[1]
    r = torch.sigmoid(xr @ params["w_r"].to(compute_dtype))
    k = torch.square(torch.relu(xk @ params["w_k"].to(compute_dtype)))
    return r * (k @ params["w_v"].to(compute_dtype))


def rwkv_init_state(cfg: ModelConfig, batch: int, dtype,
                    device: torch.device, per_slot: bool = False
                    ) -> RWKVState:
    d, K = cfg.d_model, cfg.rwkv_head_dim
    return RWKVState(
        torch.zeros((batch, d // K, K, K), dtype=torch.float32,
                    device=device),
        torch.zeros((batch, d), dtype=dtype, device=device),
        torch.zeros((batch, d), dtype=dtype, device=device),
        torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                    device=device))


def rwkv_decode_step(tparams: PyTree, cfg: ModelConfig, x: torch.Tensor,
                     state: RWKVState, compute_dtype=torch.bfloat16
                     ) -> Tuple[torch.Tensor, RWKVState]:
    """One-token time mix (ssm.py:295). x: [B,1,D], the block's normed
    input. Returns (time_out, state with S, x_time and pos advanced; the
    block sets x_chan)."""
    B, _, d = x.shape
    K = cfg.rwkv_head_dim
    H = d // K
    x = x.to(compute_dtype)
    r, k, v, g, logw = _rwkv_features(
        tparams, cfg, x, state.x_time[:, None].to(compute_dtype),
        compute_dtype)
    r, k, v = (t[:, 0].reshape(B, H, K).float() for t in (r, k, v))
    w = torch.exp(logw[:, 0]).reshape(B, H, K)
    u = tparams["bonus"].float()
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    y = torch.einsum("bhk,bhkv->bhv", r, state.S + u[None, :, :, None] * kv)
    S_new = w[..., None] * state.S + kv
    out = _rwkv_out(tparams, cfg, y.reshape(B, 1, d), g, compute_dtype)
    return out, RWKVState(S_new, x[:, 0], state.x_chan, state.pos + 1)
