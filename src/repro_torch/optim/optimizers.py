"""Optimizers as (init, update) pairs over pytrees (the port of
`repro/optim/optimizers.py`): Momentum-SGD (paper §5.1), Adam and LAMB
(§5.3).

`update(grads, state, params, step)` returns (delta, state) with
`params_new = params + delta` — the quantity the post-optimizer Adasum
mode combines (paper Fig. 3). `step` is a Python int. Unlike the
reference, whose functions are pure, `update` writes the new state into
the state tensors it is given and returns them: at full width a second
copy of the optimizer state would not fit beside the lane gradients (the
reference's session donates its state the same way). A caller that
needs the old state clones it first.

On a shard of each leaf (ZeRO-1 across ranks, or a rank's model shard)
the elementwise updates need nothing more. LAMB's trust ratio takes the
norms of the whole leaf (optimizers.py:148-151 of the reference):
`update(..., norm_sum=)` gives a tree of callables, one a leaf, that sum
the shard's squared norms over the ranks holding the leaf's other shards
(the lane group, every rank, or the model group where the model axis
shards the leaf; identity for a whole leaf).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch import tree as T

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """init(params) -> state; update(grads, state, params, step) ->
    (delta, state)."""
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, int], Tuple[PyTree, PyTree]]
    name: str = "opt"
    # Paper §4.1: stateless/linear optimizers combine gradients BEFORE the
    # optimizer ("pre"); adaptive ones combine deltas AFTER ("post").
    default_combine_point: str = "pre"
    reads_params: bool = True   # the update reads `params` (weight decay,
                                # trust ratio); else any tree of the
                                # grads' structure will do


def _as_schedule(lr) -> Callable[[int], float]:
    return lr if callable(lr) else (lambda step: float(lr))


def _zeros(dtype):
    return lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)


def sgd(lr) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return ()

    def update(grads, state, params, step, norm_sum=None):
        a = sched(step)
        return T.map(lambda g: -a * g.float(), grads), state

    return Optimizer(init, update, "sgd", "pre", reads_params=False)


def momentum(lr, beta: float = 0.9, nesterov: bool = False,
             weight_decay: float = 0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return {"m": T.map(_zeros(torch.float32), params)}

    def update(grads, state, params, step, norm_sum=None):
        a = sched(step)

        def upd(g, m, p):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            m.copy_(beta * m + g)
            d = (g + beta * m) if nesterov else m
            return -a * d

        return T.map(upd, grads, state["m"], params), state

    return Optimizer(init, update, "momentum", "pre",
                     reads_params=bool(weight_decay))


def _adam_core(g, m, v, step: int, b1: float, b2: float, eps: float):
    """Returns (u, m_new, v_new) in fp32 for fp32 m, v, which it updates
    in place: m_new = b1·m + (1-b1)·g, v_new = b2·v + (1-b2)·g², u =
    m̂ / (sqrt(v̂) + eps). The same fp32 operations in the same order as
    the out-of-place formula, with at most two leaf-sized temporaries at a
    time (the embedding leaf alone would otherwise take five more)."""
    g = g.float()
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((g * g).mul_(1.0 - b2))
    t = torch.tensor(step + 1.0, dtype=torch.float32)
    c1 = (1.0 - torch.tensor(b1, dtype=torch.float32) ** t).item()
    c2 = (1.0 - torch.tensor(b2, dtype=torch.float32) ** t).item()
    denom = (v / c2).sqrt_().add_(eps)
    return (m / c1).div_(denom), m, v


ADAM_PIECE = 1 << 24     # elements of a leaf an adam pass takes at a time


def _adam_pieces(g, m, v, step: int, b1: float, b2: float, eps: float):
    """`_adam_core` on a leaf, m and v updated in place in their own
    dtype; returns u in fp32. A leaf of more than ADAM_PIECE elements
    goes a slice of its first dim longer than 1 at a time: the same
    elementwise fp32 operations, with the fp32 copies of a bf16 state and
    the temporaries of a slice rather than of the leaf."""
    k = next((i for i, n in enumerate(g.shape) if n > 1), None)
    if k is None or g.numel() <= ADAM_PIECE:
        u, m_new, v_new = _adam_core(g, m.float(), v.float(), step, b1, b2,
                                     eps)
        m.copy_(m_new)
        v.copy_(v_new)
        return u
    u = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    n = max(1, ADAM_PIECE * g.shape[k] // g.numel())
    for i in range(0, g.shape[k], n):
        w = min(n, g.shape[k] - i)
        part = lambda x: x.narrow(k, i, w)
        u_i, m_new, v_new = _adam_core(part(g), part(m).float(),
                                       part(v).float(), step, b1, b2, eps)
        part(m).copy_(m_new)
        part(v).copy_(v_new)
        part(u).copy_(u_i)
        del u_i, m_new, v_new
    return u


def _adam_like(lr, b1, b2, eps, weight_decay, state_dtype, trust: bool,
               min_trust: float = 0.0, max_trust: float = 10.0):
    sched = _as_schedule(lr)

    def init(params):
        z = _zeros(state_dtype)
        return {"m": T.map(z, params), "v": T.map(z, params)}

    def update(grads, state, params, step, norm_sum=None):
        a = sched(step)

        def upd(g, m, v, p, total=None):
            u = _adam_pieces(g, m, v, step, b1, b2, eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            if not trust:
                return u.mul_(-a)
            p32 = p.float().reshape(-1)
            if total is None:
                pn = torch.linalg.vector_norm(p32)
                un = torch.linalg.vector_norm(u.reshape(-1))
            else:   # a shard: the leaf's squared norms, summed over shards
                sq = total(torch.stack([p32.dot(p32),
                                        u.reshape(-1).dot(u.reshape(-1))]))
                pn, un = sq[0].sqrt(), sq[1].sqrt()
            ratio = torch.where((pn > 0) & (un > 0),
                                torch.clamp(pn / (un + 1e-12), min_trust,
                                            max_trust),
                                torch.ones((), device=u.device))
            return -a * ratio * u

        trees = [grads, state["m"], state["v"], params]
        if norm_sum is not None:
            trees.append(norm_sum)
        return T.map(upd, *trees), state

    return init, update


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, state_dtype=torch.float32) -> Optimizer:
    """state_dtype=bf16 halves optimizer memory; the update math still
    runs in fp32 — only storage is compressed."""
    init, update = _adam_like(lr, b1, b2, eps, weight_decay, state_dtype,
                              trust=False)
    return Optimizer(init, update, "adam", "post",
                     reads_params=bool(weight_decay))


def lamb(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.01, min_trust: float = 0.0,
         max_trust: float = 10.0, state_dtype=torch.float32) -> Optimizer:
    """LAMB (You et al. 2019): Adam core + per-layer trust ratio
    ‖p‖/‖u‖ scaling."""
    init, update = _adam_like(lr, b1, b2, eps, weight_decay, state_dtype,
                              trust=True, min_trust=min_trust,
                              max_trust=max_trust)
    return Optimizer(init, update, "lamb", "post")


_REGISTRY = {"sgd": sgd, "momentum": momentum, "adam": adam, "lamb": lamb}


def get_optimizer(name: str, lr, **kwargs) -> Optimizer:
    if name not in _REGISTRY:
        raise KeyError(f"unknown optimizer {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](lr, **kwargs)
