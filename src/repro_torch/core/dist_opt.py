"""DistributedOptimizer — the Horovod integration point (paper §4.1), the
port of `repro/core/dist_opt.py`.

  * pre-optimizer  ('pre'):  combined = Combine(per-lane gradients),
        then ONE optimizer step with the combined gradient (SGD,
        Momentum, and the Sum baseline for everything).
  * post-optimizer ('post'): each lane steps its OWN optimizer on its
        gradient; the deltas are combined and applied (Adam/LAMB: Adasum
        must not inflate the minibatch the optimizer logic sees).

Lanes are either stacked on one device (`stacked=True`: leaves carry a
leading [span] lane axis) or one per rank (`stacked=False`: each rank
holds its own lane's gradient and, at the post point, its own lane's
optimizer state — the reference's per-rank state, build.py:264-282; the
combiner reduces across ranks and returns the same tree on every rank).

Stacked lanes run in a Python loop, not `vmap`. Optimizer states are
updated in place (see `repro_torch.optim.optimizers`); at the post point
each lane's fp32 delta overwrites that lane's gradient in place when the
gradients are fp32, so no second [span, ...] tree is allocated. `apply`
writes the params in place. The step counter is a Python int.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.optim.optimizers import Optimizer
from .combine import CombineConfig

PyTree = Any


@dataclasses.dataclass(frozen=True)
class DistributedOptimizer:
    opt: Optimizer
    cfg: CombineConfig
    combiner: Callable[[PyTree], PyTree]
    span: int = 1
    stacked: bool = True        # lanes stacked on one device; False: one
                                # lane per rank, no lane axis
    # across ranks with the state sharded (ZeRO-1): params -> a tree of
    # stand-ins of this rank's state shapes (only their shape and device
    # are read), which `init` builds the state from
    state_like: Optional[Callable[[PyTree], PyTree]] = None

    @property
    def point(self) -> str:
        if self.cfg.op in ("sum", "mean"):
            return "pre"   # classic synchronous SGD: reduce, then step
        if self.cfg.point == "auto":
            return self.opt.default_combine_point
        return self.cfg.point

    def init(self, params: PyTree) -> Dict[str, Any]:
        state = self.opt.init(self.state_like(params) if self.state_like
                              else params)
        if self.point == "post" and self.span > 1 and self.stacked:
            # one optimizer state per lane (Horovod: per-node state)
            state = T.map(lambda x: x.expand((self.span,) + tuple(x.shape))
                          .clone(), state)
        return {"inner": state, "step": 0}

    def update(self, stacked_grads: PyTree, state: Dict[str, Any],
               params: PyTree) -> Tuple[PyTree, Dict[str, Any]]:
        """stacked_grads: leaves [span, *shape] (this rank's lane
        gradient, no lane axis, when not stacked). Returns (delta,
        state)."""
        delta, new_state, _ = self._update(stacked_grads, state, params,
                                           self.combiner)
        return delta, new_state

    def update_stats(self, stacked_grads: PyTree, state: Dict[str, Any],
                     params: PyTree, stats_combiner: Callable
                     ) -> Tuple[PyTree, Dict[str, Any], Optional[PyTree]]:
        """`update` routed through a stats-enabled combiner: returns
        (delta, state, CombineStats); stats is None when no combine ran
        (post point, span 1)."""
        return self._update(stacked_grads, state, params, stats_combiner)

    def _update(self, stacked_grads, state, params, combiner):
        stats = None

        def combine(tree):
            nonlocal stats
            out = combiner(tree)
            if isinstance(out, tuple):
                out, stats = out
            return out

        step = state["step"]
        if not self.stacked:
            if self.point == "pre":
                delta, inner = self.opt.update(combine(stacked_grads),
                                               state["inner"], params, step)
            else:       # this rank's own state, then combine the deltas
                d, inner = self.opt.update(stacked_grads, state["inner"],
                                           params, step)
                delta = combine(d)
        elif self.point == "pre":
            combined = combine(stacked_grads)
            delta, inner = self.opt.update(combined, state["inner"], params,
                                           step)
        elif self.span > 1:
            deltas = stacked_grads
            if any(x.dtype != torch.float32
                   for x in T.leaves(stacked_grads)):
                deltas = T.map(lambda x: torch.empty(
                    x.shape, dtype=torch.float32, device=x.device),
                    stacked_grads)
            for i in range(self.span):
                g = T.map(lambda x: x[i], stacked_grads)
                s = T.map(lambda x: x[i], state["inner"])
                d, _ = self.opt.update(g, s, params, step)
                T.map(lambda out, v: out[i].copy_(v), deltas, d)
                del g, d
            inner = state["inner"]
            delta = combine(deltas)
        else:
            g = T.map(lambda x: x[0], stacked_grads)
            delta, inner = self.opt.update(g, state["inner"], params, step)
        return delta, {"inner": inner, "step": step + 1}, stats

    @staticmethod
    def apply(params: PyTree, delta: PyTree) -> PyTree:
        """params <- (params.float() + delta).to(params.dtype), in place
        (``.float()`` of fp32 params is the params themselves, so there
        the add is in place with no param-sized temporary)."""
        T.map(lambda p, d: p.copy_(p.float().add_(d)), params, delta)
        return params
