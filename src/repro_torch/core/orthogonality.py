"""Per-layer gradient orthogonality metric (paper §3.6, Fig. 1) — the
port of `repro/core/orthogonality.py`.

orthogonality(g_1..g_n) = ‖Adasum(g_[1,n])‖² / Σ_i ‖g_i‖²

Value 1 ⇒ gradients mutually orthogonal (Adasum sums them);
value 1/n ⇒ gradients parallel with equal norm (Adasum averages).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Union

import torch

from repro_torch import tree as T

from .adasum import EPS, _as_lanes, adasum_tree_reduce

PyTree = Any


def per_layer_orthogonality(grads: Union[Sequence[PyTree], PyTree],
                            acc_dtype=torch.float32
                            ) -> Dict[str, torch.Tensor]:
    """Returns {layer_path: orthogonality scalar} plus '__mean__' (Fig. 1
    red line); paths are the reference's `keystr` ones ("['blocks']
    ['attn']['wq']").

    `grads` as in adasum_tree_reduce: list of pytrees or stacked leading
    axis."""
    grads = _as_lanes(grads)
    combined = adasum_tree_reduce(grads, per_layer=True, acc_dtype=acc_dtype)
    flat_gs = [T.leaves(g) for g in grads]
    out: Dict[str, torch.Tensor] = {}
    vals = []
    for i, (path, c) in enumerate(T.flatten_with_path(combined)[0]):
        num = torch.sum(c.to(acc_dtype) ** 2)
        den = sum(torch.sum(g[i].to(acc_dtype) ** 2) for g in flat_gs)
        o = num / (den + EPS)
        out[T.keystr(path)] = o
        vals.append(o)
    out["__mean__"] = torch.mean(torch.stack(vals))
    return out
