"""Params across frameworks, through numpy.

The port never touches JAX. A caller that holds the JAX package's params
converts them with `np.asarray` leaf by leaf (e.g.
`jax.tree.map(np.asarray, params)`) and hands the nested dict of numpy
arrays to `params_from_numpy`; `params_to_numpy` is the reverse. The
stacked `[L, ...]` block leaves map one for one — the two packages keep
the same tree and the same layouts (`x @ W`, `W [in, out]`).

For the model axis: `pad_params` turns unpadded params into the params
of `pad_heads_for_tp`'s config (`attention.convert_gqa_params` on each
block stack, exact), and `tp_shard` cuts one rank's model shard of
every leaf by the specs the port trains with.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.runtime import DeviceLike, resolve_device

PyTree = Any


def params_from_numpy(tree: PyTree, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None,
                      cfg=None) -> PyTree:
    """Nested dict of numpy arrays -> the same dict of tensors on
    `device` (cast to `dtype` if given). bfloat16 leaves (ml_dtypes)
    pass through float32, which holds them exactly. With `cfg`, every
    leaf is checked against the port's params spec."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))   # owns its data
        return t.to(device=dev, dtype=dtype or t.dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return conv(node)
    out = walk(tree)
    if cfg is not None:
        from repro_torch.models.transformer import param_spec
        _check_tree(out, param_spec(cfg), "params")
    return out


def params_to_numpy(tree: PyTree) -> PyTree:
    """Tensors -> numpy (bfloat16 leaves come back as float32)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        t = node.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return walk(tree)


def _check_tree(tree, spec, path: str) -> None:
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            raise ValueError(f"{path}: keys {sorted(tree)} != "
                             f"{sorted(spec)}")
        for k in spec:
            _check_tree(tree[k], spec[k], f"{path}.{k}")
    elif tuple(tree.shape) != tuple(spec[0]):
        raise ValueError(f"{path}: shape {tuple(tree.shape)} != {spec[0]}")


def pad_params(tree: PyTree, cfg, cfg_pad) -> PyTree:
    """Params of `cfg` (tensors, or numpy arrays as the JAX package's
    come) -> the exact params of its head-padded `cfg_pad`: every block
    stack's GQA leaves converted, the rest shared (MLA pads no heads:
    `pad_heads_for_tp` returns its config as it is)."""
    from repro_torch.models.attention import convert_gqa_params
    out = dict(tree)
    if cfg.attn_type != "gqa":
        return out
    for key in ("dense_blocks", "blocks"):
        if key in out and "attn" in out[key]:
            attn = {k: torch.as_tensor(np.asarray(v)) if not
                    isinstance(v, torch.Tensor) else v
                    for k, v in out[key]["attn"].items()}
            out[key] = dict(out[key], attn=convert_gqa_params(
                attn, cfg, cfg_pad, dtype=attn["wq"].dtype))
    return out


def tp_shard(tree: PyTree, cfg, model_size: int, index: int) -> PyTree:
    """Rank `index`'s model shard of every whole leaf (`parallel.tp`
    specs over `model_size` ranks; a leaf the axis does not shard is
    the whole leaf), as views."""
    from repro_torch import tree as T
    from repro_torch.parallel.sharding import spec_leaves
    from repro_torch.parallel.tp import model_shard, model_specs
    leaves, td = T.flatten(tree)
    specs = spec_leaves(model_specs(cfg, tree, model_size))
    return T.unflatten(td, [model_shard(x, s, model_size, index)
                            for x, s in zip(leaves, specs)])
