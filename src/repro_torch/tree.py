"""Nested dicts, tuples and lists of tensors, walked in `jax.tree.flatten`
order.

JAX flattens a dict in SORTED key order, tuples and lists in position
order, and treats `None` as a node with no leaves. Fusion layouts,
buckets and segment ids are built from the flattened leaf list, so the
port must see the leaves in exactly that order (gemma-7b:
`blocks.attn.{wk,wo,wq,wv}`, `blocks.mlp.{w_down,w_gate,w_up}`,
`blocks.norm1`, `blocks.norm2`, `embed.table`, `final_norm`).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

PyTree = Any
TreeDef = Any       # ("dict", keys, children) | ("tuple"/"list", children)
                    # | ("none",) | LEAF

LEAF = "*"


def _walk(node, leaves: list):
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("dict", keys, tuple(_walk(node[k], leaves) for k in keys))
    if isinstance(node, (tuple, list)):
        kind = "tuple" if isinstance(node, tuple) else "list"
        return (kind, tuple(_walk(c, leaves) for c in node))
    if node is None:
        return ("none",)
    leaves.append(node)
    return LEAF


def flatten(tree: PyTree) -> Tuple[List[Any], TreeDef]:
    # module-level helpers, not a recursive closure: a closure that calls
    # itself is a reference cycle, which would keep every leaf tensor
    # alive until the cyclic garbage collector happens to run
    leaves: List[Any] = []
    treedef = _walk(tree, leaves)
    return leaves, treedef


def _build(td, it):
    if td == LEAF:
        return next(it)
    if td[0] == "dict":
        return {k: _build(c, it) for k, c in zip(td[1], td[2])}
    if td[0] == "none":
        return None
    out = [_build(c, it) for c in td[1]]
    return tuple(out) if td[0] == "tuple" else out


def unflatten(treedef: TreeDef, leaves) -> PyTree:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def leaves(tree: PyTree) -> List[Any]:
    return flatten(tree)[0]


def _walk_paths(node, path: tuple, out: list) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _walk_paths(node[k], path + (k,), out)
    elif isinstance(node, (tuple, list)):
        for i, c in enumerate(node):
            _walk_paths(c, path + (i,), out)
    elif node is not None:
        out.append((path, node))


def flatten_with_path(tree: PyTree) -> Tuple[List[Tuple[tuple, Any]],
                                             TreeDef]:
    """`jax.tree_util.tree_flatten_with_path`: ([(path, leaf)], treedef),
    leaves in `flatten` order; a path is the tuple of dict keys and
    sequence indices from the root."""
    out: List[Tuple[tuple, Any]] = []
    _walk_paths(tree, (), out)
    return out, flatten(tree)[1]


def keystr(path: tuple) -> str:
    """`jax.tree_util.keystr`: "['opt']['inner']['m']['embed']['table']"
    for dict keys, "[0]" for sequence indices — the leaf names a
    checkpoint manifest records."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """`jax.tree.map`: fn over the leaves of `tree` and, leaf for leaf,
    of each tree in `rest` (which must share its structure)."""
    flat, td = flatten(tree)
    others = []
    for r in rest:
        fl, rtd = flatten(r)
        if rtd != td:
            raise ValueError("tree structures differ")
        others.append(fl)
    return unflatten(td, [fn(*xs) for xs in zip(flat, *others)])
