"""Meshes as plain descriptors (the port's `repro/launch/mesh.py`; it
imports nothing of JAX).

A `Mesh` names its axes, their sizes and the rank <-> coordinates map.
The port runs one process a rank, so a mesh is a layout of ranks, not
of devices: `("data", "model")` with the model index innermost, rank
r = d·M + m, as `jax.make_mesh((data, model))` lays out its devices. A
model group is the M contiguous ranks of one data index; a data group
is the ranks of one model index.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        return self.sizes.get(name, 1)

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank -> its index on each axis (the last axis innermost)."""
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.shape))):
            out[name] = rank % n
            rank //= n
        return out

    def groups(self, axis: str) -> List[List[int]]:
        """The ranks that differ only along `axis`, one list per group,
        each in the axis's order (a partition of the ranks)."""
        out: Dict[tuple, List[int]] = {}
        for r in range(self.size):
            c = self.coords(r)
            key = tuple(v for k, v in c.items() if k != axis)
            out.setdefault(key, []).append(r)
        return [out[k] for k in sorted(out)]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (16, 16) = (data, model); multi-pod: (2, 16, 16) =
    (pod, data, model). Sizes only (mesh.py:18-23)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1, n: int = 1) -> Mesh:
    """A (data, model) mesh over `n` ranks or devices; when data·model
    exceeds n it falls back to (n, 1), as the reference's does over the
    devices it finds (mesh.py:26-32)."""
    if data * model > n:
        data, model = n, 1
    return Mesh(("data", "model"), (data, model))
