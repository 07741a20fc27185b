"""Host meshes over ``torch.distributed`` ranks (the reference's
``launch/mesh.py``): a grid of the ranks there are, with one process
subgroup per line of the grid along each axis.

``make_production_mesh`` (the reference's pod-scale mesh) is not here: only
its dry run uses it, and that tooling is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence, Tuple

import torch.distributed as dist


@dataclasses.dataclass
class HostMesh:
    """Ranks laid out row-major over ``shape`` (axis names ``axis_names``);
    :meth:`group` is the subgroup of this rank's line along an axis."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    groups: Dict[str, Any]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def coords(self, rank: int) -> Tuple[int, ...]:
        out = []
        for n in reversed(self.shape):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def group(self, axis: str) -> Any:
        return self.groups[axis]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> HostMesh:
    """A mesh over every rank of the initialized default group (its size
    must be ``prod(shape)``). Every rank calls it, in the same order: each
    line's ``new_group`` is collective."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"group has {world}")
    rank = dist.get_rank()
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    groups: Dict[str, Any] = {}
    for a, name in enumerate(axis_names):
        others = [i for i in range(len(shape)) if i != a]
        lines = {}
        for r in range(world):
            key = tuple((r // strides[i]) % shape[i] for i in others)
            lines.setdefault(key, []).append(r)
        for ranks in lines.values():      # the same order on every rank
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = g
    return HostMesh(shape, axis_names, groups)


def make_host_mesh(model: int = 1) -> HostMesh:
    """``("data", "model")`` over the ranks there are: ``model`` clamped to
    ``[1, world]``, the rest data (tests and examples)."""
    n = dist.get_world_size()
    model = max(1, min(model, n))
    return make_mesh((n // model, model), ("data", "model"))
