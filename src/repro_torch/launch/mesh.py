"""Meshes over ``torch.distributed`` ranks (the reference's
``launch/mesh.py``).

* :func:`make_mesh` / :func:`make_host_mesh`: a grid of the ranks there
  are, with one process subgroup per line of the grid along each axis
  (tensor-parallel serving, the collectives).
* :func:`make_production_mesh`: the reference's pod-scale mesh, 16×16
  ``("data", "model")`` or 2×16×16 ``("pod", "data", "model")``, as a
  ``DeviceMesh`` over the default group. The dry run
  (``launch/dryrun.py``) makes that group a fake one of 256 or 512 ranks
  in one process.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence, Tuple

import torch
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


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The pod-scale ``DeviceMesh``: ``(16, 16)`` ``("data", "model")``, or
    ``(2, 16, 16)`` ``("pod", "data", "model")`` with ``multi_pod``, over
    the default group (its world size must be 256 or 512). ``device`` is
    the mesh's device type: the card unless the caller asks for the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(model: int = 1) -> HostMesh:
    """``("data", "model")`` over the ranks there are: ``model`` clamped to
    ``[1, world]``, the rest data (tests and examples)."""
    n = dist.get_world_size()
    model = max(1, min(model, n))
    return make_mesh((n // model, model), ("data", "model"))
