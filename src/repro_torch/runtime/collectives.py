"""Collectives over ``torch.distributed`` process groups: the gathers of
tensor-parallel serving, a ring all-gather, and hierarchical gradient
reduction with the int8 codec on the pod level (the reference's
``runtime/collectives.py``).

The reference names a mesh axis inside ``shard_map``; a model's layers here
name a process group the same way (``cfg.tp_axis``). :func:`register_group`
binds a name to the group that a tensor-parallel engine's ranks share
(``serving/tp.py`` binds ``"model"`` on every rank while its group lives,
and unbinds it when the group closes).

``hierarchical_psum`` makes the reduction's hierarchy explicit:

    all-reduce over "data"  — full precision, inside a pod
    [codec]                 — int8 quantization (optim.grad_compress)
    all-reduce over "pod"   — 4x fewer bytes across pods under int8
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

PyTree = Any

_GROUPS: Dict[str, Any] = {}


def register_group(name: str, group: Any) -> None:
    """Bind ``name`` (a model config's ``tp_axis``) to a process group."""
    if name in _GROUPS:
        raise ValueError(f"process group {name!r} is already bound")
    _GROUPS[name] = group


def unregister_group(name: str) -> None:
    _GROUPS.pop(name, None)


def group_of(name: str) -> Any:
    if name not in _GROUPS:
        raise RuntimeError(f"no process group bound to {name!r} in this "
                           f"process (serving/tp.make_model_group binds "
                           f"one)")
    return _GROUPS[name]


def axis_size(name: str) -> int:
    """Ranks of the group bound to ``name`` (1 for ``""``: no tensor
    parallelism)."""
    if not name:
        return 1
    return dist.get_world_size(group_of(name))


def tp_all_gather(x: torch.Tensor, axis_name: str, axis: int = -1
                  ) -> torch.Tensor:
    """Re-replicate a tensor-parallel shard along ``axis``: concatenation in
    rank order, no arithmetic, so column-parallel layers that gather keep
    the fp32 summation order of one device (the serving engine's
    bit-exactness contract). The list form of ``all_gather``, which the
    gloo backend also takes for CUDA tensors (ranks sharing a card)."""
    group = group_of(axis_name)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis % x.dim())


def maybe_gather(x: torch.Tensor, full_dim: int, axis_name: str,
                 axis: int = -1) -> torch.Tensor:
    """:func:`tp_all_gather` iff ``x`` is sharded along ``axis``
    (``shape[axis] != full_dim``): a weight that fell back to replicated
    (its output does not divide the group) composes with sharded ones."""
    if not axis_name or x.shape[axis % x.dim()] == full_dim:
        return x
    return tp_all_gather(x, axis_name, axis=axis)


def ring_allgather_kv(k: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """A ring all-gather over point-to-point sends: each of the ``n - 1``
    rounds passes the last chunk received to the next rank, so rank ``i``
    returns ``[k_i, k_{i-1}, ..., k_{i-n+1}]`` concatenated along axis 1
    (the reference's ``ppermute`` ring, for context-parallel decode)."""
    group = group_of(axis)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    chunks, cur = [k], k.contiguous()
    for _ in range(n - 1):
        nxt = torch.empty_like(cur)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, cur, ranks[(rank + 1) % n], group),
            dist.P2POp(dist.irecv, nxt, ranks[(rank - 1) % n], group)])
        for r in reqs:
            r.wait()
        chunks.append(nxt)
        cur = nxt
    return torch.cat(chunks, dim=1)


def hierarchical_psum(grads: PyTree, mesh, *, codec: Optional[str] = None
                      ) -> PyTree:
    """All-reduce every gradient leaf over the ``"data"`` axis of ``mesh``
    (``launch/mesh.HostMesh``) and then, when the mesh has a ``"pod"``
    axis, over it: in full precision, or with ``codec="int8"`` as int8
    codes under one scale a rank (summed as int32; the scales averaged),
    as the reference does. Each rank holds its own gradients; every rank
    returns the reduced ones."""
    if codec not in (None, "int8"):
        raise ValueError(f"unknown codec {codec!r}")
    has_pod = "pod" in mesh.axis_names

    def reduce_one(g):
        x = g.clone()
        dist.all_reduce(x, group=mesh.group("data"))
        if not has_pod:
            return x
        pod = mesh.group("pod")
        if codec == "int8":
            scale = x.float().abs().max() / 127.0 + 1e-12
            q = torch.clamp(torch.round(x.float() / scale), -127, 127)
            q32 = q.to(torch.int8).to(torch.int32)
            dist.all_reduce(q32, group=pod)
            s = scale.reshape(1).clone()
            dist.all_reduce(s, group=pod)
            return (q32.float() * (s / dist.get_world_size(pod))).to(g.dtype)
        dist.all_reduce(x, group=pod)
        return x

    return tree_map(reduce_one, grads)
