"""What every rank of a 4-rank model group runs for the port's collective
tests (``tests/test_torch_tp_engine.py``, through ``ModelGroup.call``): a
module of its own, importing torch and the port only, so a rank's process
imports neither the reference nor JAX to run it."""

import numpy as np
import torch
import torch.distributed as dist


def grads(rank: int) -> np.ndarray:
    return np.random.default_rng(rank).standard_normal((8, 16)).astype(
        np.float32)


def collectives() -> dict:
    """``hierarchical_psum`` over pod 2 x data 2 (full precision, and the
    int8 codec over the same gradients on every rank, as the reference
    tests it) and over a flat data mesh, and ``ring_allgather_kv`` over the
    model axis of a 2 x 2 host mesh."""
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.runtime.collectives import (hierarchical_psum,
                                                 register_group,
                                                 ring_allgather_kv,
                                                 unregister_group)
    rank = dist.get_rank()
    mesh = make_mesh((2, 2), ("pod", "data"))
    g = {"g": torch.as_tensor(grads(rank))}
    exact = hierarchical_psum(g, mesh)["g"].numpy()
    q = hierarchical_psum({"g": torch.as_tensor(grads(0))}, mesh,
                          codec="int8")["g"].numpy()
    flat = hierarchical_psum(g, make_host_mesh(1))["g"].numpy()
    host = make_host_mesh(2)
    register_group("ring", host.group("model"))
    try:
        k = torch.full((1, 2, 3), float(rank))
        ring = ring_allgather_kv(k, "ring")[0, :, 0].tolist()
    finally:
        unregister_group("ring")
    return dict(rank=rank, exact=exact, int8=q, flat=flat, ring=ring,
                coords=list(host.coords(rank)), shape=list(host.shape))
