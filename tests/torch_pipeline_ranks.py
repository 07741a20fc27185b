"""What every rank of a model group runs for the port's pipeline tests
(``tests/test_torch_pipeline.py``, through ``ModelGroup.call``): a module
of its own, importing torch and the port only, so a rank's process imports
neither the reference nor JAX to run it."""

import numpy as np
import torch
import torch.distributed as dist


def tanh_stage(ws, xb):
    """One stage: its layers ``x = tanh(x @ w)`` in order."""
    for w in ws:
        xb = torch.tanh(xb @ w)
    return xb


def pipeline(n_stages: int, ws: np.ndarray, x: np.ndarray) -> dict:
    """``pipeline_apply`` of the tanh stages over this group's ranks, each
    rank holding its own stage's ``L / n_stages`` layers."""
    from repro_torch.runtime.pipeline_parallel import (pipeline_apply,
                                                       split_stages)
    rank = dist.get_rank()
    layers = [torch.as_tensor(w) for w in ws]
    mine = split_stages(layers, n_stages)[rank]
    stats = {}
    out = pipeline_apply(tanh_stage, mine, torch.as_tensor(x), stats=stats)
    return dict(rank=rank, out=out.numpy(), layers=len(mine), **stats)
