"""GRU — the paper's own RNN workload (the ESE / C-LSTM comparison, Table 3).

Matrix-multiplication-only formulation: all six weight matrices of a cell go
through ``linear_apply``, so BCR pruning and TBCRC packing apply exactly as
the paper prescribes for RNN FC layers, and a packed cell runs the BCR
kernel on the card. Two stacked GRU layers at d_model 1024 are the paper's
9.6M-parameter TIMIT model.

Params are plain dicts, as in ``models/causal_lm.py``, so ``admm`` and
``launch.serve.pack_params`` walk them like any other tree. A Python loop
over time takes the place of the reference's ``jax.lax.scan``. Dispatch is
by device, as everywhere in the port: the kernels on the card, their plain
versions on the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.core.sparse_linear import linear_apply, linear_init

Params = Dict[str, Any]


def gru_cell_init(generator: torch.Generator, d_in: int, d_hidden: int,
                  dtype=torch.float32) -> Params:
    return {name: linear_init(generator, d_in if name[0] == "w" else d_hidden,
                              d_hidden, dtype=dtype)
            for name in ("wz", "uz", "wr", "ur", "wh", "uh")}


def gru_cell_step(params: Params, h: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    z = torch.sigmoid(linear_apply(params["wz"], x)
                      + linear_apply(params["uz"], h))
    r = torch.sigmoid(linear_apply(params["wr"], x)
                      + linear_apply(params["ur"], h))
    hh = torch.tanh(linear_apply(params["wh"], x)
                    + linear_apply(params["uh"], r * h))
    return (1 - z) * h + z * hh


def gru_init(generator: torch.Generator, vocab: int, d_model: int,
             n_layers: int, n_classes: int, dtype=torch.float32) -> Params:
    """Embedding ``(vocab, d_model)`` × 0.02, ``n_layers`` cells, and a
    ``(n_classes, d_model)`` head, drawn in that order from ``generator``
    (on its device)."""
    embed = torch.randn((vocab, d_model), generator=generator,
                        device=generator.device) * 0.02
    return {
        "embed": embed.to(dtype),
        "cells": [gru_cell_init(generator, d_model, d_model, dtype)
                  for _ in range(n_layers)],
        "head": linear_init(generator, d_model, n_classes, dtype=dtype),
    }


def gru_apply(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) → logits (B, n_classes); final hidden state readout."""
    x = params["embed"][tokens.long()]               # (B, S, d)
    b, s, d = x.shape
    for cell in params["cells"]:
        h = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        hs = []
        for t in range(s):
            h = gru_cell_step(cell, h, x[:, t])
            hs.append(h)
        x = torch.stack(hs, dim=1)
    return linear_apply(params["head"], x[:, -1])


def gru_step_latency_fn(params: Params) -> Callable:
    """One timestep ``step(h, x)`` over every cell, on ``(batch, d)``
    inputs — the paper's 81 µs/step serving unit. As in the reference, each
    cell takes the previous cell's new state as both its input and its
    state."""
    def step(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for cell in params["cells"]:
            h = gru_cell_step(cell, h, x)
            x = h
        return h
    return step
