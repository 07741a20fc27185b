"""AdamW with a warmup-cosine schedule and global-norm clipping, written as
plain functions on tensors (the reference's ``optim/adamw.py``).

``torch.optim.AdamW`` is not used: its schedule, clipping and decay mask are
not the reference's. The arithmetic follows the reference step for step in
fp32 (moments are fp32 whatever the param dtype). Scalars that the
reference computes in fp32 on the device (the learning rate, bias
corrections, the clip scale) are fp32 here too.

The port updates in place where the reference returns new trees: ``update``
overwrites the params, the moments and (when clipping) the grads it is
given, so a full-width model needs no second copy of any of them.

Decay mask: the reference decays every leaf with ``ndim >= 2`` *in its
stacked layout*. Where it stacks a model's layers (a decoder under
``scan_layers=True``, an encdec model's two stacks always) they carry a
leading layer axis, so a layer's RMSNorm ``scale`` (L, d) is decayed while
``final_norm`` (d,) is not. A MoE model's ``moe_first_dense`` leading
layers stay unstacked there (its ``prefix``), so theirs are not. The port
stores layers unstacked; :func:`decay_mask`, given the subtrees the
reference stacks (``model_fns(cfg).stacked``), gives the mask it would use
for the same config.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.tree import flatten, leaves, tree_map, unflatten

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_frac``, as an fp32 0-d CPU
    tensor (the reference's fp32 arithmetic, off the card)."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(_f32(math.pi) * t))
    return cfg.lr * warm * cos


@dataclasses.dataclass
class AdamWState:
    m: PyTree                 # fp32 first moments, nested like the params
    v: PyTree                 # fp32 second moments
    step: torch.Tensor        # int32 0-d, on the CPU


def init(params: PyTree) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32))


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares (on the leaves'
    device)."""
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    """Scale ``grads`` in place by ``min(1, max_norm / max(norm, 1e-9))``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


def decay_mask(params: PyTree, *, stacked: Tuple[str, ...] = ()) -> PyTree:
    """The reference's default mask (``ndim >= 2``) as its layout would see
    it: every leaf under one of the subtrees ``stacked`` (paths as
    :func:`repro_torch.tree.flatten` writes them, e.g. ``['layers'][1]``)
    has one more (stacking) dim there, so norm scales and biases there are
    decayed."""
    prefixes = tuple(f"{k}[" for k in stacked)
    return unflatten(params, [
        float(p.dim() + int(path.startswith(prefixes)) >= 2)
        for path, p in flatten(params)])


@torch.no_grad()
def update(cfg: AdamWConfig, grads: PyTree, state: AdamWState,
           params: PyTree, *, decay_mask: Optional[PyTree] = None
           ) -> Tuple[PyTree, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params``, the moments and ``grads``.
    Returns ``(params, state, metrics)`` like the reference (the same
    tensors, updated). ``decay_mask`` (1.0 where weight decay applies)
    defaults to ``ndim >= 2`` on the given layout."""
    step = state.step + 1
    lr = float(schedule(cfg, step))
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    stepf = _f32(step)
    b1c = float(1 - _f32(cfg.b1) ** stepf)
    b2c = float(1 - _f32(cfg.b2) ** stepf)

    flat_p = leaves(params)
    flat_d = (leaves(decay_mask) if decay_mask is not None
              else [float(p.dim() >= 2) for p in flat_p])
    for p, g, m, v, d in zip(flat_p, leaves(grads), leaves(state.m),
                             leaves(state.v), flat_d):
        g32 = g.float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * float(d) * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    metrics = {"lr": torch.tensor(lr), "grad_norm": gnorm, "step": step}
    return params, AdamWState(state.m, state.v, step), metrics
