"""Gradient compression with error feedback (the reference's
``optim/grad_compress.py``): the cross-pod link is an order of magnitude
slower than the links inside a pod, so the pod-level all-reduce is the
term worth compressing.

Two codecs, each over one tensor at a time:

* int8 linear quantization with one fp32 scale per tensor, error-feedback
  corrected;
* top-k magnitude sparsification per tensor, error-feedback corrected.

``runtime/collectives.hierarchical_psum`` applies the int8 codec on the pod
level only; inside a pod gradients reduce in full precision.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

PyTree = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(codes, scale)``: ``scale = max|x| / 127 + 1e-12`` (fp32) and
    ``codes = clip(round(x / scale), -127, 127)`` in int8 (round half to
    even, as ``jnp.round``)."""
    scale = x.float().abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_sparsify(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep the entries of magnitude at least the ``max(1, frac·n)``-th
    largest (ties kept), zero the rest (dense mask form)."""
    flat = x.reshape(-1)
    k = max(1, int(frac * flat.numel()))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(x.abs() >= thresh, x, torch.zeros_like(x))


@dataclasses.dataclass
class EFState:
    """Error-feedback residual per gradient leaf (fp32)."""

    residual: PyTree


def ef_init(grads_like: PyTree) -> EFState:
    return EFState(tree_map(lambda g: torch.zeros(g.shape,
                                                  dtype=torch.float32,
                                                  device=g.device),
                            grads_like))


def ef_compress(grads: PyTree, state: EFState, *, codec: str = "int8",
                topk_frac: float = 0.05) -> Tuple[PyTree, EFState]:
    """``g' = C(g + residual)``; ``residual' = (g + residual) - g'``, per
    leaf; ``g'`` in each gradient's dtype."""

    def one(g, r):
        corrected = g.float() + r
        if codec == "int8":
            out = dequantize_int8(*quantize_int8(corrected))
        elif codec == "topk":
            out = topk_sparsify(corrected, topk_frac)
        else:
            raise ValueError(codec)
        return out.to(g.dtype), corrected - out

    outs = [one(g, r) for g, r in zip(leaves(grads), leaves(state.residual))]
    return (unflatten(grads, [o[0] for o in outs]),
            EFState(unflatten(state.residual, [o[1] for o in outs])))


def compressed_bytes(grads: PyTree, codec: str = "int8",
                     topk_frac: float = 0.05) -> int:
    """Wire bytes after compression: one byte an element for int8 (the
    scales are negligible), value + index for top-k."""
    n = sum(g.numel() for g in leaves(grads))
    if codec == "int8":
        return n
    if codec == "topk":
        return int(n * topk_frac) * 8
    raise ValueError(codec)
