"""Symmetric int8 quantization of the two decode bandwidth terms — a copy of
the reference package's ``kernels/quant.py`` in PyTorch.

* **KV rows** — one fp32 scale per cache row per kv head (absmax over
  ``head_dim``), kept in sibling ``(n_pages, page_size, Hkv)`` pools that
  share the K/V page index space.
* **BCR block values** — one fp32 scale per kept ``(R_keep, C_keep)`` tile
  (absmax over the tile), stored on the plan beside the index vectors and
  applied to each block's fp32 partial product before the scatter.

Rounding is to nearest with ties to even (``torch.round``, as ``jnp.round``)
onto ``[-127, 127]``; on fp32 inputs the codes and scales equal the
reference's bit for bit.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0
# floor for the scale so all-zero rows/tiles quantize to zeros instead of
# dividing by zero (codes are 0 either way)
EPS = 1e-12


def _quantize(x: torch.Tensor, dims):
    xf = x.float()
    amax = xf.abs().amax(dim=dims)
    scale = torch.clamp(amax / INT8_MAX, min=EPS)
    expand = scale.reshape(*scale.shape, *([1] * len(dims)))
    codes = torch.clamp(torch.round(xf / expand), -INT8_MAX, INT8_MAX)
    return codes.to(torch.int8), scale


def quantize_rows(x: torch.Tensor):
    """Quantize over the LAST axis: ``(codes int8, scale fp32)`` with
    ``scale.shape == x.shape[:-1]`` and ``x ≈ codes * scale[..., None]``."""
    return _quantize(x, (-1,))


def dequantize_rows(codes: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (codes.float() * scale.float()[..., None]).to(dtype)


def quantize_blocks(vals: torch.Tensor):
    """Per-tile quantization of packed BCR values ``(..., nb_r, nb_c,
    R_keep, C_keep)``: ``(codes int8, scales fp32)`` with ``scales.shape ==
    vals.shape[:-2]``."""
    return _quantize(vals, (-2, -1))


def dequantize_blocks(codes: torch.Tensor, scales: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    return (codes.float() * scales.float()[..., None, None]).to(dtype)
