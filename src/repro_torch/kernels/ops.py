"""The BCR matmul API the model layers call.

``bcr_matmul`` / ``bcr_matmul_grouped`` flatten the leading batch dims and
hand the 2-D activation to the kernel wrappers, which dispatch on the
tensor's device alone: the CUDA kernel on the card, the plain version on the
CPU. The reference pads M to the TPU sublane granule; the CUDA kernels mask
the M edge instead, so no padding happens here. int8-quantized packs carry
their per-tile scales on ``plan.block_scales`` and reach the kernels' int8
form through the same calls. A pack stacked on a leading expert axis (an MoE
layer's E experts) takes x ``(E, ..., K)``: the dims between E and K
flatten into each expert's M, and all E experts run in one launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.bcrc import TBCRC
from repro_torch.kernels.bcr_spmm import bcr_spmm, bcr_spmm_grouped
from repro_torch.kernels.plan import stacked_experts


def _rows(x: torch.Tensor, packed) -> torch.Tensor:
    """x as the kernels take it: ``(M, K)``, or ``(E, M, K)`` over a pack
    of E stacked experts."""
    k = x.shape[-1]
    e = stacked_experts(packed)
    return (x.reshape(e, -1, k) if e else x.reshape(-1, k)).contiguous()


def bcr_matmul(x: torch.Tensor, packed: TBCRC) -> torch.Tensor:
    """y[..., N] = x[..., K] @ W.T for TBCRC-packed W (N, K)."""
    y2 = bcr_spmm(_rows(x, packed), packed)
    return y2.reshape(*x.shape[:-1], packed.shape[0])


def bcr_matmul_grouped(x: torch.Tensor, grouped, *,
                       bias: Optional[torch.Tensor] = None,
                       epilogue: Optional[str] = None) -> torch.Tensor:
    """y[..., G, N] = x[..., K] @ W_g.T for G grouped packed weights, in one
    launch; ``epilogue="swiglu"`` returns the activated ``(..., N)``."""
    batch = x.shape[:-1]
    n, g = grouped.shape[0], grouped.group_size
    yg = bcr_spmm_grouped(_rows(x, grouped), grouped, bias=bias,
                          epilogue=epilogue)
    if epilogue == "swiglu":
        return yg.reshape(*batch, n)
    return yg.transpose(-3, -2).reshape(*batch, g, n)
