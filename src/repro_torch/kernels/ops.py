"""The BCR matmul API the model layers call.

``bcr_matmul`` / ``bcr_matmul_grouped`` flatten the leading batch dims and
hand the 2-D activation to the kernel wrappers, which dispatch on the
tensor's device alone: the CUDA kernel on the card, the plain version on the
CPU. The reference pads M to the TPU sublane granule; the CUDA kernels mask
the M edge instead, so no padding happens here. int8-quantized packs carry
their per-tile scales on ``plan.block_scales`` and reach the kernels' int8
form through the same calls.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.bcrc import TBCRC
from repro_torch.kernels.bcr_spmm import bcr_spmm, bcr_spmm_grouped


def bcr_matmul(x: torch.Tensor, packed: TBCRC) -> torch.Tensor:
    """y[..., N] = x[..., K] @ W.T for TBCRC-packed W (N, K)."""
    *batch, k = x.shape
    y2 = bcr_spmm(x.reshape(-1, k).contiguous(), packed)
    return y2.reshape(*batch, packed.shape[0])


def bcr_matmul_grouped(x: torch.Tensor, grouped, *,
                       bias: Optional[torch.Tensor] = None,
                       epilogue: Optional[str] = None) -> torch.Tensor:
    """y[..., G, N] = x[..., K] @ W_g.T for G grouped packed weights, in one
    launch; ``epilogue="swiglu"`` returns the activated ``(..., N)``."""
    *batch, k = x.shape
    n, g = grouped.shape[0], grouped.group_size
    yg = bcr_spmm_grouped(x.reshape(-1, k).contiguous(), grouped, bias=bias,
                          epilogue=epilogue)
    if epilogue == "swiglu":
        return yg.reshape(*batch, n)
    return yg.transpose(0, 1).reshape(*batch, g, n)
