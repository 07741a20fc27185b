"""TBCRC — the packed balanced-BCR layout the sparse-matmul kernels consume.

Per block a dense ``(R_keep, C_keep)`` value tile plus int32 row/col index
planes, shapes ``(nb_r, nb_c, R_keep, C_keep)`` / ``(nb_r, nb_c, R_keep)`` /
``(nb_r, nb_c, C_keep)``. The paper's six-array BCRC format and the CSR
baseline come in a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core import bcr as bcr_mod
from repro_torch.core.bcr import BCRSpec


@dataclasses.dataclass
class TBCRC:
    """Packed balanced-BCR weight: dense per-block tiles + index planes.

    ``vals``:    (nb_r, nb_c, R_keep, C_keep)  surviving weights (an MoE
                 layer's experts add a leading E axis to vals, the index
                 planes and the plan vectors)
    ``row_idx``: (nb_r, nb_c, R_keep) int32    block-local surviving rows
    ``col_idx``: (nb_r, nb_c, C_keep) int32    block-local surviving cols
    ``shape``/``block_shape`` reconstruct the dense layout.
    ``plan``:    :class:`repro_torch.kernels.plan.BCRPlan` — flat gather /
                 scatter index vectors for the plain path, and the per-tile
                 scales when ``vals`` holds int8 codes.
    """

    vals: torch.Tensor
    row_idx: torch.Tensor
    col_idx: torch.Tensor
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]
    plan: Any = None

    @property
    def kept_counts(self) -> Tuple[int, int]:
        return self.vals.shape[-2], self.vals.shape[-1]

    def nbytes(self) -> int:
        tot = (self.vals.numel() * self.vals.element_size()
               + self.row_idx.numel() * 4 + self.col_idx.numel() * 4)
        if self.plan is not None:
            tot += self.plan.nbytes()
        return tot


def tbcrc_pack(w: torch.Tensor, spec: BCRSpec) -> TBCRC:
    """Project ``w`` onto the balanced BCR set and pack the survivors. A
    stacked ``w`` ``(E, N, K)`` (an MoE layer's experts) packs in one
    batched pass to a TBCRC whose vals, index planes and plan vectors carry
    the leading E axis; ``shape`` stays the member's ``(N, K)``."""
    from repro_torch.kernels.plan import default_plan  # lazy: core <-> kernels
    row_idx, col_idx = bcr_mod.bcr_indices(w, spec)
    blocks = bcr_mod._to_blocks(w, spec.block_shape)  # (..., br, bc) tiles
    bc = spec.block_shape[1]
    rows = torch.gather(
        blocks, -2, row_idx.long()[..., None].expand(*row_idx.shape, bc))
    vals = torch.gather(
        rows, -1, col_idx.long()[..., None, :].expand(
            *row_idx.shape, col_idx.shape[-1]))
    return TBCRC(
        vals=vals.contiguous(),
        row_idx=row_idx.contiguous(),
        col_idx=col_idx.contiguous(),
        shape=tuple(w.shape[-2:]),
        block_shape=tuple(spec.block_shape),
        plan=default_plan(row_idx, col_idx, spec.block_shape),
    )


def tbcrc_unpack(packed: TBCRC) -> torch.Tensor:
    """Dense reconstruction (the BCR projection of the packed weight), with
    a stacked pack's leading axes.

    An int8-quantized pack (``plan.block_scales`` set) reconstructs the
    DEQUANTIZED fp32 weight, so the dense oracle sees what the kernels
    compute with."""
    vals = packed.vals
    scales = getattr(packed.plan, "block_scales", None)
    if scales is not None:
        vals = vals.float() * scales.float()[..., None, None]
    *grid, r_keep, c_keep = vals.shape
    br, bc = packed.block_shape
    rows = torch.zeros((*grid, r_keep, bc), dtype=vals.dtype,
                       device=vals.device)
    rows.scatter_(-1, packed.col_idx.long()[..., None, :]
                  .expand(*grid, r_keep, c_keep), vals)
    blocks = torch.zeros((*grid, br, bc), dtype=vals.dtype,
                         device=vals.device)
    blocks.scatter_(-2, packed.row_idx.long()[..., None]
                    .expand(*grid, r_keep, bc), rows)
    return bcr_mod._from_blocks(blocks)
