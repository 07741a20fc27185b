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

    ``vals``:    (nb_r, nb_c, R_keep, C_keep)  surviving weights
    ``row_idx``: (nb_r, nb_c, R_keep) int32    block-local surviving rows
    ``col_idx``: (nb_r, nb_c, C_keep) int32    block-local surviving cols
    ``shape``/``block_shape`` reconstruct the dense layout.
    ``plan``:    :class:`repro_torch.kernels.plan.BCRPlan` — flat gather /
                 scatter index vectors for the plain path.
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
    """Project ``w`` onto the balanced BCR set and pack the survivors."""
    from repro_torch.kernels.plan import default_plan  # lazy: core <-> kernels
    row_idx, col_idx = bcr_mod.bcr_indices(w, spec)
    blocks = bcr_mod._to_blocks(w, spec.block_shape)  # (nb_r, nb_c, br, bc)
    bc = spec.block_shape[1]
    rows = torch.gather(
        blocks, 2,
        row_idx.long()[:, :, :, None].expand(-1, -1, -1, bc))
    vals = torch.gather(
        rows, 3,
        col_idx.long()[:, :, None, :].expand(-1, -1, row_idx.shape[-1], -1))
    return TBCRC(
        vals=vals.contiguous(),
        row_idx=row_idx.contiguous(),
        col_idx=col_idx.contiguous(),
        shape=tuple(w.shape),
        block_shape=tuple(spec.block_shape),
        plan=default_plan(row_idx, col_idx, spec.block_shape),
    )


def tbcrc_unpack(packed: TBCRC) -> torch.Tensor:
    """Dense reconstruction (the BCR projection of the packed weight)."""
    vals = packed.vals
    nb_r, nb_c, r_keep, c_keep = vals.shape
    br, bc = packed.block_shape
    rows = torch.zeros((nb_r, nb_c, r_keep, bc), dtype=vals.dtype,
                       device=vals.device)
    rows.scatter_(3, packed.col_idx.long()[:, :, None, :]
                  .expand(-1, -1, r_keep, -1), vals)
    blocks = torch.zeros((nb_r, nb_c, br, bc), dtype=vals.dtype,
                         device=vals.device)
    blocks.scatter_(2, packed.row_idx.long()[:, :, :, None]
                    .expand(-1, -1, -1, bc), rows)
    return bcr_mod._from_blocks(blocks)
