"""Compact storage of BCR-pruned matrices (GRIM §4.3).

Three formats live here:

* **BCRC** — the paper's six-array hierarchical format (reorder, row offset,
  occurrence, column stride, compact column, weights), in numpy: an offline
  storage format, as the paper packs it at compile time. Rows that share an
  identical surviving-column set store that set once.
* **TBCRC** — the packed balanced-BCR layout the sparse-matmul kernels
  consume: per block a dense ``(R_keep, C_keep)`` value tile plus int32
  row/col index planes, shapes ``(nb_r, nb_c, R_keep, C_keep)`` /
  ``(nb_r, nb_c, R_keep)`` / ``(nb_r, nb_c, C_keep)``.
* **CSR** — the paper's baseline for the storage comparison
  (:func:`csr_extra_bytes`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import bcr as bcr_mod
from repro_torch.core.bcr import BCRSpec


@dataclasses.dataclass
class BCRC:
    """The paper's six arrays + shape metadata."""

    shape: Tuple[int, int]
    reorder: np.ndarray          # (n_rows,) original row id of each packed row
    row_offset: np.ndarray       # (n_rows+1,) offsets into `weights`
    occurrence: np.ndarray       # (n_groups+1,) packed-row ranges sharing cols
    column_stride: np.ndarray    # (n_groups+1,) offsets into `compact_column`
    compact_column: np.ndarray   # concatenated deduped column-index sets
    weights: np.ndarray          # all surviving weights, row-major packed

    def nbytes_extra(self, index_bytes: int = 4) -> int:
        """Index/metadata bytes (everything except the weight payload)."""
        n = (self.reorder.size + self.row_offset.size + self.occurrence.size
             + self.column_stride.size + self.compact_column.size)
        return n * index_bytes

    def nbytes_weights(self, weight_bytes: int = 2) -> int:
        return self.weights.size * weight_bytes


def bcrc_pack(w: np.ndarray) -> BCRC:
    """Pack a (BCR-)sparse matrix into BCRC.

    Matrix reorder (§4.2) is folded in: rows are sorted by (surviving
    count, column-set bytes), so rows with an identical surviving-column set
    become adjacent and the ``occurrence`` array stores each set once. The
    column sets are int32, so the order (and the six arrays) equal the
    reference's."""
    w = np.asarray(w)
    n_rows = w.shape[0]
    col_sets = [np.flatnonzero(w[r]).astype(np.int32) for r in range(n_rows)]
    keys = [(len(c), c.tobytes()) for c in col_sets]
    order = sorted(range(n_rows), key=lambda r: keys[r])

    weights_parts, row_offset = [], [0]
    occurrence, column_stride, compact_cols = [0], [0], []
    prev_key = None
    for packed_pos, orig_row in enumerate(order):
        cols = col_sets[orig_row]
        weights_parts.append(w[orig_row, cols])
        row_offset.append(row_offset[-1] + len(cols))
        key = keys[orig_row]
        if key != prev_key:
            if packed_pos != 0:
                occurrence.append(packed_pos)
            compact_cols.append(cols)
            column_stride.append(column_stride[-1] + len(cols))
            prev_key = key
    occurrence.append(n_rows)

    return BCRC(
        shape=tuple(w.shape),
        reorder=np.asarray(order, dtype=np.int32),
        row_offset=np.asarray(row_offset, dtype=np.int32),
        occurrence=np.asarray(occurrence, dtype=np.int32),
        column_stride=np.asarray(column_stride, dtype=np.int32),
        compact_column=(np.concatenate(compact_cols).astype(np.int32)
                        if compact_cols else np.zeros((0,), np.int32)),
        weights=(np.concatenate(weights_parts)
                 if weights_parts else np.zeros((0,), w.dtype)),
    )


def bcrc_unpack(packed: BCRC) -> np.ndarray:
    """Inverse of :func:`bcrc_pack` (dense reconstruction)."""
    out = np.zeros(packed.shape, dtype=packed.weights.dtype)
    for g in range(len(packed.occurrence) - 1):
        cols = packed.compact_column[
            packed.column_stride[g]: packed.column_stride[g + 1]]
        for packed_pos in range(packed.occurrence[g],
                                packed.occurrence[g + 1]):
            lo = packed.row_offset[packed_pos]
            hi = packed.row_offset[packed_pos + 1]
            out[packed.reorder[packed_pos], cols] = packed.weights[lo:hi]
    return out


def csr_extra_bytes(w: np.ndarray, index_bytes: int = 4) -> int:
    """CSR index overhead for the same matrix (the paper's baseline)."""
    nnz = int(np.count_nonzero(w))
    return (nnz + w.shape[0] + 1) * index_bytes


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


def tbcrc_stats(packed: TBCRC, weight_bytes: int = 2) -> Dict[str, float]:
    """Dense vs packed bytes of one TBCRC matrix at ``weight_bytes`` a value
    (tiles + int32 index planes; the plan's vectors are not counted, as in
    the reference), the compression and the kept density."""
    rows, cols = packed.shape
    dense = rows * cols * weight_bytes
    packed_bytes = (packed.vals.numel() * weight_bytes
                    + (packed.row_idx.numel() + packed.col_idx.numel()) * 4)
    return {
        "dense_bytes": float(dense),
        "packed_bytes": float(packed_bytes),
        "compression": float(dense) / float(packed_bytes),
        "density": packed.vals.numel() / (rows * cols),
    }
