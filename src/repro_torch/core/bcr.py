"""Block-based Column-Row (BCR) pruning — the paper's fine-grained structured
sparsity scheme (GRIM §3), balanced form.

A weight matrix ``W`` of shape ``(rows, cols)`` (rows = output, cols =
input) is cut into an ``nb_r × nb_c`` grid of equal blocks. Each block keeps
the same number of whole columns and whole rows, so the survivors of every
block form a dense ``(R_keep, C_keep)`` tile.

Survivors are picked by energy with ``torch.topk`` and then sorted. Where two
energies tie, ``torch.topk`` and ``jax.lax.top_k`` may keep different
members; on seeded normal weights ties do not occur, and the converter
(``repro_torch.convert``) carries packed indices across unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


def _round_to(x: float, align: int, lo: int = 1) -> int:
    """Round ``x`` to the nearest positive multiple of ``align``."""
    if align <= 1:
        return max(lo, int(x))
    return max(lo * align, int(round(x / align)) * align)


@dataclasses.dataclass(frozen=True)
class BCRSpec:
    """Hyperparameters of BCR pruning for one weight matrix.

    ``block_shape`` is ``(block_rows, block_cols)``; ``keep_frac`` is the kept
    density. ``col_frac``/``row_frac`` override the per-axis split (default:
    symmetric ``sqrt(keep_frac)``). ``align`` rounds kept counts to a
    multiple. Only ``balanced=True`` is ported.
    """

    block_shape: Tuple[int, int] = (256, 256)
    keep_frac: float = 0.25
    col_frac: Optional[float] = None
    row_frac: Optional[float] = None
    align: int = 8
    balanced: bool = True

    def fracs(self) -> Tuple[float, float]:
        cf = self.col_frac
        rf = self.row_frac
        if cf is None and rf is None:
            cf = rf = math.sqrt(self.keep_frac)
        elif cf is None:
            cf = self.keep_frac / rf
        elif rf is None:
            rf = self.keep_frac / cf
        if not (0.0 < cf <= 1.0 and 0.0 < rf <= 1.0):
            raise ValueError(f"invalid keep fractions col={cf} row={rf}")
        return cf, rf

    def kept_counts(self) -> Tuple[int, int]:
        """(R_keep, C_keep) per block: the align-granular pair whose product
        best matches ``keep_frac × block_area``."""
        br, bc = self.block_shape
        cf, rf = self.fracs()
        ra = min(self.align, br)
        ca = min(self.align, bc)
        target = self.keep_frac * br * bc
        best = None
        r0 = rf * br
        for r in range(ra, br + 1, ra):
            c = min(bc, max(ca, _round_to(target / r, ca)))
            score = (abs(r * c - target), abs(r - r0))
            if best is None or score < best[0]:
                best = (score, (r, c))
        return best[1]


def kept_align(block_shape: Tuple[int, int]) -> int:
    """Kept-count granule for a block shape: 8 when the block affords it,
    finer for small blocks so small keep_fracs stay reachable."""
    return max(1, min(8, block_shape[0] // 4, block_shape[1] // 4))


def choose_block_shape(
    shape: Tuple[int, int], target: Tuple[int, int] = (256, 256)
) -> Tuple[int, int]:
    """Pick a block shape dividing ``shape`` that is closest to ``target``."""

    def best_divisor(n: int, t: int) -> int:
        divs = [d for d in range(1, n + 1) if n % d == 0]
        return min(divs, key=lambda d: (abs(math.log(d / t)), -d))

    return best_divisor(shape[0], target[0]), best_divisor(shape[1], target[1])


def block_grid(shape: Tuple[int, int],
               block_shape: Tuple[int, int]) -> Tuple[int, int]:
    rows, cols = shape
    br, bc = block_shape
    if rows % br or cols % bc:
        raise ValueError(f"matrix {shape} not divisible by block {block_shape}")
    return rows // br, cols // bc


def _to_blocks(w: torch.Tensor, block_shape: Tuple[int, int]) -> torch.Tensor:
    """(rows, cols) -> (nb_r, nb_c, br, bc)."""
    nb_r, nb_c = block_grid(tuple(w.shape), block_shape)
    br, bc = block_shape
    return w.reshape(nb_r, br, nb_c, bc).permute(0, 2, 1, 3)


def _from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """(nb_r, nb_c, br, bc) -> (rows, cols)."""
    nb_r, nb_c, br, bc = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(nb_r * br, nb_c * bc)


def bcr_indices(w: torch.Tensor, spec: BCRSpec
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Balanced-BCR surviving indices, ascending per block.

    Returns ``(row_idx, col_idx)`` with shapes ``(nb_r, nb_c, R_keep)`` and
    ``(nb_r, nb_c, C_keep)`` (int32). Columns are selected by L2 energy of the
    full block; rows by L2 energy restricted to surviving columns.
    """
    blocks = _to_blocks(w.float(), spec.block_shape)
    r_keep, c_keep = spec.kept_counts()
    sq = blocks * blocks
    col_energy = sq.sum(dim=2)                               # (nb_r, nb_c, bc)
    col_idx = torch.topk(col_energy, c_keep, dim=-1).indices
    col_idx = torch.sort(col_idx, dim=-1).values
    col_mask = torch.zeros_like(col_energy).scatter_(-1, col_idx, 1.0)
    row_energy = (sq * col_mask[:, :, None, :]).sum(dim=3)   # (nb_r, nb_c, br)
    row_idx = torch.topk(row_energy, r_keep, dim=-1).indices
    row_idx = torch.sort(row_idx, dim=-1).values
    return row_idx.to(torch.int32), col_idx.to(torch.int32)
