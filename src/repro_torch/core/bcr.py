"""Block-based Column-Row (BCR) pruning — the paper's fine-grained structured
sparsity scheme (GRIM §3).

A weight matrix ``W`` of shape ``(rows, cols)`` (rows = output, cols =
input) is cut into an ``nb_r × nb_c`` grid of equal blocks. Within each
block whole columns and whole rows are pruned. Two projection modes:

* ``balanced=True``: every block keeps the same number of whole columns and
  whole rows, so the survivors of every block form a dense ``(R_keep,
  C_keep)`` tile (what TBCRC packs).
* ``balanced=False`` (paper-general): (block, column) stripes and then
  (block, row) stripes compete globally by mean energy, so per-block kept
  counts vary and whole blocks can vanish (what ``pack_skip`` packs).

Balanced survivors are picked by energy with ``torch.topk`` and then sorted.
Where two energies tie, ``torch.topk`` and ``jax.lax.top_k`` may keep
different members; on seeded normal weights ties do not occur, and the
converter (``repro_torch.convert``) carries packed indices across unchanged.
The unbalanced form keeps the reference's threshold rule exactly
(``sort(flat)[-k]`` with ``>=``, so ties keep more than ``k``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
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
    multiple (balanced form only).
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


def mask_from_indices(row_idx: torch.Tensor, col_idx: torch.Tensor,
                      shape: Tuple[int, int],
                      block_shape: Tuple[int, int]) -> torch.Tensor:
    """Rebuild the dense {0,1} fp32 mask from per-block surviving indices."""
    nb_r, nb_c = block_grid(tuple(shape), block_shape)
    br, bc = block_shape
    dev = row_idx.device
    row_mask = torch.zeros((nb_r, nb_c, br), device=dev).scatter_(
        -1, row_idx.long(), 1.0)
    col_mask = torch.zeros((nb_r, nb_c, bc), device=dev).scatter_(
        -1, col_idx.long(), 1.0)
    return _from_blocks(row_mask[:, :, :, None] * col_mask[:, :, None, :])


def bcr_mask(w: torch.Tensor, spec: BCRSpec) -> torch.Tensor:
    """Dense {0,1} fp32 mask of the BCR-projection support of ``w``."""
    if spec.balanced:
        row_idx, col_idx = bcr_indices(w, spec)
        return mask_from_indices(row_idx, col_idx, tuple(w.shape),
                                 spec.block_shape)
    return _unbalanced_mask(w, spec)


def bcr_project(w: torch.Tensor, spec: BCRSpec) -> torch.Tensor:
    """Euclidean projection of ``w`` onto the BCR-sparse set (greedy support
    selection by energy; exact once the support is fixed)."""
    return w * bcr_mask(w, spec).to(w.dtype)


def _kth_largest(flat: torch.Tensor, k: int) -> torch.Tensor:
    """``sort(flat)[-k]``: the threshold a ``>=`` test keeps at least ``k``
    entries with (all of a tie at the threshold survive)."""
    return torch.sort(flat).values[-k]


def _unbalanced_mask(w: torch.Tensor, spec: BCRSpec) -> torch.Tensor:
    """Paper-general BCR: global ranking of block-columns and block-rows.

    Every (block, column) stripe competes globally by MEAN energy (the
    balanced form's ``bcr_indices`` ranks within a block by sum); the top
    ``col_frac`` stripes survive, likewise rows among the surviving columns.
    Per-block kept counts vary."""
    blocks = _to_blocks(w.float(), spec.block_shape)
    nb_r, nb_c, br, bc = blocks.shape
    cf, rf = spec.fracs()
    sq = blocks * blocks

    col_energy = sq.mean(dim=2)                              # (nb_r, nb_c, bc)
    k_cols = max(1, int(round(cf * nb_r * nb_c * bc)))
    thresh = _kth_largest(col_energy.reshape(-1), k_cols)
    col_mask = (col_energy >= thresh).float()

    row_energy = (sq * col_mask[:, :, None, :]).mean(dim=3)  # (nb_r, nb_c, br)
    k_rows = max(1, int(round(rf * nb_r * nb_c * br)))
    thresh_r = _kth_largest(row_energy.reshape(-1), k_rows)
    row_mask = (row_energy >= thresh_r).float()

    return _from_blocks(row_mask[:, :, :, None] * col_mask[:, :, None, :])


def bcr_mask_any(w: torch.Tensor, spec: BCRSpec) -> torch.Tensor:
    """``bcr_mask`` over leading stacking dims: each trailing 2-D matrix is
    masked on its own."""
    if w.dim() == 2:
        return bcr_mask(w, spec)
    return torch.stack([bcr_mask_any(x, spec) for x in w])


def bcr_project_any(w: torch.Tensor, spec: BCRSpec) -> torch.Tensor:
    if w.dim() == 2:
        return bcr_project(w, spec)
    return torch.stack([bcr_project_any(x, spec) for x in w])


def density(mask: torch.Tensor) -> torch.Tensor:
    return mask.float().mean()


def pruning_rate(mask: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp(density(mask), min=1e-12)


def is_bcr_set_member(w, spec: BCRSpec, *, strict_counts: bool = True
                      ) -> bool:
    """Membership of ``w`` in the balanced BCR-sparse set S: no block has
    more than ``R_keep`` nonzero rows or ``C_keep`` nonzero columns, and its
    support lies in the cross product of its nonzero rows and columns (which
    every support does: the reference checks it all the same). Takes a
    tensor on any device, or a numpy array; all blocks are checked at once
    instead of the reference's loop over blocks."""
    if not isinstance(w, torch.Tensor):
        w = torch.from_numpy(np.array(w))
    nb_r, nb_c = block_grid(tuple(w.shape), spec.block_shape)
    r_keep, c_keep = spec.kept_counts()
    nz = _to_blocks(w, spec.block_shape) != 0            # (nb_r, nb_c, br, bc)
    nz_rows = nz.any(dim=3)                               # (nb_r, nb_c, br)
    nz_cols = nz.any(dim=2)                               # (nb_r, nb_c, bc)
    if strict_counts and (int(nz_rows.sum(-1).max()) > r_keep
                          or int(nz_cols.sum(-1).max()) > c_keep):
        return False
    cross = nz_rows[:, :, :, None] & nz_cols[:, :, None, :]
    return not bool((nz & ~cross).any())
