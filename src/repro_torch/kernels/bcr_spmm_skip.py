"""Block-skipping BCR matmul for UNBALANCED (paper-general) BCR pruning: the
hand-written CUDA kernel of ``csrc/bcr_spmm_skip.cu`` and its wrapper.

Replaces the reference's TPU kernel ``kernels/bcr_spmm_skip.py:
bcr_spmm_skip``. Unbalanced BCR lets every block keep its own rows and
columns, and whole blocks vanish; ``pack_skip`` keeps only the surviving
dense ``(br, bc)`` tiles, and the kernel visits only those.

Packing contract (:func:`pack_skip`): the surviving ``(bi, bj)`` tiles of
the projected W in row-major order (sorted by output block row ``bi``), in
W's dtype; a fully pruned W keeps one zero tile at ``(0, 0)``. ``last``
marks the last tile of each ``bi`` and ``row_mask`` the output rows whose
block row owns a tile, as in the reference. The port adds one plan vector,
``row_start`` (``nb_r + 1`` int32 offsets of each block row's tile range),
from which a CUDA block finds its tiles without a search. A hand-rolled
pack (``row_mask``/``row_start`` left None) gets ``row_start`` rebuilt from
``bi``.

A CUDA tensor goes through the kernel (or the wrapper raises); a CPU tensor
goes through the plain version :func:`repro_torch.kernels.ref.
bcr_spmm_skip_ref`. Each launch adds one to ``LAUNCHES["bcr_spmm_skip"]``.
The kernel writes every output element itself — exact zeros for rows whose
block row has no tile — so no mask pass follows it.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.bcr import BCRSpec, _to_blocks, bcr_mask
from repro_torch.kernels import build, ref

LAUNCHES = {"bcr_spmm_skip": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


@dataclasses.dataclass
class SkipPacked:
    """Compacted surviving tiles of an unbalanced-BCR matrix W (N, K)."""

    tiles: torch.Tensor      # (num_nz, br, bc) dense surviving blocks
    bi: torch.Tensor         # (num_nz,) int32 output block row, ascending
    bj: torch.Tensor         # (num_nz,) int32 contraction block col
    last: torch.Tensor       # (num_nz,) int32 1 iff last tile of its bi
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]
    # (N,) bool — True where the output row's block row owns a tile
    row_mask: Optional[torch.Tensor] = None
    # (nb_r + 1,) int32 — tiles of block row i are [row_start[i],
    # row_start[i + 1]); the port's addition to the plan
    row_start: Optional[torch.Tensor] = None

    def nbytes(self) -> int:
        """The reference's formula: tiles, 12 bytes of indices per tile
        (bi, bj, last) and one byte per output row of ``row_mask``."""
        return (self.tiles.numel() * self.tiles.element_size()
                + 12 * self.bi.numel()
                + (self.row_mask.numel() if self.row_mask is not None
                   else 0))


def row_start_from_bi(bi: torch.Tensor, nb_r: int) -> torch.Tensor:
    """(nb_r + 1,) int32 offsets of each block row's tile range in a
    ``bi``-sorted tile list."""
    counts = torch.bincount(bi.long(), minlength=nb_r)
    out = torch.zeros(nb_r + 1, dtype=torch.int64, device=bi.device)
    out[1:] = torch.cumsum(counts, 0)
    return out.to(torch.int32)


def pack_skip(w: torch.Tensor, spec: BCRSpec) -> SkipPacked:
    """Project W onto the (unbalanced) BCR set and pack surviving blocks.

    The reference walks the blocks in a Python double loop; here one
    ``nonzero`` over the block grid yields the same row-major (i, j) order.
    """
    wp = w * bcr_mask(w, spec).to(w.dtype)
    br, bc = spec.block_shape
    n, k = wp.shape
    nb_r = n // br
    blocks = _to_blocks(wp, spec.block_shape)          # (nb_r, nb_c, br, bc)
    alive = (blocks != 0).flatten(2).any(dim=2)         # (nb_r, nb_c)
    ij = torch.nonzero(alive)                           # row-major order
    if ij.shape[0] == 0:   # fully pruned matrix: one zero tile at (0, 0)
        ij = torch.zeros((1, 2), dtype=torch.int64, device=w.device)
        tiles = torch.zeros((1, br, bc), dtype=wp.dtype, device=w.device)
    else:
        tiles = blocks[ij[:, 0], ij[:, 1]].contiguous()
    bi = ij[:, 0].to(torch.int32).contiguous()
    bj = ij[:, 1].to(torch.int32).contiguous()
    last = torch.ones_like(bi)
    last[:-1] = (bi[1:] != bi[:-1]).to(torch.int32)
    occupancy = torch.zeros(nb_r, dtype=torch.bool, device=w.device)
    occupancy[bi.long()] = True  # visited block rows (incl. the zero pad)
    return SkipPacked(
        tiles=tiles, bi=bi, bj=bj, last=last, shape=(n, k),
        block_shape=(br, bc),
        row_mask=occupancy.repeat_interleave(br),
        row_start=row_start_from_bi(bi, nb_r))


def _declare(lib: ctypes.CDLL) -> None:
    lib.bcr_spmm_skip_launch.argtypes = ([_I] + [_P] * 5 + [_I] * 7 + [_P])
    lib.bcr_spmm_skip_launch.restype = _I


def _checked_plan(packed: SkipPacked, device: torch.device) -> torch.Tensor:
    """Validate the pack's plan once per (pack, index tensors) and return
    its ``row_start``: ``bi`` sorted and within the grid, ``bj`` within
    the grid, and ``row_start`` equal to the offsets ``bi`` implies. A
    pack without ``row_mask`` or ``row_start`` (hand-rolled) gets
    ``row_start`` rebuilt from ``bi``. The check syncs the card, so its
    result is kept on the pack."""
    n, k = packed.shape
    br, bc = packed.block_shape
    nb_r, nb_c = n // br, k // bc
    rebuild = packed.row_mask is None or packed.row_start is None
    key = (packed.bi.data_ptr(), packed.bi._version, packed.bj.data_ptr(),
           packed.bj._version,
           None if rebuild else (packed.row_start.data_ptr(),
                                 packed.row_start._version))
    cached = getattr(packed, "_checked", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    given = [] if rebuild else [("row_start", packed.row_start)]
    for name, t in [("tiles", packed.tiles), ("bi", packed.bi),
                    ("bj", packed.bj)] + given:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "tiles" and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    num_nz = packed.tiles.shape[0]
    if tuple(packed.tiles.shape[1:]) != (br, bc) or num_nz == 0 \
            or packed.bi.numel() != num_nz or packed.bj.numel() != num_nz:
        raise ValueError(f"tiles {tuple(packed.tiles.shape)} / bi "
                         f"{packed.bi.numel()} / bj {packed.bj.numel()} do "
                         f"not describe num_nz {br}x{bc} tiles")
    if n % br or k % bc:
        raise ValueError(f"matrix {packed.shape} not divisible by block "
                         f"{packed.block_shape}")
    bi, bj = packed.bi.long(), packed.bj.long()
    bad = ((bi[1:] < bi[:-1]).any() | (bi < 0).any() | (bi >= nb_r).any()
           | (bj < 0).any() | (bj >= nb_c).any())
    if bool(bad):
        raise ValueError("bi must be sorted ascending and bi/bj within the "
                         f"{nb_r}x{nb_c} block grid")
    row_start = row_start_from_bi(packed.bi, nb_r)
    if not rebuild:
        if packed.row_start.numel() != nb_r + 1 or not torch.equal(
                packed.row_start, row_start):
            raise ValueError("row_start disagrees with the tile ranges of bi")
        row_start = packed.row_start
    packed._checked = (key, row_start)
    return row_start


def bcr_spmm_skip(x: torch.Tensor, packed: SkipPacked) -> torch.Tensor:
    """``y[M, N] = x[M, K] @ W.T`` visiting only surviving blocks; rows of
    block rows with no tile come out as exact zeros."""
    if not x.is_cuda:
        return ref.bcr_spmm_skip_ref(x, packed)
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (M, K) tensor")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not supported (float32, "
                        f"bfloat16)")
    if packed.tiles.dtype != x.dtype:
        raise TypeError(f"tiles dtype {packed.tiles.dtype} != x dtype "
                        f"{x.dtype} (cast the tiles to the activation dtype "
                        f"once, at pack time)")
    m, k = x.shape
    n = packed.shape[0]
    if k != packed.shape[1]:
        raise ValueError(f"x K dim {k} != packed K dim {packed.shape[1]}")
    row_start = _checked_plan(packed, x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    br, bc = packed.block_shape
    lib = build.load("bcr_spmm_skip", _declare)
    err = lib.bcr_spmm_skip_launch(
        _DTYPE_CODE[x.dtype], x.data_ptr(), packed.tiles.data_ptr(),
        packed.bj.data_ptr(), row_start.data_ptr(), y.data_ptr(),
        m, k, n, n // br, k // bc, br, bc,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "bcr_spmm_skip launch")
    LAUNCHES["bcr_spmm_skip"] += 1
    return y
