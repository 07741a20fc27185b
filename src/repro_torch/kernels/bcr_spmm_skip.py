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

Which body runs (:func:`tensor_core_body`): bf16 x over 16-byte aligned
tiles whose block sides are both multiples of 16 goes to the tensor cores,
launched by :func:`skip_plan` (pure, pinned by
``tests/test_torch_skip_plan.py``): the M tile, the instruction, the tile
rows per CTA, the cut of each block row's tiles into work units (longest
first), the copy-ring depth and the shared-memory bytes. Everything else —
fp32 x (its 1e-4 tolerance), other block sides, unaligned tiles — goes to
the CUDA-core body, which takes any shape. The design notes head the CUDA
source.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.bcr import BCRSpec, _to_blocks, bcr_mask
from repro_torch.kernels import build, ref
from repro_torch.kernels.bcr_spmm import _sm_count, split_counters

LAUNCHES = {"bcr_spmm_skip": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int

MAX_STAGES = 8
# two CTAs share an SM's 228 KB of shared memory (1 KB of each reserved)
TWO_CTA_SMEM = 115712
# M tiles of the compiled mma.sync configurations (rows per CTA 16, 32, 64
# or 128); the wgmma configuration takes M tile 128 with 64 or 128 rows
MMA_M_TILES = (8, 16, 64)
UNIT_FIELDS = 7   # block row, t0, t1, split, splits, first partial, counter


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


def _up(v: int, q: int) -> int:
    return -(-v // q) * q


def tensor_core_body(dtype: torch.dtype, block: Tuple[int, int],
                     aligned: bool = True) -> bool:
    """The rule for the tensor-core body: bf16, both block sides multiples
    of 16 (a k16 MMA step and 16-byte rows for the copies), tiles 16-byte
    aligned. Anything else runs the CUDA-core body."""
    return (dtype == torch.bfloat16 and block[0] % 16 == 0
            and block[1] % 16 == 0 and aligned)


@dataclasses.dataclass(frozen=True)
class SkipPlan:
    """One tensor-core launch. The grid is ``len(units) · chunks ·
    m_tiles`` CTAs, unit-major (so the plan's order is the launch order),
    M tile fastest: CTA (unit, chunk, M tile) computes tile rows
    ``[chunk·rows, (chunk+1)·rows)`` of the unit's block row over its tiles
    ``[t0, t1)``. A unit is ``(row, t0, t1, split, splits, part, ctr)``:
    split ``split`` of ``splits`` over the row's tiles, whose fp32 partial
    goes to workspace slot ``part + split`` and whose (row, chunk, M tile)
    counter is ``ctr`` (both -1 when the row is not split)."""
    wgmma: bool
    m_tile: int
    rows: int            # tile rows per CTA (divides br)
    chunks: int          # br // rows
    m_tiles: int
    kc: int              # contraction columns per ring stage
    stages: int
    smem_bytes: int
    units: Tuple[Tuple[int, ...], ...]
    parts: int           # partial slots of the split rows
    split_rows: int

    @property
    def grid(self) -> int:
        return len(self.units) * self.chunks * self.m_tiles

    @property
    def workspace_floats(self) -> int:
        return (self.parts * self.chunks * self.m_tiles * self.m_tile
                * self.rows)

    @property
    def counters(self) -> int:
        return self.split_rows * self.chunks * self.m_tiles

    def args(self) -> Tuple[int, ...]:
        """The order ``bcr_spmm_skip_launch`` reads its plan array in."""
        return (int(self.wgmma), self.m_tile, self.rows, self.chunks,
                self.m_tiles, self.kc, self.stages, self.smem_bytes,
                len(self.units))


def skip_smem(m_tile: int, rows: int, kc: int, stages: int) -> int:
    """Shared-memory bytes of one CTA; the CUDA launcher computes the same
    layout (``make_layout`` in the source) and refuses a plan that
    disagrees: ``stages`` ring slots, each a (rows × kc) tile slice and an
    (m_tile × kc) x slice (1024-byte aligned when 128-byte swizzled, else
    128), which the fp32 epilogue tile (m_tile × (rows + 4)) reuses; two
    mbarriers per stage; a flag; 1024 bytes of alignment slack."""
    align = 1024 if kc == 64 else 128
    slot = _up(rows * kc * 2, align) + _up(m_tile * kc * 2, align)
    epi = m_tile * (rows + 4) * 4
    return _up(max(stages * slot, epi), 16) + _up(2 * stages * 8, 16) + 16 \
        + 1024


def split_units(row_start: Tuple[int, ...], base: int, sm_count: int):
    """Cut each block row's tile range into units so that ``units · base``
    CTAs reach ``sm_count`` wherever the tile count allows: no cut when the
    block rows alone reach ``want = ⌈sm_count / base⌉`` units, else even
    pieces of at most ``num_nz // want`` tiles (at least 1). An empty row
    is one empty unit. Returns the units longest first (ties by row, then
    split), the partial slots and the split rows."""
    nb_r = len(row_start) - 1
    counts = [row_start[i + 1] - row_start[i] for i in range(nb_r)]
    want = -(-sm_count // base)
    length = (max(counts + [1]) if nb_r >= want
              else max(1, row_start[-1] // want))
    units, parts, split_rows = [], 0, 0
    for i, n in enumerate(counts):
        pieces = max(1, -(-n // length))
        part, ctr = (parts, split_rows) if pieces > 1 else (-1, -1)
        if pieces > 1:
            parts += pieces
            split_rows += 1
        for q in range(pieces):
            units.append((i, row_start[i] + q * n // pieces,
                          row_start[i] + (q + 1) * n // pieces, q, pieces,
                          part, ctr))
    units.sort(key=lambda u: (u[1] - u[2], u[0], u[3]))
    return tuple(units), parts, split_rows


@functools.lru_cache(maxsize=256)
def skip_plan(row_start: Tuple[int, ...], m: int, block: Tuple[int, int],
              sm_count: int) -> SkipPlan:
    """The tensor-core launch for ``x (m, K)`` against a pack whose block
    rows own the tile ranges ``row_start`` (``nb_r + 1`` offsets).

    * M tile and instruction: 8, 16 or 64 on mma.sync for M up to 64;
      beyond, 128 on wgmma when both block sides are multiples of 64, else
      64 on mma.sync.
    * Tile rows per CTA: the largest of 128, 64 (wgmma: one or two
      warpgroups), 32, 16 that divides br; halved (not below 64) while the
      grid stays under the SM count.
    * Units: :func:`split_units` over ``chunks · m_tiles`` CTAs a unit.
    * Ring: stages of 64 columns (128-byte swizzled) when 64 divides bc,
      else 32 or 16; as many as the longest unit uses, at least 2, at most
      8, and what leaves room for two CTAs an SM.
    """
    br, bc = block
    if br % 16 or bc % 16:
        raise ValueError(f"block {block}: the tensor-core body needs sides "
                         f"that are multiples of 16")
    if m < 1 or len(row_start) < 2 or row_start[0] != 0 or any(
            b < a for a, b in zip(row_start, row_start[1:])):
        raise ValueError(f"M {m} / row_start is not a launch")
    wg = m > MMA_M_TILES[-1] and br % 64 == 0 and bc % 64 == 0
    m_tile = 128 if wg else next(t for t in MMA_M_TILES
                                 if m <= t or t == MMA_M_TILES[-1])
    kc = 64 if bc % 64 == 0 else 32 if bc % 32 == 0 else 16
    m_tiles = -(-m // m_tile)
    cands = [r for r in ((128, 64) if wg else (128, 64, 32, 16))
             if br % r == 0]
    for k, rows in enumerate(cands):
        chunks = br // rows
        units, parts, split_rows = split_units(row_start, chunks * m_tiles,
                                               sm_count)
        if (len(units) * chunks * m_tiles >= sm_count or rows <= 64
                or k + 1 == len(cands)):
            break
    longest = max(u[2] - u[1] for u in units) * (bc // kc)
    stages = min(MAX_STAGES, max(2, longest))
    while stages > 2 and skip_smem(m_tile, rows, kc, stages) > TWO_CTA_SMEM:
        stages -= 1
    return SkipPlan(wg, m_tile, rows, chunks, m_tiles, kc, stages,
                    skip_smem(m_tile, rows, kc, stages), units, parts,
                    split_rows)


def _declare(lib: ctypes.CDLL) -> None:
    lib.bcr_spmm_skip_launch.argtypes = ([_I] + [_P] * 8 + [_I] * 8
                                         + [ctypes.POINTER(ctypes.c_int), _P])
    lib.bcr_spmm_skip_launch.restype = _I


def library() -> ctypes.CDLL:
    """This kernel's library, built first if missing, and loaded."""
    return build.load("bcr_spmm_skip", _declare)


def _checked_plan(packed: SkipPacked, device: torch.device) -> torch.Tensor:
    """Validate the pack's plan once per (pack, index tensors) and return
    its ``row_start``: ``bi`` sorted and within the grid, ``bj`` within
    the grid, and ``row_start`` equal to the offsets ``bi`` implies. A
    pack without ``row_mask`` or ``row_start`` (hand-rolled) gets
    ``row_start`` rebuilt from ``bi``. The check syncs the card, so its
    result is kept on the pack, with ``row_start`` on the host (the input
    of :func:`skip_plan`) and the device copies of its plans' units."""
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
    packed._checked = (key, row_start, tuple(row_start.tolist()), {})
    return row_start


def _units(packed: SkipPacked, plan: SkipPlan,
           device: torch.device) -> torch.Tensor:
    """The plan's unit records on the card, uploaded once per (checked
    pack, units)."""
    cache = packed._checked[3]
    key = (plan.rows, plan.chunks, plan.m_tiles)
    if key not in cache:
        cache[key] = torch.tensor(plan.units, dtype=torch.int32,
                                  device=device).reshape(-1)
    return cache[key]


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
    plan_arr, units, ws, counters = None, None, None, None
    if tensor_core_body(x.dtype, (br, bc),
                        packed.tiles.data_ptr() % 16 == 0):
        if x.data_ptr() % 16:
            x = x.clone()
        plan = skip_plan(packed._checked[2], m, (br, bc), _sm_count(x.device))
        plan_arr = (ctypes.c_int * 9)(*plan.args())
        units = _units(packed, plan, x.device)
        if plan.parts:
            ws = torch.empty(plan.workspace_floats, dtype=torch.float32,
                             device=x.device)
            counters = split_counters(x.device, plan.counters)
    err = library().bcr_spmm_skip_launch(
        _DTYPE_CODE[x.dtype], x.data_ptr(), packed.tiles.data_ptr(),
        packed.bj.data_ptr(), row_start.data_ptr(),
        units.data_ptr() if units is not None else None, y.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        counters.data_ptr() if counters is not None else None,
        m, k, n, n // br, k // bc, br, bc, packed.tiles.shape[0], plan_arr,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "bcr_spmm_skip launch")
    LAUNCHES["bcr_spmm_skip"] += 1
    return y
