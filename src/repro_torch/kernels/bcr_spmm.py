"""BCR block-sparse matmul over TBCRC-packed weights: the hand-written CUDA
kernels of ``csrc/bcr_spmm.cu`` and their wrappers.

* :func:`bcr_spmm` — ``y[M, N] = x[M, K] @ W.T``; replaces the reference's
  TPU kernel ``kernels/bcr_spmm.py:bcr_spmm``.
* :func:`bcr_spmm_grouped` — G same-shaped packed weights over one ``x``,
  with a fused ``(G, N)`` bias and optional SwiGLU epilogue; replaces
  ``kernels/bcr_spmm.py:bcr_spmm_grouped``.

Each has two forms, chosen by the packed ``vals``: the fp form (tiles in
x's dtype) and the int8 form (int8 codes with one fp32 scale per tile on
``plan.block_scales``, the reference's quantized serving).

Each also takes a pack stacked on a leading expert axis (an MoE layer's E
experts: vals ``(E, [G,] nb_r, nb_c, R_keep, C_keep)``) with x ``(E, M, K)``
and returns y with the same leading axis, in ONE launch for all E experts:
the expert is the grid's second axis, as the reference's ``jax.vmap`` over
its ``pallas_call`` makes the batch a grid axis. Every expert computes its
whole ``(M, N)``, empty or not (its pad rows are zero), as the reference's
does.

Under bf16 x both forms run on the tensor cores; :func:`launch_plan` (pure,
pinned by ``tests/test_torch_bcr_plan.py``) picks the launch: the M tile,
the warp layout, the output rows per CTA, the split of the contraction
blocks over CTAs at small M, the copy-ring depth and the shared-memory
bytes. A G = 1 launch of one unstacked pack whose blocks are shorter than
one m16 MMA slab (br < 16: GRIM's own (8, 8) / (8, 16) blocks, whisper's
(2, 128) lm_head) takes the short-block body (``LaunchPlan.body ==
"short"``): P block rows a CTA, each stage's tiles expanded across their
blocks in shared memory against x's dense block. The 128-row M tile
(prefill) takes the wide body (``body == "wg"``): wgmma over 256 MMA rows
a CTA of the flattened (block row, member) rows, whatever G, each tile
expanded across its block's 128 columns against x's dense block as TMA
stages it. A pack whose plan carries a tuned genome (``kernels/plan.py``,
GRIM §4.5) fixes the M tile, the configuration and the split for every call
of at most the decode batch it was tuned for; an illegal genome raises.

Under fp32 x (fp32 tiles, or int8 tiles; GRIM's GRU and CNN, the 1e-4
checks) both forms run the fp32 body on the CUDA cores (``body ==
"fp32"``), planned by :func:`fp32_plan` (pure, pinned by
``tests/test_torch_bcr_plan.py``; a tuned genome is not read): a CTA owns
whole units (one member's block row) × an M tile, warps own T output rows
by a slice of the M tile with the accumulators in registers, each stage's
J blocks arrive by cp.async one or two stages ahead, and at small M the
stages are split over CTAs.

A CUDA tensor goes through the kernel (or the wrapper raises); a CPU tensor
goes through the plain version in :mod:`repro_torch.kernels.ref`. Each
launch adds one to ``LAUNCHES[<kernel>]``, with separate keys per form
(``bcr_spmm`` / ``bcr_spmm_int8``, ``bcr_spmm_grouped`` /
``bcr_spmm_grouped_int8``); a launch over stacked experts also adds one to
the form's ``<kernel>_experts`` key, which counts the expert-batched form
apart, and a launch of the short-block body one to ``bcr_spmm_short`` /
``bcr_spmm_int8_short``. The kernels' design notes (what bounds them on
the card, and what the design does about it) head the CUDA source.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.plan import (launch_genome, plan_shards,
                                     stacked_experts)

LAUNCHES = {"bcr_spmm": 0, "bcr_spmm_grouped": 0, "bcr_spmm_int8": 0,
            "bcr_spmm_grouped_int8": 0, "bcr_spmm_experts": 0,
            "bcr_spmm_grouped_experts": 0, "bcr_spmm_int8_experts": 0,
            "bcr_spmm_grouped_int8_experts": 0, "bcr_spmm_short": 0,
            "bcr_spmm_int8_short": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int

SMEM_LIMIT = 232448          # bytes of shared memory a Hopper CTA may take
MAX_STAGES = 8
# (M tile, m16 row slabs per warp, warps across the M tile, compute warps):
# the compiled tensor-core configurations. A CTA computes 16·slabs·(warps /
# warps_m) MMA rows (the weight's rows, the MMA's M side) by the M tile (the
# MMA's N side). M tiles up to 64 run mma.sync over one block row (a warp
# owns slabs × 16 rows of one member by M tile / warps_m columns; one more
# warp issues the copies). The 128 tile is the wide body (``body="wg"``):
# wgmma m64n128k16, two warpgroups of two m64 slabs (each warp 16 rows of
# each, so 2 m16 slabs a warp across all 128 columns), 256 MMA rows over the
# flattened (block row, member) rows, each tile expanded across its block's
# columns against x's dense block (blocks of ``WG_BC`` columns).
CONFIGS = ((8, 1, 1, 8), (8, 2, 1, 8), (16, 1, 1, 8), (16, 2, 1, 8),
           (32, 1, 1, 8), (32, 2, 1, 8), (64, 2, 2, 8), (128, 2, 1, 8))
M_TILES = (8, 16, 32, 64, 128)
WG_M_TILE = 128              # the wide body's M tile
WG_ROWS = 256                # its MMA rows a CTA
WG_BC = 128                  # the block columns it takes (two 64-wide atoms)
# The short-block body (blocks shorter than one m16 slab, G = 1): 8 warps a
# CTA, each (M tile, slabs, warps_m, rows) below one compiled configuration.
# A CTA computes ``rows`` MMA rows — the P = rows // br block rows it owns —
# by the M tile; warp (wr, wm, wk) owns ``slabs`` m16 slabs by M tile /
# (8·warps_m) n8 tiles and every warps_k-th k16 step, warps_k = 8 /
# (rows / (16·slabs) · warps_m).
SHORT_WARPS = 8
SHORT_CONFIGS = ((8, 1, 1, 16), (8, 1, 1, 64), (8, 1, 1, 128),
                 (16, 1, 1, 16), (16, 1, 1, 64), (16, 1, 1, 128),
                 (32, 1, 1, 16), (32, 1, 1, 64), (32, 1, 1, 128),
                 (64, 1, 2, 16), (64, 1, 2, 64), (64, 2, 2, 128),
                 (128, 1, 2, 16), (128, 2, 2, 64), (128, 2, 2, 128))
SHORT_SLOTS = 3              # ring slots: two stages in flight ahead of one
SHORT_DEPTH = 256            # the most x columns (J·bc) a stage takes
# The fp32 body (fp32 x, CUDA cores): (T output rows a warp item, U x rows
# a lane) of each compiled configuration; at most FP32_WARPS warps a CTA.
FP32_CONFIGS = ((2, 1), (2, 4), (8, 1), (8, 4), (16, 1), (16, 4))
FP32_WARPS = 16
FP32_DEPTH = 256             # the most x columns (J·bc) a stage takes


def _up(v: int, q: int) -> int:
    return -(-v // q) * q


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One tensor-core launch. The grid is ``nb_r · chunks · m_tiles ·
    splits`` CTAs by ``experts``; CTA (block row i, row chunk, M tile, split
    s; expert e) computes output rows ``[chunk·n_chunk, (chunk+1)·n_chunk)``
    of block row i for every member of expert e, over contraction blocks
    ``[s·nb_c/S, (s+1)·nb_c/S)``."""
    m_tile: int
    slabs: int           # m16 row slabs per warp
    warps_m: int         # warps side by side across the M tile
    warps: int           # compute warps
    n_chunk: int         # output rows of one member per CTA
    chunks: int          # row chunks per block row
    m_tiles: int
    splits: int          # CTAs sharing one output tile's contraction
    stages: int          # copy-ring depth, in contraction blocks
    vec: bool            # 16-byte asynchronous copies (else plain loads)
    smem_bytes: int
    nb_r: int
    nb_c: int
    group: int
    experts: int = 1     # the grid's second axis (1: an unstacked pack)
    # the body: "tc" (one block row a CTA, one contraction block a stage),
    # "short" (block_rows block rows a CTA, stage_blocks blocks a stage,
    # warps_k warps sharing the k16 steps of one output tile) or "wg" (the
    # 128 M tile: n_chunk flattened output rows a CTA, chunks such row
    # groups over the G·N rows; units, the most (member, block row) tiles a
    # CTA stages; m_fast, the M tile the grid's fastest axis)
    body: str = "tc"
    block_rows: int = 1
    stage_blocks: int = 1
    warps_k: int = 1
    units: int = 1
    m_fast: bool = False
    # the fp32 body ("fp32"): T output rows a warp item (warp_rows), U x
    # rows a lane (lane_rows), lanes across the M tile (lanes_m), row chunks
    # of T rows a CTA takes of each of its ``units`` units (row_chunks; a
    # unit is one member's block row, ``chunks`` such chunk groups cover a
    # block row, ``n_chunk`` the rows of a unit a CTA emits)
    warp_rows: int = 0
    lane_rows: int = 1
    lanes_m: int = 32
    row_chunks: int = 1

    @property
    def rows(self) -> int:
        """MMA rows one CTA computes (all members together)."""
        return 16 * self.slabs * (self.warps // (self.warps_m * self.warps_k))

    @property
    def grid(self) -> int:
        return self.tiles * self.splits

    @property
    def tiles(self) -> int:
        """Output tiles, every expert's: one split counter each."""
        if self.body == "fp32":
            return (self.experts * -(-self.nb_r * self.group // self.units)
                    * self.chunks * self.m_tiles)
        if self.body == "wg":
            return self.experts * self.chunks * self.m_tiles
        return (self.experts * -(-self.nb_r // self.block_rows) * self.chunks
                * self.m_tiles)

    @property
    def workspace_floats(self) -> int:
        """fp32 partials of a split launch (0 when unsplit)."""
        if self.splits == 1:
            return 0
        if self.body == "fp32":
            return (self.tiles * self.splits * self.m_tile * self.units
                    * self.n_chunk)
        # the wide body's partial: 128 rows of its 256 MMA rows' floats
        rows = self.rows if self.body == "wg" else self.n_chunk * self.group
        return self.tiles * self.splits * self.m_tile * rows

    def args(self) -> Tuple[int, ...]:
        """The order ``bcr_spmm_launch`` (or, for the short body,
        ``bcr_spmm_short_launch``) reads its plan array in."""
        if self.body == "fp32":
            return (self.m_tile, self.warp_rows, self.lane_rows, self.lanes_m,
                    self.warps_m, self.units, self.row_chunks,
                    self.stage_blocks, self.splits, self.stages,
                    int(self.vec), self.smem_bytes)
        if self.body == "short":
            return (self.m_tile, self.slabs, self.warps_m, self.n_chunk,
                    self.stage_blocks, self.splits, self.stages,
                    int(self.vec), self.smem_bytes)
        if self.body == "wg":
            return (self.m_tile, self.n_chunk, self.chunks, self.splits,
                    self.stages, int(self.vec), int(self.m_fast), self.units,
                    self.smem_bytes)
        return (self.m_tile, self.slabs, self.warps_m, self.n_chunk,
                self.chunks, self.splits, self.stages, int(self.vec),
                self.smem_bytes)


def smem_layout(m_tile: int, n_chunk: int, stages: int, g: int, bc: int,
                r: int, c: int, int8_tiles: bool, vec: bool,
                blocks: int) -> int:
    """Shared-memory bytes of one CTA; the CUDA launcher computes the same
    layout (``Layout`` in the source) and refuses a plan that disagrees.

    Per ring stage (1024-byte aligned): the kept tiles (bf16 rows dense as
    TMA copies them, each member's tile 128-byte aligned as TMA needs, or
    padded to ``Cp + 8`` elements on the plain-load path, ``Cp`` = C_keep
    rounded up to 16; int8 codes flat, 16-byte aligned per member), the x block (M tile × bc bf16), the row and column indices.
    Then two gathered-x buffers (G × M tile rows of ``Cp + 8`` elements),
    two widened int8 tile buffers (int8 form), the fp32 epilogue tile
    (aliasing the ring), two
    inverse row maps, a zero row, a flag, one mbarrier per stage, the int8
    tile scales of the CTA's ``blocks`` contraction blocks and 1024 bytes of
    alignment slack."""
    cp = _up(c, 16)
    row = (cp + 8) * 2
    ts = c * 2 if vec and not int8_tiles else row
    member = (_up(r * c, 16) if int8_tiles
              else _up(r * ts, 128) if vec else r * ts)
    off_cidx = (_up(g * member, 128) + _up(m_tile * bc * 2, 128)
                + _up(g * r * 4, 16))
    slot = _up(off_cidx + _up(g * c * 4, 16), 1024)
    main = stages * slot + 2 * g * m_tile * row
    if int8_tiles:
        main += 2 * g * r * row
    red = g * m_tile * (n_chunk + 4) * 4
    scales = _up(blocks * g * 4, 16) if int8_tiles else 0
    return (max(main, red) + _up(2 * g * n_chunk * 4, 16) + _up(row, 16)
            + 16 + _up(stages * 8, 16) + scales + 1024)


def wg_smem_layout(span: int, stages: int, bc: int, br: int, r: int, c: int,
                   int8_tiles: bool, blocks: int) -> int:
    """Shared-memory bytes of one CTA of the wide body (the 128 M tile);
    the CUDA launcher computes the same layout (``WgLayout`` in the
    source) and refuses a plan that disagrees.

    Two rings of ``stages`` slots: x blocks (128 rows × bc bf16, as
    64-column 128-byte-swizzled atoms) and, 128-byte aligned, for each of
    the CTA's ``wg_units`` units (a member's block row) its kept tile
    (16-byte aligned), row and column indices. Then two buffers of the
    units' expanded tiles (R_keep rows of ``bc + 8`` bf16 each), the fp32
    epilogue tile (128 × 260, aliasing the rings), two inverse row maps
    (units × br ints), a zero row, the split flag, one mbarrier a slot of
    each ring, the int8 tile scales of the CTA's ``blocks`` blocks and 1024
    bytes of alignment slack."""
    nu = wg_units(span, br)
    elt = 1 if int8_tiles else 2
    row = (bc + 8) * 2
    tslot = _up(nu * _up(r * c * elt, 16) + _up(nu * r * 4, 16)
                + _up(nu * c * 4, 16), 128)
    main = stages * (WG_M_TILE * bc * 2 + tslot) + 2 * nu * r * row
    red = WG_M_TILE * (WG_ROWS + 4) * 4
    scales = _up(blocks * nu * 4, 16) if int8_tiles else 0
    return (max(main, red) + _up(2 * nu * br * 4, 16) + _up(row, 16) + 16
            + _up(2 * stages * 8, 16) + scales + 1024)


def wg_span(g: int, br: int) -> int:
    """Flattened output rows a wide-body CTA computes: its 256 MMA rows,
    or, for a pair (G = 2, whose SwiGLU epilogue needs gate row and up row
    in one CTA), the whole gate/up pairs of block rows they hold (0: none).
    Row q of the G·N is row q % br of block row (q // br) // G of member
    (q // br) % G."""
    if g == 2:
        return WG_ROWS // (2 * br) * 2 * br
    return WG_ROWS


def wg_units(span: int, br: int) -> int:
    """The most units (block rows of one member) a window of ``span``
    flattened rows touches: span / br where windows start on unit
    boundaries, else two more for the ends."""
    return span // br if span % br == 0 else span // br + 2


def _wg_fit(m, n, k, g, block, kept, nb_r, nb_c, split, int8_tiles, aligned,
            experts, shards, sm_count) -> Optional[LaunchPlan]:
    """The wide body's plan (the 128 M tile), or None where it cannot run
    the shape (blocks other than ``WG_BC`` columns, a pair of block rows over
    256 rows, or shared memory no ring of 3 fits).

    * Rows: ``wg_span`` flattened rows a CTA, ``chunks`` = ceil(G·N / span)
      row groups.
    * Split (``_wg_splits``), where ``split`` allows one: over every
      expert's row groups × M tiles (the whole weight's under ``shards``).
    * Grid order: the M tile fastest where the packed tiles outweigh x (they
      then stream from device memory once while x stays in L2), else the
      row groups (each x block read from device memory once).
    * Copies (``vec``): TMA for x and bulk copies for tiles and indices on
      16-byte aligned operands whose runs are 16-byte multiples; else plain
      loads through the same ring.
    * Stages: one more than the blocks a CTA walks, at least 3, at most 8,
      and what shared memory holds."""
    br, bc = block
    r, c = kept
    span = wg_span(g, br)
    if bc != WG_BC or span == 0:
        return None
    elt = 1 if int8_tiles else 2
    m_tiles = -(-m // WG_M_TILE)
    chunks = -(-(g * n) // span)
    tiles = experts * chunks * m_tiles
    splits = _wg_splits(tiles * shards, nb_c, sm_count) if split else 1
    blocks = -(-nb_c // splits)
    vec = (aligned and k % 8 == 0 and r % 4 == 0 and c % 4 == 0
           and (r * c * elt) % 16 == 0)
    m_fast = g * nb_r * nb_c * r * c * elt > m * k * 2
    for stages in range(min(MAX_STAGES, max(3, blocks + 1)), 2, -1):
        smem = wg_smem_layout(span, stages, bc, br, r, c, int8_tiles, blocks)
        if smem <= SMEM_LIMIT:
            return LaunchPlan(WG_M_TILE, 2, 1, 8, span, chunks, m_tiles,
                              splits, stages, vec, smem, nb_r, nb_c, g,
                              experts, "wg", units=wg_units(span, br),
                              m_fast=m_fast)
    return None


def short_smem_layout(m_tile: int, rows: int, br: int, j: int, slots: int,
                      bc: int, r: int, c: int, int8_tiles: bool,
                      warps_k: int) -> int:
    """Shared-memory bytes of one CTA of the short body; the CUDA launcher
    computes the same layout (``ShortLayout`` in the source) and refuses a
    plan that disagrees.

    A ring slot holds one stage of ``j`` contraction blocks: the x block
    (M tile rows of ``ks`` = J·bc rounded up to 16 columns, rows ``ks + 8``
    elements apart), then for each of the CTA's P = rows // br block rows
    its runs of tile values, row indices, column indices (and int8 scales),
    each with room for the 16-byte chunks that cover it at any alignment
    (n + 15 bytes rounded up to 16); the slot is 128-byte aligned. Then two
    expanded A buffers (rows × ks, the same row stride). The epilogue's
    fp32 tiles (``warps_k`` of M tile × (rows + 4)) alias the ring; 16
    bytes for the split flag follow."""
    p = rows // br
    elt = 1 if int8_tiles else 2
    ks = _up(j * bc, 16)
    stride = (ks + 8) * 2

    def cover(n: int) -> int:
        return _up(n + 15, 16)

    runs = (cover(j * r * c * elt) + cover(j * r * 4) + cover(j * c * 4)
            + (cover(j * 4) if int8_tiles else 0))
    slot = _up(m_tile * stride + p * runs, 128)
    main = slots * slot + 2 * rows * stride
    red = warps_k * m_tile * (rows + 4) * 4
    return max(main, red) + 16


def short_configs(m_tile: int) -> Tuple[Tuple[int, int, int], ...]:
    """``(slabs, warps_m, rows)`` of each short-body configuration compiled
    for ``m_tile``, in ``SHORT_CONFIGS`` order: a short block's genome
    ``config`` indexes this."""
    return tuple((slabs, wm, rows) for cmt, slabs, wm, rows in SHORT_CONFIGS
                 if cmt == m_tile)


def short_body(block: Tuple[int, int], g: int, experts: int) -> bool:
    """Whether a launch runs the short-block body: one unstacked (or
    single-expert) pack, G = 1, whose blocks are shorter than one m16 MMA
    slab (br < 16). Under the tensor-core body, one block row a CTA, such a
    block row leaves at least 112 of the CTA's 128 MMA rows idle."""
    return block[0] < 16 and g == 1 and experts == 1


def _short_fit(m: int, k: int, br: int, bc: int, r: int, c: int, nb_r: int,
               nb_c: int, mt: int, cfg: Tuple[int, int, int], split: bool,
               int8_tiles: bool, aligned: bool, sm_count: int,
               shards: int) -> Optional[LaunchPlan]:
    """The short-body plan of configuration ``cfg`` at M tile ``mt``, or
    None where its P·br rows or no stage depth fit.

    * Stage depth J: the most contraction blocks whose x columns (J·bc)
      stay within ``SHORT_DEPTH`` and, where any J allows it, are a whole
      number of k16 steps; under a split, at most nb_c / (the CTAs each
      output tile needs to fill the card), so the split has stages to
      share. The deepest J shared memory holds.
    * Split: the rule's count over the nb_c / J stages (the tiles of every
      shard counted, as ``launch_plan`` counts them), each split a run of
      whole stages; none where K is under two full stages (2 ·
      ``SHORT_DEPTH``): there a split's partials cost more than its share
      of the contraction saves (on an H100, the CNN's conv2, K = 144).
    * Ring: three slots (two stages in flight ahead of the one computed),
      fewer when a split walks fewer stages."""
    slabs, wm, rows = cfg
    if rows < br:
        return None
    p = rows // br
    wk = SHORT_WARPS // ((rows // (16 * slabs)) * wm)
    m_tiles = -(-m // mt)
    tiles = -(-nb_r // p) * m_tiles
    split = split and k >= 2 * SHORT_DEPTH
    need = 1
    if split and 2 * tiles * shards <= sm_count:
        need = -(-sm_count // (tiles * shards))
    jmax = max(1, min(nb_c, SHORT_DEPTH // bc))
    if need > 1:
        jmax = max(1, min(jmax, nb_c // need))
    cands = ([j for j in range(jmax, 0, -1) if (j * bc) % 16 == 0]
             or list(range(jmax, 0, -1)))
    for j in cands:
        n_st = -(-nb_c // j)
        splits = (_rule_splits(tiles * shards, n_st, sm_count) if split
                  else 1)
        slots = min(SHORT_SLOTS, -(-n_st // splits))
        smem = short_smem_layout(mt, rows, br, j, slots, bc, r, c,
                                 int8_tiles, wk)
        if smem <= SMEM_LIMIT:
            vec = aligned and k % 8 == 0 and (j * bc) % 8 == 0
            return LaunchPlan(mt, slabs, wm, SHORT_WARPS, rows, 1, m_tiles,
                              splits, slots, vec, smem, nb_r, nb_c, 1, 1,
                              "short", p, j, wk)
    return None


def fp32_rows(br: int) -> int:
    """T, the output rows of one warp item of the fp32 body: 16 rows of a
    block of 16 or more, 8 of GRIM's (8, 8) / (8, 16), 2 of shorter ones
    (whisper's (2, 128))."""
    return 2 if br < 8 else 8 if br < 16 else 16


def fp32_smem_layout(m_tile: int, units: int, row_chunks: int, t: int,
                     u: int, j: int, slots: int, br: int, bc: int, r: int,
                     c: int, int8_tiles: bool) -> int:
    """Shared-memory bytes of one CTA of the fp32 body; the CUDA launcher
    computes the same layout (``f32::Layout`` in the source) and refuses a
    plan that disagrees.

    A ring slot holds one stage of ``j`` contraction blocks: the x block
    transposed (J·bc + 1 columns, the last zeros, each of the M tile's rows
    padded to xstride floats: at U = ``u`` = 4 an odd multiple of 4, else
    odd; 16-byte aligned), then for each of the CTA's units its tiles (fp32
    rows of Cp = C_keep rounded up to 4 floats; int8 codes as the 16-byte
    chunks that cover their run at any alignment: n + 15 bytes rounded up
    to 16), its row-index run, column-index run (and int8 scales), each
    with that room; the slot is 128-byte aligned. Then
    two inverse row maps (units × J × ceil(br / T)·T ushorts each, rounded
    up to 16 bytes), two column-offset tables (units × J × Cp ints) and,
    under int8 tiles, two widened fp32 tile buffers. The epilogue's fp32
    tile (M tile × (units · rows + 1) floats, rows = min(br, row_chunks ·
    T)) aliases them; 16 bytes for the split flag follow, 16-byte
    aligned."""
    def cover(n: int) -> int:
        return _up(n + 15, 16)

    ks = j * bc
    xstride = (-(-m_tile // 4) | 1) * 4 if u == 4 else m_tile | 1
    cp = _up(c, 4)
    brp = -(-br // t) * t
    tile = j * r * cp * 4
    raw = cover(j * r * c) if int8_tiles else tile
    runs = (raw + cover(j * r * 4) + cover(j * c * 4)
            + (cover(j * 4) if int8_tiles else 0))
    slot = _up(_up((ks + 1) * xstride * 4, 16) + units * runs, 128)
    main = (slots * slot + 2 * _up(units * j * brp * 2, 16)
            + 2 * units * j * cp * 4 + (2 * units * tile if int8_tiles else 0))
    rows = min(br, row_chunks * t)
    red = m_tile * (units * rows + 1) * 4
    return _up(max(main, red), 16) + 16


@functools.lru_cache(maxsize=1024)
def fp32_plan(m: int, n: int, k: int, g: int, block: Tuple[int, int],
              kept: Tuple[int, int], sm_count: int,
              int8_tiles: bool = False, aligned: bool = True,
              experts: int = 1, shards: int = 1) -> LaunchPlan:
    """The fp32 body's launch (fp32 x; fp32 tiles, or int8 tiles) for ``x
    (m, k)`` against G packed ``(n, k)`` weights of ``block`` blocks keeping
    ``kept``, for each of ``experts`` stacked experts. One rule:

    * Rows: T = :func:`fp32_rows` (br) output rows a warp item; a unit (one
      member's block row) is ceil(br / T) items.
    * x rows: M up to 32 four rows a lane (``lanes_m`` the power of two
      that holds M / 4; the other lanes of a warp share the contraction)
      where those lanes all fit one block's 4-column chunks (128 blocks at
      M = 5..32), else one row a lane (``lanes_m`` the power of two that
      holds M: GRIM's (8, 8) blocks, decode at M up to 4); M up
      to 64 two warps of 32 lanes across the M tile; else U = 4 rows a lane
      over 32 lanes, an M tile of 128 (an M tile of 64, one row a lane,
      where M is at most 512 and the 128 tile's grid fills under half the
      SMs: conv2 at M = 256).
    * A CTA: as many whole units as its warps hold (``FP32_WARPS`` / (items
      a unit × warps across M), at most 8 warps for blocks
      of one item at M up to 32: the GRU's CTAs each stream little, and
      small ones, several to an SM, finish sooner); G = 2 in whole gate/up
      pairs (the SwiGLU epilogue reads both); where a unit (a pair) does not
      fit, the chunks of one unit (pair) that do.
    * Stage depth J: the most blocks whose x columns (J·bc) stay within
      ``FP32_DEPTH`` and, split, at most nb_c / (the CTAs each output tile
      needs to fill the card), so the split has stages to share; the deepest
      J that a ring of two slots holds (one stage in flight ahead of the
      one computed), in three slots where they fit (two ahead).
    * Split: the rule's count (``_rule_splits``, the tiles of every shard
      counted) over the nb_c / J stages; none where K is under two full
      stages (2 · ``FP32_DEPTH``: conv2's K = 144). Where even the full
      split leaves the grid short of the SM count, a CTA takes half the
      rows (units, then chunks) and the rule runs again (jamba's x_proj at
      M = 8: 2 units of 144 rows → 4 row groups).

    Raises ``ValueError`` where the shape is not whole blocks, the kept
    counts do not fit the block, or no CTA holds a stage of one block."""
    br, bc = block
    r, c = kept
    if n % br or k % bc:
        raise ValueError(f"({n}, {k}) is not a whole number of {br}x{bc} "
                         f"blocks")
    if not (1 <= r <= br and 1 <= c <= bc):
        raise ValueError(f"kept counts {kept} do not fit a {br}x{bc} block")
    if (r - 1) * _up(c, 4) * 4 + 16 > 0xFFFF:
        raise ValueError(f"kept tile {kept} is too large for the fp32 "
                         f"body's 16-bit row offsets")
    nb_r, nb_c = n // br, k // bc
    units = nb_r * g
    t = fp32_rows(br)
    chunks = -(-br // t)
    pair = 2 if g == 2 else 1

    def rows_a_cta(wm):
        # small blocks at small M: small CTAs
        most = 8 if m <= 32 and chunks == 1 else FP32_WARPS
        if pair * chunks * wm <= most:
            return chunks, min(units, most // (chunks * wm) // pair * pair)
        return most // (pair * wm), pair

    nch = -(-c // 4)
    if m <= 32:
        # 4 rows a lane where the lanes left over share a block's chunks
        # (no lane on another block: the row branches stay warp-uniform)
        lm4 = 1 << max(0, (-(-m // 4) - 1).bit_length())
        if 32 // lm4 <= 1 << max(0, (nch - 1).bit_length()):
            u, lm, wm = 4, lm4, 1
        else:
            u, lm, wm = 1, 1 << max(0, (m - 1).bit_length()), 1
    elif m <= 64:
        u, lm, wm = 1, 32, 2
    else:
        u, lm, wm = 4, 32, 1
        cr, nu = rows_a_cta(wm)
        if (m <= 512 and 2 * experts * -(-units // nu) * -(-chunks // cr)
                * -(-m // 128) * shards < sm_count):
            u, wm = 1, 2       # more, smaller CTAs where the grid is short
    mt = wm * lm * u
    m_tiles = -(-m // mt)
    cr, nu = rows_a_cta(wm)
    # a split pays off only over two full stages (conv2, K = 144, never)
    split = k >= 2 * FP32_DEPTH
    vec = aligned and c % 4 == 0 and not int8_tiles
    while True:
        ncg = -(-chunks // cr)
        tiles = experts * -(-units // nu) * ncg * m_tiles
        need = (1 if not split or 2 * tiles * shards > sm_count
                else -(-sm_count // (tiles * shards)))
        jmax = max(1, min(nb_c, FP32_DEPTH // bc))
        if need > 1:
            jmax = max(1, min(jmax, nb_c // need))
        n_st = -(-nb_c // jmax)
        splits = (_rule_splits(tiles * shards, n_st, sm_count) if split
                  else 1)
        short = (need > 1 and splits == n_st
                 and tiles * shards * splits < sm_count)
        if not short or (nu == pair and cr == 1):
            break
        if nu > pair:          # half the rows a CTA, and the rule again
            nu = max(pair, nu // 2 // pair * pair)
        else:
            cr = -(-cr // 2)
    rows = min(br, cr * t)
    for j in range(jmax, 0, -1):
        for slots in (3, 2):
            n_st = -(-nb_c // j)
            splits = (_rule_splits(tiles * shards, n_st, sm_count) if split
                      else 1)
            ring = min(slots, -(-n_st // splits))
            smem = fp32_smem_layout(mt, nu, cr, t, u, j, ring, br, bc, r,
                                    c, int8_tiles)
            if smem <= SMEM_LIMIT:
                return LaunchPlan(mt, 1, wm, nu * cr * wm, rows, ncg,
                                  m_tiles, splits, ring, vec, smem, nb_r,
                                  nb_c, g, experts, "fp32", 1, j, 1, nu,
                                  warp_rows=t, lane_rows=u, lanes_m=lm,
                                  row_chunks=cr)
    raise ValueError(f"BCR block {br}x{bc} keeping {r}x{c} (G={g}) needs "
                     f"more shared memory than a CTA has (fp32 x)")


def tile_configs(m_tile: int) -> Tuple[Tuple[int, int, int], ...]:
    """``(slabs, warps_m, warps)`` of each configuration compiled for
    ``m_tile``, in ``CONFIGS`` order: a genome's ``config`` indexes this."""
    return tuple((slabs, wm, nw) for cmt, slabs, wm, nw in CONFIGS
                 if cmt == m_tile)


def _chunking(slabs: int, wm: int, nw: int, g: int,
              br: int) -> Optional[Tuple[int, int, int]]:
    """``(n_chunk, chunks, wasted MMA rows)`` of one mma.sync
    configuration for G members of ``br``-row blocks, or None where it
    cannot run them (fewer rows than one warp's slab a member)."""
    rows = 16 * slabs * (nw // wm)
    q = 16 * slabs
    n_chunk = min(_up(br, q), (rows // g) // q * q)
    if n_chunk < q:
        return None
    chunks = -(-br // n_chunk)
    return n_chunk, chunks, chunks * rows - g * br


def _rule_splits(tiles: int, nb_c: int, sm_count: int) -> int:
    """Split where it at least doubles the grid (a nearly full grid gains
    less than the partials' round trip costs)."""
    return 1 if 2 * tiles > sm_count else min(nb_c, -(-sm_count // tiles))


WG_CTA_BLOCKS = 2            # a CTA's prologue and epilogue, in blocks
WG_SPLIT_BLOCKS = 2          # a split's partials round trip, in blocks


def _wg_splits(tiles: int, nb_c: int, sm_count: int) -> int:
    """The wide body's split: the count whose launch takes the fewest
    rounds — waves of one CTA an SM, each as long as the contraction blocks
    a CTA walks plus its prologue and epilogue (``WG_CTA_BLOCKS``) and,
    split, its partials (``WG_SPLIT_BLOCKS``) — the smallest on a tie.
    pixtral's ``wq`` at M = 512 (64 tiles of 40 blocks): 2 splits, 128 CTAs
    of 20 blocks, where the decode rule's 3 leave a second wave."""
    def rounds(sp: int) -> int:
        per = -(-nb_c // sp) + WG_CTA_BLOCKS + (WG_SPLIT_BLOCKS if sp > 1
                                                else 0)
        return -(-tiles * sp // sm_count) * per

    return min(range(1, nb_c + 1), key=lambda sp: (rounds(sp), sp))


def _fit(mt, slabs, wm, nw, n_chunk, chunks, m, g, bc, r, c, nb_r, nb_c,
         splits, int8_tiles, vec, experts) -> Optional[LaunchPlan]:
    """The plan with the deepest ring shared memory holds, or None."""
    m_tiles = -(-m // mt)
    blocks = -(-nb_c // splits)
    for stages in range(min(MAX_STAGES, max(3, blocks + 1)), 2, -1):
        smem = smem_layout(mt, n_chunk, stages, g, bc, r, c, int8_tiles,
                           vec, blocks)
        if smem <= SMEM_LIMIT:
            return LaunchPlan(mt, slabs, wm, nw, n_chunk, chunks, m_tiles,
                              splits, stages, vec, smem, nb_r, nb_c, g,
                              experts)
    return None


@functools.lru_cache(maxsize=1024)
def launch_plan(m: int, n: int, k: int, g: int, block: Tuple[int, int],
                kept: Tuple[int, int], sm_count: int,
                int8_tiles: bool = False, aligned: bool = True,
                experts: int = 1,
                genome: Optional[Tuple[int, int, bool]] = None,
                shards: int = 1) -> LaunchPlan:
    """The tensor-core launch for ``x (m, k)`` against G packed ``(n, k)``
    weights of ``block`` blocks keeping ``kept`` = (R_keep, C_keep), for
    each of ``experts`` stacked experts (the same plan for every expert).

    With ``genome=None`` one rule decides:

    * M tile: the smallest of 8, 16, 32, 64 that holds M, else 128.
    * At the 128 tile, the wide body (``_wg_fit``): 256 MMA rows a CTA over
      the flattened (block row, member) rows, whatever G; the 64 tile when
      it cannot run the shape.
    * Configuration (M tiles up to 64): of those compiled for the M tile,
      the one that wastes
      the fewest MMA rows on G × block rows (rows past a block row, or past
      G members, point at a zero row), then the most slabs per warp. Its
      row chunk ``n_chunk`` is a multiple of the warp's 16·slabs rows, so a
      warp reads one member's gathered x.
    * Split: when the output tiles (of every expert) number at most half
      the card's SMs, the contraction blocks of each tile are shared by
      ``splits`` CTAs so the grid reaches the SM count (at most nb_c
      splits, so none is empty); the last to finish sums the partials in
      split order.
    * Stages: one more than the blocks a CTA walks, at least 3, at most 8,
      and what shared memory holds. A smaller M tile is tried when nothing
      fits; a block no CTA can hold raises ``ValueError``.

    A launch ``short_body`` accepts (br < 16, G = 1, one unstacked pack)
    takes the short-block body instead (``body="short"``): the M tile as
    above; of the M tile's ``short_configs``, below the 128 tile the one
    with the fewest rows (16: the most CTAs, several to an SM), at the 128
    tile the one with the most rows whose grid fills over half the SMs
    unsplit, else the fewest; each the first whose plan fits
    (``_short_fit``: stage depth, split over stages, ring). A smaller M
    tile when none fits, and the body above when no short plan fits at
    all.

    A ``genome`` ``(m_tile, config, split)`` (the plan tuner's knobs,
    ``kernels/plan.py``) fixes the M tile (one of ``M_TILES``), the
    configuration (``tile_configs(m_tile)[config]``) and the split (the
    rule's own count for that grid, or none); the ring depth is derived as
    above. A genome that cannot run (a configuration that does not fit G
    members of this block, or shared memory no stage count fits) raises
    ``ValueError``: it never falls back to another plan.

    For a short-body launch the genome's ``config`` indexes
    ``short_configs(m_tile)`` instead.

    ``shards`` > 1 plans one of that many column-parallel shards of a
    weight (``kernels/plan.split_packed``): the split counts the whole
    weight's output tiles, so a shard splits its contraction as the whole
    does and sums the same partials in the same order. Nothing else the
    rule decides depends on the number of block rows.
    """
    br, bc = block
    r, c = kept
    if n % br or k % bc:
        raise ValueError(f"({n}, {k}) is not a whole number of {br}x{bc} "
                         f"blocks")
    if not (1 <= r <= br and 1 <= c <= bc) or r >= 4096:
        raise ValueError(f"kept counts {kept} do not fit a {br}x{bc} block")
    nb_r, nb_c = n // br, k // bc
    # TMA and bulk copies (vec): 16-byte multiples on 16-byte aligned
    # operands, boxes of at most 256 rows and columns; else plain loads
    vec = (aligned and k % 8 == 0 and bc % 8 == 0 and bc <= 256
           and r % 4 == 0 and c % 4 == 0
           and ((r * c) % 16 == 0 if int8_tiles
                else c % 8 == 0 and r <= 256 and c <= 256))
    if short_body(block, g, experts):
        plan = _short_plan(m, k, br, bc, r, c, nb_r, nb_c, int8_tiles,
                           aligned, sm_count, genome, shards)
        if plan is not None:
            return plan
    if genome is not None:
        mt, config, split = genome
        cfgs = tile_configs(mt)
        if not 0 <= config < len(cfgs):
            raise ValueError(f"genome {genome}: M tile {mt} has "
                             f"{len(cfgs)} configurations")
        if mt == WG_M_TILE:
            plan = _wg_fit(m, n, k, g, block, kept, nb_r, nb_c, split,
                           int8_tiles, aligned, experts, shards, sm_count)
            if plan is None:
                raise ValueError(f"genome {genome}: the 128 tile cannot run "
                                 f"G={g} members of {br}x{bc} blocks keeping "
                                 f"{r}x{c} (blocks of {WG_BC} columns, pairs "
                                 f"of at most {WG_ROWS} rows, shared memory)")
            return plan
        slabs, wm, nw = cfgs[config]
        chunking = _chunking(slabs, wm, nw, g, br)
        if chunking is None:
            raise ValueError(f"genome {genome}: configuration {cfgs[config]} "
                             f"cannot run G={g} members of {br}-row blocks "
                             f"keeping {c} columns")
        n_chunk, chunks, _ = chunking
        tiles = experts * nb_r * chunks * (-(-m // mt))
        splits = (_rule_splits(tiles * shards, nb_c, sm_count) if split
                  else 1)
        plan = _fit(mt, slabs, wm, nw, n_chunk, chunks, m, g, bc, r, c, nb_r,
                    nb_c, splits, int8_tiles, vec, experts)
        if plan is None:
            raise ValueError(f"genome {genome}: BCR block {br}x{bc} keeping "
                             f"{r}x{c} (G={g}) needs more shared memory than "
                             f"a CTA has")
        return plan
    first = next(mt for mt in M_TILES if m <= mt or mt == M_TILES[-1])
    for mt in reversed([t for t in M_TILES if t <= first]):
        if mt == WG_M_TILE:
            plan = _wg_fit(m, n, k, g, block, kept, nb_r, nb_c, True,
                           int8_tiles, aligned, experts, shards, sm_count)
            if plan is not None:
                return plan
            continue
        best = None
        for slabs, wm, nw in tile_configs(mt):
            chunking = _chunking(slabs, wm, nw, g, br)
            if chunking is None:
                continue
            n_chunk, chunks, waste = chunking
            key = (waste, -slabs)
            if best is None or key < best[0]:
                best = (key, slabs, wm, nw, n_chunk, chunks)
        if best is None:
            continue
        _, slabs, wm, nw, n_chunk, chunks = best
        tiles = experts * nb_r * chunks * (-(-m // mt))
        plan = _fit(mt, slabs, wm, nw, n_chunk, chunks, m, g, bc, r, c, nb_r,
                    nb_c, _rule_splits(tiles * shards, nb_c, sm_count),
                    int8_tiles, vec, experts)
        if plan is not None:
            return plan
    raise ValueError(f"BCR block {br}x{bc} keeping {r}x{c} (G={g}) needs "
                     f"more shared memory than a CTA has")


def _short_plan(m, k, br, bc, r, c, nb_r, nb_c, int8_tiles, aligned,
                sm_count, genome, shards) -> Optional[LaunchPlan]:
    """``launch_plan``'s short-body half: the genome's plan (or
    ``ValueError``), else the rule's, else None (no short plan fits)."""
    if genome is not None:
        mt, config, split = genome
        cfgs = short_configs(mt)
        if not 0 <= config < len(cfgs):
            raise ValueError(f"genome {genome}: M tile {mt} has {len(cfgs)} "
                             f"short-body configurations")
        plan = _short_fit(m, k, br, bc, r, c, nb_r, nb_c, mt, cfgs[config],
                          split, int8_tiles, aligned, sm_count, shards)
        if plan is None:
            raise ValueError(f"genome {genome}: short-body configuration "
                             f"{cfgs[config]} cannot run {br}x{bc} blocks "
                             f"keeping {r}x{c} (too few rows, or more shared "
                             f"memory than a CTA has)")
        return plan
    first = next(mt for mt in M_TILES if m <= mt or mt == M_TILES[-1])
    for mt in reversed([t for t in M_TILES if t <= first]):
        cfgs = sorted(short_configs(mt), key=lambda cf: cf[2])
        if mt == M_TILES[-1]:
            # prefill: the most rows whose grid fills over half the SMs
            # unsplit (each CTA's x block then feeds the most rows), else
            # the fewest
            full = [cf for cf in cfgs
                    if 2 * -(-nb_r // (cf[2] // br)) * -(-m // mt) * shards
                    > sm_count and cf[2] >= br]
            cfgs = full[::-1] + [cf for cf in cfgs if cf not in full]
        # decode: the fewest rows first (the most CTAs, small enough that
        # several share an SM and hide each other's copy latency)
        for cfg in cfgs:
            plan = _short_fit(m, k, br, bc, r, c, nb_r, nb_c, mt, cfg, True,
                              int8_tiles, aligned, sm_count, shards)
            if plan is not None:
                return plan
    return None


def _declare(lib: ctypes.CDLL) -> None:
    lib.bcr_spmm_launch.argtypes = ([_I] * 4 + [_P] * 9 + [_I] * 11
                                    + [ctypes.POINTER(ctypes.c_int), _P])
    lib.bcr_spmm_launch.restype = _I
    lib.bcr_spmm_short_launch.argtypes = ([_I] + [_P] * 8 + [_I] * 9
                                          + [ctypes.POINTER(ctypes.c_int), _P])
    lib.bcr_spmm_short_launch.restype = _I


def library() -> ctypes.CDLL:
    """This kernel's library, built first if missing, and loaded."""
    return build.load("bcr_spmm", _declare)


_SM_COUNT: Dict[int, int] = {}
_COUNTERS: Dict[int, torch.Tensor] = {}


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def split_counters(dev: torch.device, n: int) -> torch.Tensor:
    """The device's zeroed int32 split counters, at least ``n`` of them. A
    split launch's last CTA puts its counter back to 0, so the buffer is
    zero between calls; it is shared by every call on the device, which
    runs them in stream order."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    buf = _COUNTERS.get(idx)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _COUNTERS[idx] = buf
    return buf


def _check(x: torch.Tensor, packed, e: int) -> Optional[torch.Tensor]:
    """Validate a launch over ``e`` stacked experts (0: an unstacked pack);
    returns the fp32 tile scales of an int8 pack (None for the fp form)."""
    vals, row_idx, col_idx = packed.vals, packed.row_idx, packed.col_idx
    scales = getattr(packed.plan, "block_scales", None)
    if x.dim() != (3 if e else 2) or not x.is_contiguous():
        raise ValueError("x must be a contiguous (M, K) tensor, or (E, M, K) "
                         "over a pack of E stacked experts")
    if e and x.shape[0] != e:
        raise ValueError(f"x has {x.shape[0]} experts, the pack {e}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not supported (float32, bfloat16)")
    if vals.dtype == torch.int8:
        if scales is None:
            raise ValueError("int8 packed vals need plan.block_scales")
        if scales.dtype != torch.float32 \
                or tuple(scales.shape) != tuple(vals.shape[:-2]):
            raise ValueError(f"block_scales must be fp32 "
                             f"{tuple(vals.shape[:-2])}, got {scales.dtype} "
                             f"{tuple(scales.shape)}")
    elif scales is not None:
        raise TypeError(f"block_scales given with {vals.dtype} vals "
                        f"(the int8 form takes int8 codes)")
    elif vals.dtype != x.dtype:
        raise TypeError(f"packed vals dtype {vals.dtype} != x dtype {x.dtype} "
                        f"(pack_params casts vals to the activation dtype)")
    tensors = [("vals", vals), ("row_idx", row_idx), ("col_idx", col_idx)]
    if scales is not None:
        tensors.append(("block_scales", scales))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if row_idx.dtype != torch.int32 or col_idx.dtype != torch.int32:
        raise TypeError("row_idx / col_idx must be int32")
    n, k = packed.shape
    br, bc = packed.block_shape
    nb_r, nb_c, r, c = vals.shape[-4:]
    if x.shape[-1] != k:
        raise ValueError(f"x K dim {x.shape[-1]} != packed K dim {k}")
    if nb_r * br != n or nb_c * bc != k:
        raise ValueError(f"packed grid {nb_r}x{nb_c} of {br}x{bc} blocks does "
                         f"not tile ({n}, {k})")
    if (tuple(row_idx.shape) != tuple(vals.shape[:-1])
            or tuple(col_idx.shape) != tuple(vals.shape[:-2]) + (c,)):
        raise ValueError("index planes do not match the kept tile shape")
    return scales


def _launch(x, packed, scales, g, e, grouped, bias, swiglu, y,
            what) -> LaunchPlan:
    """One launch of ``bcr_spmm_launch`` (or ``bcr_spmm_short_launch``) for
    a checked (grouped) pack over ``e`` stacked experts (0: unstacked);
    returns its plan: the tensor-core plan under bf16 x, the fp32 body's
    (:func:`fp32_plan`; a tuned genome is not read) under fp32 x."""
    m, k = x.shape[-2:]
    n = packed.shape[0]
    nb_r, nb_c, r, c = packed.vals.shape[-4:]
    br, bc = packed.block_shape
    ws, counters = None, None
    if x.dtype == torch.bfloat16:
        aligned = all(t.data_ptr() % 16 == 0 for t in (
            x, packed.vals, packed.row_idx, packed.col_idx))
        plan = launch_plan(m, n, k, g, (br, bc), (r, c), _sm_count(x.device),
                           scales is not None, aligned, max(e, 1),
                           launch_genome(packed.plan, m),
                           plan_shards(packed.plan))
    else:
        plan = fp32_plan(m, n, k, g, (br, bc), (r, c), _sm_count(x.device),
                         scales is not None,
                         packed.vals.data_ptr() % 16 == 0, max(e, 1),
                         plan_shards(packed.plan))
    args = plan.args()
    plan_arr = (ctypes.c_int * len(args))(*args)
    if plan.splits > 1:
        ws = torch.empty(plan.workspace_floats, dtype=torch.float32,
                         device=x.device)
        counters = split_counters(x.device, plan.tiles)
    if plan.body == "short":
        err = library().bcr_spmm_short_launch(
            int(scales is not None), x.data_ptr(), packed.vals.data_ptr(),
            scales.data_ptr() if scales is not None else None,
            packed.row_idx.data_ptr(), packed.col_idx.data_ptr(),
            y.data_ptr(), ws.data_ptr() if ws is not None else None,
            counters.data_ptr() if counters is not None else None,
            m, k, n, nb_r, nb_c, br, bc, r, c, plan_arr,
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, what)
        return plan
    err = library().bcr_spmm_launch(
        _DTYPE_CODE[x.dtype], int(grouped), int(scales is not None),
        int(swiglu),
        x.data_ptr(), packed.vals.data_ptr(),
        scales.data_ptr() if scales is not None else None,
        packed.row_idx.data_ptr(), packed.col_idx.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        counters.data_ptr() if counters is not None else None,
        m, k, n, g, nb_r, nb_c, br, bc, r, c, max(e, 1), plan_arr,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, what)
    return plan


def _count(key: str, e: int, plan: Optional[LaunchPlan] = None) -> None:
    """One launch of form ``key`` (over ``e`` stacked experts, 0: none;
    under ``plan``, counted apart again when it ran the short body)."""
    LAUNCHES[key] += 1
    if e:
        LAUNCHES[key + "_experts"] += 1
    if plan is not None and plan.body == "short":
        LAUNCHES[key + "_short"] += 1


def bcr_spmm(x: torch.Tensor, packed) -> torch.Tensor:
    """``y[M, N] = x[M, K] @ W.T`` for balanced-BCR packed ``W`` (fp tiles,
    or int8 codes with ``plan.block_scales``); over a pack of E stacked
    experts, ``y[e] = x[e] @ W_e.T`` for x ``(E, M, K)``, one launch."""
    if not x.is_cuda:
        return ref.bcr_spmm_packed_ref(x, packed)
    e = stacked_experts(packed)
    scales = _check(x, packed, e)
    y = torch.empty((*x.shape[:-1], packed.shape[0]), dtype=x.dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    plan = _launch(x, packed, scales, 1, e, False, None, False, y,
                   "bcr_spmm launch")
    _count("bcr_spmm_int8" if scales is not None else "bcr_spmm", e, plan)
    return y


def bcr_spmm_grouped(x: torch.Tensor, grouped,
                     bias: Optional[torch.Tensor] = None,
                     epilogue: Optional[str] = None) -> torch.Tensor:
    """``y[G, M, N] = x[M, K] @ W_g.T`` for G same-shaped packed weights;
    ``bias`` ``(G, N)`` adds off the fp32 accumulator and
    ``epilogue="swiglu"`` (G=2) returns ``silu(y[0]) * y[1]`` as ``(M, N)``.
    Over E stacked experts, x ``(E, M, K)``, bias ``(E, G, N)`` and y gain
    the leading E axis, in one launch."""
    if epilogue not in (None, "swiglu"):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    g = grouped.group_size
    if epilogue == "swiglu" and g != 2:
        raise ValueError(f"swiglu epilogue needs a gate/up pair, got "
                         f"group_size={g}")
    if not x.is_cuda:
        y = ref.bcr_spmm_grouped_ref(x, grouped, bias=bias, epilogue=epilogue)
        return y if epilogue == "swiglu" else y.transpose(-3, -2)
    e = stacked_experts(grouped)
    scales = _check(x, grouped, e)
    m = x.shape[-2]
    n = grouped.shape[0]
    lead = tuple(x.shape[:-2])
    if bias is not None:
        if tuple(bias.shape) != lead + (g, n):
            raise ValueError(f"bias shape {tuple(bias.shape)} != "
                             f"{lead + (g, n)}")
        bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out_shape = lead + ((m, n) if epilogue == "swiglu" else (g, m, n))
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    _launch(x, grouped, scales, g, e, True, bias, epilogue == "swiglu", y,
            "bcr_spmm_grouped launch")
    _count("bcr_spmm_grouped_int8" if scales is not None
           else "bcr_spmm_grouped", e)
    return y
