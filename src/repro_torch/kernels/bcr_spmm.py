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

Under bf16 x both forms run on the tensor cores; :func:`launch_plan` (pure,
pinned by ``tests/test_torch_bcr_plan.py``) picks the launch: the M tile,
the warp layout, the output rows per CTA, the split of the contraction
blocks over CTAs at small M, the copy-ring depth and the shared-memory
bytes. Under fp32 x the kernel keeps its CUDA-core body (fp32 products, the
1e-4 tolerance) and sizes its own M tile.

A CUDA tensor goes through the kernel (or the wrapper raises); a CPU tensor
goes through the plain version in :mod:`repro_torch.kernels.ref`. Each
launch adds one to ``LAUNCHES[<kernel>]``, with separate keys per form
(``bcr_spmm`` / ``bcr_spmm_int8``, ``bcr_spmm_grouped`` /
``bcr_spmm_grouped_int8``). The kernels' design notes (what bounds them on
the card, and what the design does about it) head the CUDA source.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"bcr_spmm": 0, "bcr_spmm_grouped": 0, "bcr_spmm_int8": 0,
            "bcr_spmm_grouped_int8": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int

SMEM_LIMIT = 232448          # bytes of shared memory a Hopper CTA may take
MAX_STAGES = 8
# (M tile, m16 row slabs per warp, warps across the M tile, compute warps):
# the compiled tensor-core configurations. A CTA computes 16·slabs·(warps /
# warps_m) output rows (the weight's rows, the MMA's M side) by the M tile
# (the MMA's N side); one more warp issues the copies. M tiles up to 64 run
# mma.sync (a warp owns slabs × 16 rows by M tile / warps_m columns); the
# 128 tile (warps_m = 4) runs wgmma m64n128k16 (a warpgroup owns 64 rows by
# all 128 columns), which needs C_keep <= 64 (one 128-byte swizzled row of
# K).
WGMMA_WARPS_M = 4
CONFIGS = ((8, 1, 1, 8), (8, 2, 1, 8), (16, 1, 1, 8), (16, 2, 1, 8),
           (32, 1, 1, 8), (32, 2, 1, 8), (64, 2, 2, 8), (128, 4, 4, 8))
M_TILES = (8, 16, 32, 64, 128)


def _up(v: int, q: int) -> int:
    return -(-v // q) * q


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One tensor-core launch. The grid is ``nb_r · chunks · m_tiles ·
    splits`` CTAs; CTA (block row i, row chunk, M tile, split s) computes
    output rows ``[chunk·n_chunk, (chunk+1)·n_chunk)`` of block row i for
    every member, over contraction blocks ``[s·nb_c/S, (s+1)·nb_c/S)``."""
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

    @property
    def rows(self) -> int:
        """MMA rows one CTA computes (all members together)."""
        return 16 * self.slabs * (self.warps // self.warps_m)

    @property
    def grid(self) -> int:
        return self.nb_r * self.chunks * self.m_tiles * self.splits

    @property
    def tiles(self) -> int:
        """Output tiles: one split counter each."""
        return self.nb_r * self.chunks * self.m_tiles

    @property
    def workspace_floats(self) -> int:
        """fp32 partials of a split launch (0 when unsplit)."""
        if self.splits == 1:
            return 0
        return (self.tiles * self.splits * self.group * self.m_tile
                * self.n_chunk)

    def args(self) -> Tuple[int, ...]:
        """The order ``bcr_spmm_launch`` reads its plan array in."""
        return (self.m_tile, self.slabs, self.warps_m, self.n_chunk,
                self.chunks, self.splits, self.stages, int(self.vec),
                self.smem_bytes)


def smem_layout(m_tile: int, n_chunk: int, stages: int, g: int, bc: int,
                r: int, c: int, int8_tiles: bool, vec: bool, wgmma: bool,
                blocks: int) -> int:
    """Shared-memory bytes of one CTA; the CUDA launcher computes the same
    layout (``Layout`` in the source) and refuses a plan that disagrees.

    Per ring stage (1024-byte aligned): the kept tiles (bf16 rows dense as
    TMA copies them, or padded to ``Cp + 8`` elements on the plain-load
    path, ``Cp`` = C_keep rounded up to 16; int8 codes flat, 16-byte aligned
    per member), the x block (M tile × bc bf16), the row and column indices.
    Then two gathered-x buffers (G × M tile rows of ``Cp + 8`` elements, or
    of 128 swizzled bytes for the wgmma tile), two widened int8 tile
    buffers (int8 form), the fp32 epilogue tile (aliasing the ring), two
    inverse row maps, a zero row, a flag, one mbarrier per stage, the int8
    tile scales of the CTA's ``blocks`` contraction blocks and 1024 bytes of
    alignment slack."""
    cp = _up(c, 16)
    row = (cp + 8) * 2
    ts = c * 2 if vec and not int8_tiles else row
    member = _up(r * c, 16) if int8_tiles else r * ts
    off_cidx = (_up(g * member, 128) + _up(m_tile * bc * 2, 128)
                + _up(g * r * 4, 16))
    slot = _up(off_cidx + _up(g * c * 4, 16), 1024)
    main = stages * slot + 2 * g * m_tile * (128 if wgmma else row)
    if int8_tiles:
        main += 2 * g * r * row
    red = g * m_tile * (n_chunk + 4) * 4
    scales = _up(blocks * g * 4, 16) if int8_tiles else 0
    return (max(main, red) + _up(2 * g * n_chunk * 4, 16) + _up(row, 16)
            + 16 + _up(stages * 8, 16) + scales + 1024)


@functools.lru_cache(maxsize=1024)
def launch_plan(m: int, n: int, k: int, g: int, block: Tuple[int, int],
                kept: Tuple[int, int], sm_count: int,
                int8_tiles: bool = False, aligned: bool = True) -> LaunchPlan:
    """The tensor-core launch for ``x (m, k)`` against G packed ``(n, k)``
    weights of ``block`` blocks keeping ``kept`` = (R_keep, C_keep).

    * M tile: the smallest of 8, 16, 32, 64 that holds M, else 128.
    * Configuration: of those compiled for the M tile, the one that wastes
      the fewest MMA rows on G × block rows (rows past a block row, or past
      G members, point at a zero row), then the most slabs per warp. Its
      row chunk ``n_chunk`` is a multiple of the warp's 16·slabs rows, so a
      warp reads one member's gathered x.
    * Split: when the output tiles number at most half the card's SMs, the
      contraction blocks of each tile are shared by ``splits`` CTAs so the
      grid reaches the SM count (at most nb_c splits, so none is empty); the
      last to finish sums the partials in split order.
    * Stages: one more than the blocks a CTA walks, at least 3, at most 8,
      and what shared memory holds. A smaller M tile is tried when nothing
      fits; a block no CTA can hold raises ``ValueError``.
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
    first = next(mt for mt in M_TILES if m <= mt or mt == M_TILES[-1])
    for mt in reversed([t for t in M_TILES if t <= first]):
        best = None
        for cmt, slabs, wm, nw in CONFIGS:
            if cmt != mt or (wm == WGMMA_WARPS_M and c > 64):
                continue
            rows = 16 * slabs * (nw // wm)
            q = 16 * slabs
            n_chunk = min(_up(br, q), (rows // g) // q * q)
            if n_chunk < q:
                continue
            chunks = -(-br // n_chunk)
            waste = chunks * rows - g * br
            key = (waste, -slabs)
            if best is None or key < best[0]:
                best = (key, slabs, wm, nw, n_chunk, chunks)
        if best is None:
            continue
        _, slabs, wm, nw, n_chunk, chunks = best
        m_tiles = -(-m // mt)
        tiles = nb_r * chunks * m_tiles
        # split where it at least doubles the grid (a nearly full grid
        # gains less than the partials' round trip costs)
        splits = (1 if 2 * tiles > sm_count
                  else min(nb_c, -(-sm_count // tiles)))
        blocks = -(-nb_c // splits)
        for stages in range(min(MAX_STAGES, max(3, blocks + 1)), 2, -1):
            smem = smem_layout(mt, n_chunk, stages, g, bc, r, c, int8_tiles,
                               vec, wm == WGMMA_WARPS_M, blocks)
            if smem <= SMEM_LIMIT:
                return LaunchPlan(mt, slabs, wm, nw, n_chunk, chunks, m_tiles,
                                  splits, stages, vec, smem, nb_r, nb_c, g)
    raise ValueError(f"BCR block {br}x{bc} keeping {r}x{c} (G={g}) needs "
                     f"more shared memory than a CTA has")


def _declare(lib: ctypes.CDLL) -> None:
    lib.bcr_spmm_launch.argtypes = ([_I] * 4 + [_P] * 9 + [_I] * 10
                                    + [ctypes.POINTER(ctypes.c_int), _P])
    lib.bcr_spmm_launch.restype = _I


def _lib() -> ctypes.CDLL:
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


def _check(x: torch.Tensor, packed) -> Optional[torch.Tensor]:
    """Validate a launch; returns the fp32 tile scales of an int8 pack
    (None for the fp form)."""
    vals, row_idx, col_idx = packed.vals, packed.row_idx, packed.col_idx
    scales = getattr(packed.plan, "block_scales", None)
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (M, K) tensor")
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
    if x.shape[1] != k:
        raise ValueError(f"x K dim {x.shape[1]} != packed K dim {k}")
    if nb_r * br != n or nb_c * bc != k:
        raise ValueError(f"packed grid {nb_r}x{nb_c} of {br}x{bc} blocks does "
                         f"not tile ({n}, {k})")
    if row_idx.shape[-1] != r or col_idx.shape[-1] != c:
        raise ValueError("index planes do not match the kept tile shape")
    return scales


def _launch(x, packed, scales, g, grouped, bias, swiglu, y, what) -> None:
    """One launch of ``bcr_spmm_launch`` for a checked (grouped) pack."""
    m, k = x.shape
    n = packed.shape[0]
    nb_r, nb_c, r, c = packed.vals.shape[-4:]
    br, bc = packed.block_shape
    plan_arr, ws, counters = None, None, None
    if x.dtype == torch.bfloat16:
        aligned = all(t.data_ptr() % 16 == 0 for t in (
            x, packed.vals, packed.row_idx, packed.col_idx))
        plan = launch_plan(m, n, k, g, (br, bc), (r, c), _sm_count(x.device),
                           scales is not None, aligned)
        plan_arr = (ctypes.c_int * 9)(*plan.args())
        if plan.splits > 1:
            ws = torch.empty(plan.workspace_floats, dtype=torch.float32,
                             device=x.device)
            counters = split_counters(x.device, plan.tiles)
    err = _lib().bcr_spmm_launch(
        _DTYPE_CODE[x.dtype], int(grouped), int(scales is not None),
        int(swiglu),
        x.data_ptr(), packed.vals.data_ptr(),
        scales.data_ptr() if scales is not None else None,
        packed.row_idx.data_ptr(), packed.col_idx.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        counters.data_ptr() if counters is not None else None,
        m, k, n, g, nb_r, nb_c, br, bc, r, c, plan_arr,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, what)


def bcr_spmm(x: torch.Tensor, packed) -> torch.Tensor:
    """``y[M, N] = x[M, K] @ W.T`` for balanced-BCR packed ``W`` (fp tiles,
    or int8 codes with ``plan.block_scales``)."""
    if not x.is_cuda:
        return ref.bcr_spmm_packed_ref(x, packed)
    scales = _check(x, packed)
    m, _ = x.shape
    y = torch.empty((m, packed.shape[0]), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    _launch(x, packed, scales, 1, False, None, False, y, "bcr_spmm launch")
    LAUNCHES["bcr_spmm_int8" if scales is not None else "bcr_spmm"] += 1
    return y


def bcr_spmm_grouped(x: torch.Tensor, grouped,
                     bias: Optional[torch.Tensor] = None,
                     epilogue: Optional[str] = None) -> torch.Tensor:
    """``y[G, M, N] = x[M, K] @ W_g.T`` for G same-shaped packed weights;
    ``bias`` ``(G, N)`` adds off the fp32 accumulator and
    ``epilogue="swiglu"`` (G=2) returns ``silu(y[0]) * y[1]`` as ``(M, N)``."""
    if epilogue not in (None, "swiglu"):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    g = grouped.group_size
    if epilogue == "swiglu" and g != 2:
        raise ValueError(f"swiglu epilogue needs a gate/up pair, got "
                         f"group_size={g}")
    if not x.is_cuda:
        y = ref.bcr_spmm_grouped_ref(x, grouped, bias=bias, epilogue=epilogue)
        return y if epilogue == "swiglu" else y.transpose(0, 1)
    scales = _check(x, grouped)
    m, _ = x.shape
    n = grouped.shape[0]
    if bias is not None:
        if tuple(bias.shape) != (g, n):
            raise ValueError(f"bias shape {tuple(bias.shape)} != {(g, n)}")
        bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out_shape = (m, n) if epilogue == "swiglu" else (g, m, n)
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    _launch(x, grouped, scales, g, True, bias, epilogue == "swiglu", y,
            "bcr_spmm_grouped launch")
    LAUNCHES["bcr_spmm_grouped_int8" if scales is not None
             else "bcr_spmm_grouped"] += 1
    return y
