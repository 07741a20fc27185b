"""Flash attention over a block-paged KV pool: the hand-written CUDA kernel of
``csrc/paged_attention.cu`` behind two entry points.

Replaces the reference's TPU kernel
``kernels/paged_decode_attention.py:_paged_attention`` (body ``_kernel``).
ONE kernel body serves both entry points, as in the reference:

* :func:`paged_decode_attention` — the decode hot loop: one query row per
  slot (``S = 1``) at position ``cache_len - 1``;
* :func:`paged_prefill_append_attention` — an ``S``-row suffix per slot
  whose row ``i`` sits at ``prefix_len + i`` and attends to every cached
  page position ``<= prefix_len + i``. The suffix K/V must already be in the
  slot's pages.

K/V live in a shared pool ``(n_pages, page_size, Hkv, D)``; each slot's block
table maps its logical pages to physical ones, and the kernel walks only a
slot's live pages. Two forms: fp pages (q is cast to the pool's dtype, as
the plain version does), and int8 pages with per-row, per-kv-head fp32
``k_scale``/``v_scale`` pools ``(n_pages, page_size, Hkv)``, where q stays
in its own floating dtype, as in the reference's kernel.

Which body runs (:func:`paged_body`, one of three): bf16 q over bf16 or
int8 pages at head_dim 16, 32, 64 or 128 and page sizes that are multiples
of 16 runs on the tensor cores; fp32 q over fp32 or int8 pages at those
head dims runs the fp32 body (FFMA on the CUDA cores, rounds of 32 keys,
register-tiled logits; its configurations in ``F32_CONFIGS``); every other
shape runs the CUDA-core body of the first port. Each takes the launch of
:func:`launch_plan` (pure, pinned by ``tests/test_torch_paged_plan.py``):
the query rows a CTA owns and a split of each slot's pages over CTAs
(:func:`paged_plan`), merged in split order inside the one launch.

A CUDA tensor goes through the kernel (or the wrapper raises); a CPU tensor
goes through the plain version in :mod:`repro_torch.kernels.ref`. Each
launch adds one to ``LAUNCHES["paged_attention"]`` (fp pages) or
``LAUNCHES["paged_attention_int8"]``; a launch through the prefill-append
entry point also adds one to ``LAUNCHES["paged_attention_append"]`` or
``LAUNCHES["paged_attention_int8_append"]``, and a launch of the fp32 body
one to ``LAUNCHES["paged_attention_f32"]``, which count those apart.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.bcr_spmm import _sm_count, split_counters

LAUNCHES = {"paged_attention": 0, "paged_attention_int8": 0,
            "paged_attention_append": 0, "paged_attention_int8_append": 0,
            "paged_attention_f32": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BODY_CODE = {"cuda_core": 0, "tc": 1, "f32": 2}
_P, _I = ctypes.c_void_p, ctypes.c_int

SMEM_LIMIT = 232448          # bytes of shared memory a Hopper CTA may take
TC_HEAD_DIMS = (16, 32, 64, 128)
TC_ROW_TILES = (16, 32, 64)  # 1, 2 or 4 slabs of 16 query rows
F32_HEAD_DIMS = (16, 32, 64, 128)
SPLIT_KEYS = 1024            # most cached positions one CTA walks
MIN_SPLIT_KEYS = 128         # fewest a split made to fill the card takes
# the fp32 body's split: enough CTAs to fill F32_FILL_PER_SM an SM, none
# over fewer than F32_MIN_SPLIT_KEYS positions nor more than F32_SPLIT_KEYS
# (there the heaviest CTA's products set the time)
F32_SPLIT_KEYS, F32_MIN_SPLIT_KEYS, F32_FILL_PER_SM = 256, 64, 4


def tensor_core_body(q_dtype: torch.dtype, page_dtype: torch.dtype,
                     head_dim: int, page_size: int,
                     aligned: bool = True) -> bool:
    """The rule for the tensor-core body: bf16 q (over fp pages, q takes the
    pool's dtype first) over bf16 or int8 pages, a head_dim of
    ``TC_HEAD_DIMS`` (k16 steps and 16-byte rows), a page size that is a
    multiple of 16 (a 16-key chunk never crosses a page), and 16-byte
    aligned q and pages."""
    return (q_dtype == torch.bfloat16
            and page_dtype in (torch.bfloat16, torch.int8)
            and head_dim in TC_HEAD_DIMS and page_size % 16 == 0 and aligned)


def paged_body(q_dtype: torch.dtype, page_dtype: torch.dtype, head_dim: int,
               page_size: int, aligned: bool = True) -> str:
    """Which of the three bodies runs a launch: ``"tc"`` where
    :func:`tensor_core_body` holds; ``"f32"`` for fp32 q over fp32 or int8
    pages at a head_dim of ``F32_HEAD_DIMS`` (16-byte rows of both), any
    page size (each round gathers its keys row by row) and 16-byte aligned
    q and pages; ``"cuda_core"`` for everything else (odd head dims,
    unaligned tensors, bf16 q at head dims or page sizes the tensor-core
    body does not take)."""
    if tensor_core_body(q_dtype, page_dtype, head_dim, page_size, aligned):
        return "tc"
    if (q_dtype == torch.float32
            and page_dtype in (torch.float32, torch.int8)
            and head_dim in F32_HEAD_DIMS and aligned):
        return "f32"
    return "cuda_core"


@dataclasses.dataclass(frozen=True)
class F32Config:
    """One configuration of the fp32 body (``f32::Cfg`` in the source):
    ``row_tile`` query rows a CTA, ``warps`` warps of which ``key_warps``
    split each round's ``keys`` keys (each warp its own chunk, merged in
    warp order at the end) and the rest the rows; ``lane_rows`` x
    ``lane_keys`` lanes of a warp over its rows x keys for the logits (the
    other lanes split head_dim); ``stages`` ring stages."""
    row_tile: int
    warps: int
    key_warps: int
    keys: int
    lane_rows: int
    lane_keys: int
    stages: int

    def smem_bytes(self, head_dim: int, int8: bool, pps: int) -> int:
        """``f32::Layout``'s bytes plus the split's table and flag: the Q
        tile and each round's K rows padded to head_dim + 4 floats; the ring
        (fp32: K and V rows; int8: codes and scales, plus the round widened
        to fp32 K and V tiles), or the warps' merge if larger; each warp's
        P tile (rows x (keys + 4)) and its rows' rescale factors."""
        d, keys, rt = head_dim, self.keys, self.row_tile
        ldk = d + 4
        rows_w = rt * self.key_warps // self.warps
        kt, vt = keys * ldk * 4, keys * d * 4
        stage = 2 * keys * d + 8 * keys if int8 else kt + vt
        ring = self.stages * stage + (kt + vt if int8 else 0)
        merge = (self.key_warps * rt * ldk + 3 * self.key_warps * rt) * 4
        warp_bufs = self.warps * rows_w * (keys // self.key_warps + 4 + 1) * 4
        return rt * ldk * 4 + max(ring, merge) + warp_bufs + 4 * (pps + 1)


# decode (up to 4 rows: G of one kv-head; the 4 warps split each round's
# keys), verify and short suffixes (up to 16 rows), prefill-append (64 rows,
# two lanes a dot; two CTAs an SM at head_dim 128); 4 x 4 logits a lane but
# at decode; the source's f32::Decode, Short and Rows
F32_CONFIGS = (F32Config(4, 4, 4, 32, 1, 8, 3),
               F32Config(16, 4, 1, 32, 1, 8, 3),
               F32Config(64, 8, 1, 32, 2, 8, 2))


def f32_config(rows: int) -> F32Config:
    """The fp32 body's configuration for ``rows`` = S·G query rows of a
    (slot, kv-head): the smallest row tile that holds them, else the
    largest (several row tiles)."""
    return next((c for c in F32_CONFIGS if c.row_tile >= rows),
                F32_CONFIGS[-1])


def cuda_core_smem_bytes(d: int, page_size: int, row_tile: int) -> int:
    """Shared memory of the CUDA-core body (``cuda_core::smem_words`` in the
    source): q tile, padded K page, V page, logits, accumulator, per-row
    statistics, the page's scales and the split's flag."""
    return 4 * (row_tile * d + page_size * (d + 1) + page_size * d
                + row_tile * page_size + row_tile * d + 3 * row_tile
                + 2 * page_size + 1)


def cuda_core_row_tile(rows: int, d: int, page_size: int) -> int:
    """The CUDA-core body's query rows per CTA: up to 64, halved until its
    shared memory fits a CTA."""
    rt = min(64, max(rows, 1))
    while cuda_core_smem_bytes(d, page_size, rt) > SMEM_LIMIT:
        if rt == 1:
            raise ValueError(f"page_size {page_size} x head_dim {d} needs "
                             f"more shared memory than a CTA has")
        rt = max(1, rt // 2)
    return rt


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """One launch. The grid is ``units × splits`` CTAs: CTA (unit, s) serves
    query rows ``[t·row_tile, (t+1)·row_tile)`` of one (slot, kv-head) over
    the slot's pages ``[s·pages_per_split, (s+1)·pages_per_split)`` that are
    live; a unit with more than one live split merges their partials in
    split order (one int32 counter a unit)."""
    row_tile: int
    row_tiles: int
    units: int
    pages_per_split: int
    splits: int

    @property
    def grid(self) -> int:
        return self.units * self.splits

    def workspace_floats(self, head_dim: int) -> int:
        """fp32 partials (acc, then m and l) of a split launch; 0 unsplit."""
        if self.splits == 1:
            return 0
        return self.units * self.splits * self.row_tile * (head_dim + 2)


def paged_plan(b: int, hkv: int, rows: int, n_cols: int, page_size: int,
               sm_count: int, row_tile: int | None = None,
               head_shards: int = 1, split_keys: int = SPLIT_KEYS,
               min_split_keys: int = MIN_SPLIT_KEYS,
               fill_ctas: int | None = None) -> PagedPlan:
    """The launch for ``b`` slots of ``hkv`` kv-heads, ``rows`` = S·G query
    rows each, over block tables ``n_cols`` pages wide. It reads only what
    the host has — never the device lengths — so it depends on the table
    width and not on the slots' lengths.

    * Row tile: ``row_tile`` when given (the CUDA-core body's, from
      :func:`cuda_core_row_tile`, or the fp32 body's, from
      :func:`f32_config`); else the tensor-core body's: of 16, 32
      and 64 rows (up to ``rows`` rounded up to 16), the largest whose
      units (slot × kv-head × row tile) still reach the SM count, else 16.
      Fewer rows a CTA re-read the pages from L2 more often; more CTAs keep
      more SMs streaming.
    * Split: where the units number at most half of ``fill_ctas`` (the
      SM count unless given), the pages of each unit are shared by enough
      CTAs to reach it (the rule of ``bcr_spmm.launch_plan``: a split that
      would not at least double the grid gains less than the partials'
      round trip costs), but no split gets fewer than ``min_split_keys``
      positions of the table; and wherever the table holds more than
      ``split_keys`` positions, enough splits that no CTA walks more than
      about that many (a CTA's walk is a chain of memory latencies). The
      fp32 body gives its own three numbers (``F32_*``): there the
      heaviest CTA's products set the time, so it fills several CTAs an
      SM over shorter splits. At most ``n_cols`` splits, so
      none is empty by construction; splits past a short slot's live pages
      return at once on the card.

    ``head_shards`` > 1 plans one of that many head-parallel shards of the
    pool (tensor-parallel serving, ``hkv`` the shard's own kv-heads): the
    row tile and the split are decided for the whole pool's ``hkv ·
    head_shards`` heads, so a shard merges the same partials in the same
    order as the whole would; only its units are its own.
    """
    whole = b * hkv * head_shards
    if row_tile is None:
        top = max(TC_ROW_TILES[0], -(-rows // 16) * 16)
        tiles = [t for t in TC_ROW_TILES if t <= top]
        row_tile = next((t for t in reversed(tiles)
                         if whole * -(-rows // t) >= sm_count), tiles[0])
    row_tiles = max(1, -(-rows // row_tile))
    units = b * hkv * row_tiles
    whole_units = whole * row_tiles
    keys = n_cols * page_size
    target = sm_count if fill_ctas is None else fill_ctas
    fill = (1 if 2 * whole_units > target
            else min(-(-target // whole_units),
                     max(1, keys // min_split_keys)))
    want = max(1, min(n_cols, max(fill, -(-keys // split_keys))))
    pps = max(1, -(-n_cols // want))
    while pps > 1 and -(-n_cols // pps) < want:   # at least `want` splits
        pps -= 1
    return PagedPlan(row_tile, row_tiles, units, pps,
                     max(1, -(-n_cols // pps)))


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """A launch: its body (:func:`paged_body`), the grid (:class:`PagedPlan`)
    and, for the fp32 body, its configuration and shared-memory bytes."""
    body: str
    plan: PagedPlan
    f32: F32Config | None = None
    smem_bytes: int = 0


def launch_plan(q_dtype: torch.dtype, page_dtype: torch.dtype, b: int,
                hkv: int, rows: int, n_cols: int, page_size: int,
                head_dim: int, sm_count: int, aligned: bool = True,
                head_shards: int = 1) -> LaunchPlan:
    """The body and the launch of one call (pure: shapes and dtypes only):
    the tensor-core body's row tile from :func:`paged_plan`, the CUDA-core
    body's from :func:`cuda_core_row_tile`, the fp32 body's from
    :func:`f32_config` with the fp32 body's split."""
    body = paged_body(q_dtype, page_dtype, head_dim, page_size, aligned)
    if body == "tc":
        return LaunchPlan(body, paged_plan(b, hkv, rows, n_cols, page_size,
                                           sm_count,
                                           head_shards=head_shards))
    if body == "cuda_core":
        return LaunchPlan(body, paged_plan(
            b, hkv, rows, n_cols, page_size, sm_count,
            row_tile=cuda_core_row_tile(rows, head_dim, page_size),
            head_shards=head_shards))
    cfg = f32_config(rows)
    plan = paged_plan(b, hkv, rows, n_cols, page_size, sm_count,
                      row_tile=cfg.row_tile, head_shards=head_shards,
                      split_keys=F32_SPLIT_KEYS,
                      min_split_keys=F32_MIN_SPLIT_KEYS,
                      fill_ctas=F32_FILL_PER_SM * sm_count)
    return LaunchPlan(body, plan, cfg, cfg.smem_bytes(
        head_dim, page_dtype == torch.int8, plan.pages_per_split))


def _declare(lib: ctypes.CDLL) -> None:
    lib.paged_attention_launch.argtypes = ([_I] * 3 + [_P] * 11 + [_I] * 15
                                           + [ctypes.c_float, _P])
    lib.paged_attention_launch.restype = _I


def library() -> ctypes.CDLL:
    """This kernel's library, built first if missing, and loaded."""
    return build.load("paged_attention", _declare)


def _paged_attention(q, k_pages, v_pages, block_tables, prefix_len,
                     total_len, k_scale=None, v_scale=None,
                     append=False, head_shards=1) -> torch.Tensor:
    """Kernel launch: q (B, S, H, D), row ``i`` of slot ``b`` at absolute
    position ``prefix_len[b] + i`` (``prefix_len`` None: ``total_len[b] -
    S + i``, the slot's last S positions), over table pages covering
    ``[0, total_len[b])``. Returns (B, S, H, D) in q's dtype. Over fp pages
    q is cast to the pool's dtype first, as the plain version does; over
    int8 pages (``k_scale``/``v_scale`` given) it stays as it is."""
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("q must be (B, S, H, D) and pages (n_pages, "
                         "page_size, Hkv, D)")
    if k_pages.shape != v_pages.shape or k_pages.dtype != v_pages.dtype:
        raise ValueError("k_pages and v_pages must match in shape and dtype")
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise ValueError("int8 pages need k_scale and v_scale; fp pages take "
                         "neither")
    if not quant and k_pages.dtype not in _DTYPE_CODE:
        raise TypeError(f"page dtype {k_pages.dtype} not supported "
                        f"(float32, bfloat16, int8)")
    if quant and q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, "
                        f"bfloat16)")
    b, s, h, d = q.shape
    _, page_size, hkv, dk = k_pages.shape
    if dk != d or h % hkv:
        raise ValueError(f"q heads {h} / head_dim {d} do not fit pages "
                         f"(Hkv {hkv}, D {dk})")
    tensors = [("k_pages", k_pages), ("v_pages", v_pages),
               ("block_tables", block_tables)]
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 \
                    or tuple(t.shape) != tuple(k_pages.shape[:3]):
                raise ValueError(f"{name} must be fp32 "
                                 f"{tuple(k_pages.shape[:3])}")
            tensors.append((name, t))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != b:
        raise ValueError("block_tables must be int32 (B, n_cols)")
    tlen = total_len.to(device=q.device, dtype=torch.int32).contiguous()
    plen = (None if prefix_len is None else
            prefix_len.to(device=q.device, dtype=torch.int32).contiguous())
    if tlen.shape != (b,) or (plen is not None and plen.shape != (b,)):
        raise ValueError("prefix_len / total_len must be (B,)")
    qc = (q if quant else q.to(k_pages.dtype)).contiguous()
    out = torch.empty_like(qc)
    if b == 0 or s == 0:
        return out.to(q.dtype)
    n_cols = block_tables.shape[1]
    rows = s * (h // hkv)
    lp = launch_plan(qc.dtype, k_pages.dtype, b, hkv, rows, n_cols,
                     page_size, d, _sm_count(q.device), aligned=all(
                         t.data_ptr() % 16 == 0
                         for t in (qc, k_pages, v_pages)),
                     head_shards=head_shards)
    plan, cfg = lp.plan, lp.f32
    ws = counters = None
    if plan.splits > 1:
        ws = torch.empty(plan.workspace_floats(d), dtype=torch.float32,
                         device=q.device)
        counters = split_counters(q.device, plan.units)
    err = library().paged_attention_launch(
        _DTYPE_CODE[qc.dtype], int(quant), _BODY_CODE[lp.body],
        qc.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, block_tables.data_ptr(),
        plen.data_ptr() if plen is not None else None, tlen.data_ptr(),
        out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        counters.data_ptr() if counters is not None else None, b, s, h, hkv,
        d, page_size, n_cols, plan.row_tile, plan.row_tiles,
        plan.pages_per_split, plan.splits, cfg.keys if cfg else 0,
        cfg.stages if cfg else 0, cfg.warps if cfg else 0, lp.smem_bytes,
        float(d ** -0.5), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, f"paged_attention launch ({lp.body} body)")
    key = "paged_attention_int8" if quant else "paged_attention"
    LAUNCHES[key] += 1
    if append:
        LAUNCHES[key + "_append"] += 1
    if lp.body == "f32":
        LAUNCHES["paged_attention_f32"] += 1
    return out.to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           cache_len: torch.Tensor, *, k_scale=None,
                           v_scale=None, head_shards: int = 1
                           ) -> torch.Tensor:
    """Single-step attention against each slot's live pages only.

    q ``(B, 1, H, D)``; ``cache_len`` ``(B,)`` counts valid positions
    including the step's new token; ``k_scale``/``v_scale`` are the scale
    pools of int8 pages; ``head_shards`` the head-parallel shards the pool
    is one of (:func:`paged_plan`). Returns ``(B, 1, H, D)``."""
    if q.shape[1] != 1:
        raise ValueError("paged_decode_attention is a single-step kernel")
    if not q.is_cuda:
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_tables, cache_len,
                                              k_scale=k_scale,
                                              v_scale=v_scale)
    return _paged_attention(q, k_pages, v_pages, block_tables, None,
                            cache_len, k_scale, v_scale,
                            head_shards=head_shards)


def paged_prefill_append_attention(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   prefix_len: torch.Tensor,
                                   total_len: torch.Tensor, *, k_scale=None,
                                   v_scale=None, head_shards: int = 1
                                   ) -> torch.Tensor:
    """Prefill-append: the uncached suffix attends to cached prefix pages
    (decode is the S=1, prefix_len=cache_len-1 case). Rows at/past a slot's
    true suffix length are garbage the caller discards. Returns
    ``(B, S, H, D)``."""
    if not q.is_cuda:
        return ref.paged_prefill_append_ref(q, k_pages, v_pages, block_tables,
                                            prefix_len, total_len,
                                            k_scale=k_scale, v_scale=v_scale)
    return _paged_attention(q, k_pages, v_pages, block_tables, prefix_len,
                            total_len, k_scale, v_scale, append=True,
                            head_shards=head_shards)


def paged_kv_bytes(cache_len, page_size: int, hkv: int, d: int,
                   dtype_bytes: int = 2, scale_bytes: int = 0) -> int:
    """Device-memory bytes the kernel reads per layer per step: each slot's
    live pages, K + V. ``cache_len`` counts valid positions including the
    step's new token; ``dtype_bytes`` is the pool element's itemsize (1
    under int8); ``scale_bytes`` the sibling scale pool's itemsize (4 for
    the int8 form's fp32 scales, one per page row per kv head; 0 for fp
    pages)."""
    lens = np.maximum(np.asarray(cache_len), 0)
    pages = np.maximum(-(-lens // page_size), 1) * (lens > 0)
    row_bytes = hkv * (d * dtype_bytes + scale_bytes)
    return int(pages.sum()) * page_size * row_bytes * 2
