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

Which body runs (:func:`tensor_core_body`): bf16 q over bf16 or int8 pages
at head_dim 16, 32, 64 or 128 and page sizes that are multiples of 16 runs
on the tensor cores; every other shape runs the CUDA-core body. Both take
the launch of :func:`paged_plan` (pure, pinned by
``tests/test_torch_paged_plan.py``): the query rows a CTA owns and a split
of each slot's pages over CTAs, merged in split order inside the one
launch.

A CUDA tensor goes through the kernel (or the wrapper raises); a CPU tensor
goes through the plain version in :mod:`repro_torch.kernels.ref`. Each
launch adds one to ``LAUNCHES["paged_attention"]`` (fp pages) or
``LAUNCHES["paged_attention_int8"]``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.bcr_spmm import _sm_count, split_counters

LAUNCHES = {"paged_attention": 0, "paged_attention_int8": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int

SMEM_LIMIT = 232448          # bytes of shared memory a Hopper CTA may take
TC_HEAD_DIMS = (16, 32, 64, 128)
TC_ROW_TILES = (16, 32, 64)  # 1, 2 or 4 slabs of 16 query rows
SPLIT_KEYS = 1024            # most cached positions one CTA walks
MIN_SPLIT_KEYS = 128         # fewest a split made to fill the card takes


def tensor_core_body(q_dtype: torch.dtype, page_dtype: torch.dtype,
                     head_dim: int, page_size: int,
                     aligned: bool = True) -> bool:
    """The rule for the tensor-core body: bf16 q (over fp pages, q takes the
    pool's dtype first) over bf16 or int8 pages, a head_dim of
    ``TC_HEAD_DIMS`` (k16 steps and 16-byte rows), a page size that is a
    multiple of 16 (a 16-key chunk never crosses a page), and 16-byte
    aligned q and pages. Anything else runs the CUDA-core body."""
    return (q_dtype == torch.bfloat16
            and page_dtype in (torch.bfloat16, torch.int8)
            and head_dim in TC_HEAD_DIMS and page_size % 16 == 0 and aligned)


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
               sm_count: int, row_tile: int | None = None) -> PagedPlan:
    """The launch for ``b`` slots of ``hkv`` kv-heads, ``rows`` = S·G query
    rows each, over block tables ``n_cols`` pages wide. It reads only what
    the host has — never the device lengths — so it depends on the table
    width and not on the slots' lengths.

    * Row tile: ``row_tile`` when given (the CUDA-core body's, from
      :func:`cuda_core_row_tile`); else the tensor-core body's: of 16, 32
      and 64 rows (up to ``rows`` rounded up to 16), the largest whose
      units (slot × kv-head × row tile) still reach the SM count, else 16.
      Fewer rows a CTA re-read the pages from L2 more often; more CTAs keep
      more SMs streaming.
    * Split: where the units number at most half the card's SMs, the pages
      of each unit are shared by enough CTAs to reach the SM count (the
      rule of ``bcr_spmm.launch_plan``: a split that would not at least
      double the grid gains less than the partials' round trip costs), but
      no split gets fewer than ``MIN_SPLIT_KEYS`` positions of the table;
      and wherever the table holds more than ``SPLIT_KEYS`` positions,
      enough splits that no CTA walks more than about that many (a CTA's
      walk is a chain of memory latencies). At most ``n_cols`` splits, so
      none is empty by construction; splits past a short slot's live pages
      return at once on the card.
    """
    if row_tile is None:
        top = max(TC_ROW_TILES[0], -(-rows // 16) * 16)
        tiles = [t for t in TC_ROW_TILES if t <= top]
        row_tile = next((t for t in reversed(tiles)
                         if b * hkv * -(-rows // t) >= sm_count), tiles[0])
    row_tiles = max(1, -(-rows // row_tile))
    units = b * hkv * row_tiles
    keys = n_cols * page_size
    fill = (1 if 2 * units > sm_count
            else min(-(-sm_count // units), max(1, keys // MIN_SPLIT_KEYS)))
    want = max(1, min(n_cols, max(fill, -(-keys // SPLIT_KEYS))))
    pps = max(1, -(-n_cols // want))
    while pps > 1 and -(-n_cols // pps) < want:   # at least `want` splits
        pps -= 1
    return PagedPlan(row_tile, row_tiles, units, pps,
                     max(1, -(-n_cols // pps)))


def _declare(lib: ctypes.CDLL) -> None:
    lib.paged_attention_launch.argtypes = ([_I] * 3 + [_P] * 11 + [_I] * 11
                                           + [ctypes.c_float, _P])
    lib.paged_attention_launch.restype = _I


def _paged_attention(q, k_pages, v_pages, block_tables, prefix_len,
                     total_len, k_scale=None, v_scale=None) -> torch.Tensor:
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
    tc = tensor_core_body(qc.dtype, k_pages.dtype, d, page_size, aligned=all(
        t.data_ptr() % 16 == 0 for t in (qc, k_pages, v_pages)))
    plan = paged_plan(b, hkv, rows, n_cols, page_size, _sm_count(q.device),
                      row_tile=None if tc
                      else cuda_core_row_tile(rows, d, page_size))
    ws = counters = None
    if plan.splits > 1:
        ws = torch.empty(plan.workspace_floats(d), dtype=torch.float32,
                         device=q.device)
        counters = split_counters(q.device, plan.units)
    lib = build.load("paged_attention", _declare)
    err = lib.paged_attention_launch(
        _DTYPE_CODE[qc.dtype], int(quant), int(tc), qc.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, block_tables.data_ptr(),
        plen.data_ptr() if plen is not None else None, tlen.data_ptr(),
        out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        counters.data_ptr() if counters is not None else None, b, s, h, hkv,
        d, page_size, n_cols, plan.row_tile, plan.row_tiles,
        plan.pages_per_split, plan.splits, float(d ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_attention launch")
    LAUNCHES["paged_attention_int8" if quant else "paged_attention"] += 1
    return out.to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           cache_len: torch.Tensor, *, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """Single-step attention against each slot's live pages only.

    q ``(B, 1, H, D)``; ``cache_len`` ``(B,)`` counts valid positions
    including the step's new token; ``k_scale``/``v_scale`` are the scale
    pools of int8 pages. Returns ``(B, 1, H, D)``."""
    if q.shape[1] != 1:
        raise ValueError("paged_decode_attention is a single-step kernel")
    if not q.is_cuda:
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_tables, cache_len,
                                              k_scale=k_scale,
                                              v_scale=v_scale)
    return _paged_attention(q, k_pages, v_pages, block_tables, None,
                            cache_len, k_scale, v_scale)


def paged_prefill_append_attention(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   prefix_len: torch.Tensor,
                                   total_len: torch.Tensor, *, k_scale=None,
                                   v_scale=None) -> torch.Tensor:
    """Prefill-append: the uncached suffix attends to cached prefix pages
    (decode is the S=1, prefix_len=cache_len-1 case). Rows at/past a slot's
    true suffix length are garbage the caller discards. Returns
    ``(B, S, H, D)``."""
    if not q.is_cuda:
        return ref.paged_prefill_append_ref(q, k_pages, v_pages, block_tables,
                                            prefix_len, total_len,
                                            k_scale=k_scale, v_scale=v_scale)
    return _paged_attention(q, k_pages, v_pages, block_tables, prefix_len,
                            total_len, k_scale, v_scale)


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
