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
slot's live pages. A CUDA tensor goes through the kernel (or the wrapper
raises); a CPU tensor goes through the plain version in
:mod:`repro_torch.kernels.ref`. Each launch adds one to
``LAUNCHES["paged_attention"]``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"paged_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 200 * 1024
_P, _I = ctypes.c_void_p, ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.paged_attention_smem_bytes.argtypes = [_I, _I, _I]
    lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
    lib.paged_attention_launch.argtypes = ([_I] + [_P] * 7 + [_I] * 8
                                           + [ctypes.c_float, _P])
    lib.paged_attention_launch.restype = _I


def _no_int8(k_scale, v_scale) -> None:
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 KV pages (k_scale / v_scale) come in the next slice of the "
            "port")


def _row_tile(lib, rows: int, d: int, page_size: int) -> int:
    rt = min(64, rows)
    while lib.paged_attention_smem_bytes(d, page_size, rt) > _SMEM_LIMIT:
        if rt == 1:
            raise ValueError(f"page_size {page_size} x head_dim {d} needs more "
                             f"shared memory than a CTA has")
        rt = max(1, rt // 2)
    return rt


def _paged_attention(q, k_pages, v_pages, block_tables, prefix_len,
                     total_len) -> torch.Tensor:
    """Kernel launch: q (B, S, H, D), row ``i`` of slot ``b`` at absolute
    position ``prefix_len[b] + i``, over table pages covering
    ``[0, total_len[b])``. Returns (B, S, H, D) in q's dtype. q is cast to
    the pool's dtype first, as the plain version does."""
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("q must be (B, S, H, D) and pages (n_pages, "
                         "page_size, Hkv, D)")
    if k_pages.shape != v_pages.shape or k_pages.dtype != v_pages.dtype:
        raise ValueError("k_pages and v_pages must match in shape and dtype")
    if k_pages.dtype not in _DTYPE_CODE:
        raise TypeError(f"page dtype {k_pages.dtype} not supported "
                        f"(float32, bfloat16)")
    b, s, h, d = q.shape
    _, page_size, hkv, dk = k_pages.shape
    if dk != d or h % hkv:
        raise ValueError(f"q heads {h} / head_dim {d} do not fit pages "
                         f"(Hkv {hkv}, D {dk})")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != b:
        raise ValueError("block_tables must be int32 (B, n_cols)")
    plen = prefix_len.to(device=q.device, dtype=torch.int32).contiguous()
    tlen = total_len.to(device=q.device, dtype=torch.int32).contiguous()
    if plen.shape != (b,) or tlen.shape != (b,):
        raise ValueError("prefix_len / total_len must be (B,)")
    qc = q.to(k_pages.dtype).contiguous()
    out = torch.empty_like(qc)
    if b == 0 or s == 0:
        return out.to(q.dtype)
    lib = build.load("paged_attention", _declare)
    rt = _row_tile(lib, s * (h // hkv), d, page_size)
    err = lib.paged_attention_launch(
        _DTYPE_CODE[k_pages.dtype], qc.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), plen.data_ptr(),
        tlen.data_ptr(), out.data_ptr(), b, s, h, hkv, d, page_size,
        block_tables.shape[1], rt, float(d ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_attention launch")
    LAUNCHES["paged_attention"] += 1
    return out.to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           cache_len: torch.Tensor, *, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """Single-step attention against each slot's live pages only.

    q ``(B, 1, H, D)``; ``cache_len`` ``(B,)`` counts valid positions
    including the step's new token. Returns ``(B, 1, H, D)``."""
    _no_int8(k_scale, v_scale)
    if q.shape[1] != 1:
        raise ValueError("paged_decode_attention is a single-step kernel")
    if not q.is_cuda:
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_tables, cache_len)
    lens = cache_len.to(device=q.device, dtype=torch.int32)
    return _paged_attention(q, k_pages, v_pages, block_tables, lens - 1, lens)


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
    _no_int8(k_scale, v_scale)
    if not q.is_cuda:
        return ref.paged_prefill_append_ref(q, k_pages, v_pages, block_tables,
                                            prefix_len, total_len)
    return _paged_attention(q, k_pages, v_pages, block_tables, prefix_len,
                            total_len)


def paged_kv_bytes(cache_len, page_size: int, hkv: int, d: int,
                   dtype_bytes: int = 2) -> int:
    """Device-memory bytes the kernel reads per layer per step: each slot's
    live pages, K + V. ``cache_len`` counts valid positions including the
    step's new token; ``dtype_bytes`` is the pool element's itemsize."""
    lens = np.maximum(np.asarray(cache_len), 0)
    pages = np.maximum(-(-lens // page_size), 1) * (lens > 0)
    return int(pages.sum()) * page_size * hkv * d * dtype_bytes * 2
