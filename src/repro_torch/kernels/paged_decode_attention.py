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

A CUDA tensor goes through the kernel (or the wrapper raises); a CPU tensor
goes through the plain version in :mod:`repro_torch.kernels.ref`. Each
launch adds one to ``LAUNCHES["paged_attention"]`` (fp pages) or
``LAUNCHES["paged_attention_int8"]``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"paged_attention": 0, "paged_attention_int8": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 200 * 1024
_P, _I = ctypes.c_void_p, ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.paged_attention_smem_bytes.argtypes = [_I, _I, _I]
    lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
    lib.paged_attention_launch.argtypes = ([_I, _I] + [_P] * 9 + [_I] * 8
                                           + [ctypes.c_float, _P])
    lib.paged_attention_launch.restype = _I


def _row_tile(lib, rows: int, d: int, page_size: int) -> int:
    rt = min(64, rows)
    while lib.paged_attention_smem_bytes(d, page_size, rt) > _SMEM_LIMIT:
        if rt == 1:
            raise ValueError(f"page_size {page_size} x head_dim {d} needs more "
                             f"shared memory than a CTA has")
        rt = max(1, rt // 2)
    return rt


def _paged_attention(q, k_pages, v_pages, block_tables, prefix_len,
                     total_len, k_scale=None, v_scale=None) -> torch.Tensor:
    """Kernel launch: q (B, S, H, D), row ``i`` of slot ``b`` at absolute
    position ``prefix_len[b] + i``, over table pages covering
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
    plen = prefix_len.to(device=q.device, dtype=torch.int32).contiguous()
    tlen = total_len.to(device=q.device, dtype=torch.int32).contiguous()
    if plen.shape != (b,) or tlen.shape != (b,):
        raise ValueError("prefix_len / total_len must be (B,)")
    qc = (q if quant else q.to(k_pages.dtype)).contiguous()
    out = torch.empty_like(qc)
    if b == 0 or s == 0:
        return out.to(q.dtype)
    lib = build.load("paged_attention", _declare)
    rt = _row_tile(lib, s * (h // hkv), d, page_size)
    err = lib.paged_attention_launch(
        _DTYPE_CODE[qc.dtype], int(quant), qc.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, block_tables.data_ptr(),
        plen.data_ptr(), tlen.data_ptr(), out.data_ptr(), b, s, h, hkv, d,
        page_size, block_tables.shape[1], rt, float(d ** -0.5),
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
    lens = cache_len.to(device=q.device, dtype=torch.int32)
    return _paged_attention(q, k_pages, v_pages, block_tables, lens - 1, lens,
                            k_scale, v_scale)


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
