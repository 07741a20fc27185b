"""Plain PyTorch versions of the port's kernels.

These are what every kernel wrapper runs for a tensor on the CPU, and what
the card's kernels are held to in ``chip_smoke.py`` and the CUDA tests.
They mirror the reference package's ``kernels/ref.py`` line for line:

* ``bcr_spmm_ref`` — semantic ground truth (dense reconstruction, one
  matmul);
* ``bcr_spmm_packed_ref`` / ``bcr_spmm_grouped_ref`` — reconstruction-free
  gather → blockwise einsum → scatter-add off the pack-time plan;
* ``paged_decode_attention_ref`` / ``paged_prefill_append_ref`` — gather each
  slot's table pages, then masked attention.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.bcrc import TBCRC, tbcrc_unpack

NEG_INF = -1e30

# rows per chunk of the plain spmm: bounds its gathered (M, L_c) activation
# so that full-width shapes (lm_head at prefill M) fit on the card
_GATHER_ELEMS = 1 << 27


def bcr_spmm_ref(x: torch.Tensor, packed: TBCRC) -> torch.Tensor:
    """y[M, N] = x[M, K] @ W.T with W = dense reconstruction of ``packed``."""
    w = tbcrc_unpack(packed)  # (N, K)
    return (x.float() @ w.float().T).to(x.dtype)


def _row_chunks(m: int, width: int):
    step = max(1, _GATHER_ELEMS // max(width, 1))
    for lo in range(0, m, step):
        yield lo, min(m, lo + step)


def bcr_spmm_packed_ref(x: torch.Tensor, packed: TBCRC) -> torch.Tensor:
    """Reconstruction-free plain path: ``y = x @ W.T`` straight off the
    packed ``(nb_r, nb_c, R_keep, C_keep)`` vals — one gather of every
    surviving activation, one batched einsum over the kept tiles, one
    scatter-add into fp32 output rows."""
    plan = packed.plan
    m = x.shape[0]
    nb_r, nb_c, r_keep, c_keep = packed.vals.shape
    n = packed.shape[0]
    cols = plan.gather_cols.long()
    rows = plan.scatter_rows.long()
    vals = packed.vals.float()
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for lo, hi in _row_chunks(m, cols.numel()):
        xg = x[lo:hi].index_select(1, cols).float()
        xg = xg.reshape(hi - lo, nb_r, nb_c, c_keep)
        part = torch.einsum("mijc,ijrc->mijr", xg, vals)
        y[lo:hi].index_add_(1, rows, part.reshape(hi - lo, -1))
    return y.to(x.dtype)


def grouped_epilogue(y: torch.Tensor, bias: Optional[torch.Tensor],
                     epilogue: Optional[str], out_dtype) -> torch.Tensor:
    """Shared epilogue of the grouped paths: fp32 ``y`` is ``(..., G, N)``;
    bias ``(G, N)`` adds before the activation. ``epilogue="swiglu"``
    collapses a G=2 gate/up pair into ``silu(y[0]) * y[1]``."""
    if bias is not None:
        y = y + bias.float()
    if epilogue == "swiglu":
        if y.shape[-2] != 2:
            raise ValueError("swiglu epilogue needs a gate/up pair")
        y = F.silu(y[..., 0, :]) * y[..., 1, :]
    elif epilogue is not None:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    return y.to(out_dtype)


def bcr_spmm_grouped_ref(x: torch.Tensor, grouped, bias=None,
                         epilogue: Optional[str] = None) -> torch.Tensor:
    """Grouped plain path: G same-shaped packed weights sharing ``x`` in one
    gather + one einsum + one scatter-add. Returns ``(M, G, N)``, or
    ``(M, N)`` with ``epilogue="swiglu"``."""
    plan = grouped.plan
    m = x.shape[0]
    g, nb_r, nb_c, r_keep, c_keep = grouped.vals.shape
    n = grouped.shape[0]
    cols = plan.gather_cols.long()
    rows = plan.scatter_rows.long()
    vals = grouped.vals.float()
    y = torch.zeros((m, g * n), dtype=torch.float32, device=x.device)
    for lo, hi in _row_chunks(m, cols.numel()):
        xg = x[lo:hi].index_select(1, cols).float()
        xg = xg.reshape(hi - lo, g, nb_r, nb_c, c_keep)
        part = torch.einsum("mgijc,gijrc->mgijr", xg, vals)
        y[lo:hi].index_add_(1, rows, part.reshape(hi - lo, -1))
    return grouped_epilogue(y.reshape(m, g, n), bias, epilogue, x.dtype)


def _gather_pages(pages: torch.Tensor, block_tables: torch.Tensor,
                  b: int, l: int, hkv: int, d: int) -> torch.Tensor:
    """Table pages → a contiguous (B, L, Hkv, D) history."""
    return pages[block_tables.long()].reshape(b, l, hkv, d)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               cache_len: torch.Tensor) -> torch.Tensor:
    """Plain paged decode: q ``(B, 1, H, D)``; pages ``(n_pages, page_size,
    Hkv, D)``; tables ``(B, n_cols)``; cache_len ``(B,)`` counts valid
    positions including the step's new token."""
    b, s, h, d = q.shape
    assert s == 1
    _, page_size, hkv, _ = k_pages.shape
    g = h // hkv
    l = block_tables.shape[1] * page_size
    k = _gather_pages(k_pages, block_tables, b, l, hkv, d)
    v = _gather_pages(v_pages, block_tables, b, l, hkv, d)
    qg = q.reshape(b, hkv, g, d).to(k.dtype)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float()) * d ** -0.5
    valid = (torch.arange(l, device=q.device)[None]
             < cache_len.to(q.device)[:, None])
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", p.float(), v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def paged_prefill_append_ref(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor,
                             block_tables: torch.Tensor,
                             prefix_len: torch.Tensor,
                             total_len: torch.Tensor) -> torch.Tensor:
    """Plain paged prefill-append: an S-row query block per slot whose row
    ``i`` sits at absolute position ``prefix_len[b] + i``, causally masked
    against the slot's table pages (the suffix K/V are already in them).
    Rows at/past the true suffix length are garbage the caller discards."""
    b, s, h, d = q.shape
    _, page_size, hkv, _ = k_pages.shape
    g = h // hkv
    l = block_tables.shape[1] * page_size
    k = _gather_pages(k_pages, block_tables, b, l, hkv, d)
    v = _gather_pages(v_pages, block_tables, b, l, hkv, d)
    qg = q.reshape(b, s, hkv, g, d).to(k.dtype)
    logits = torch.einsum("bshgd,bkhd->bhgsk", qg.float(),
                          k.float()) * d ** -0.5
    dev = q.device
    qpos = (prefix_len.to(dev).long()[:, None]
            + torch.arange(s, device=dev)[None])                  # (B, S)
    kpos = torch.arange(l, device=dev)
    valid = ((kpos[None, None] <= qpos[:, :, None])
             & (kpos[None, None] < total_len.to(dev)[:, None, None]))
    logits = torch.where(valid[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgsk,bkhd->bshgd", p.float(), v.float())
    return out.reshape(b, s, h, d).to(q.dtype)
