"""Serving subset of the neural-net substrate: RMSNorm, RoPE, embeddings,
attention (cold prefill, paged decode, paged prefill-append) and the SwiGLU
MLP. Every projection goes through ``core.sparse_linear`` so BCR-packed
weights run through the port's kernels.

Page writes happen in place (``index_copy_`` into the pool); the reference's
functional ``.at[].set`` returns a new pool instead.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_linear import (grouped_linear_apply,
                                            linear_apply, linear_init)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_prefill_append_attention)
from repro_torch.kernels.ref import NEG_INF

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Norms / RoPE / embeddings
# ---------------------------------------------------------------------------


def rmsnorm_init(dim: int, dtype, device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (cos, sin) of the half-split (not interleaved) rotary embedding,
    shaped (..., S, 1, half) for positions (..., S). The reference's
    ``rope`` is ``apply_rope(x, *rope_tables(...))``; the tables are built
    once per forward and shared by every layer and by q and k."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freqs = theta ** exponent
    angles = positions[..., None].float() * freqs          # (..., S, half)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype) -> Params:
    table = torch.randn((vocab, dim), generator=generator,
                        device=generator.device) * dim ** -0.5
    return {"table": table.to(dtype)}


def embed(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids.long()]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_init(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, *, qkv_bias: bool = False,
                   dtype=torch.float32) -> Params:
    return {
        "wq": linear_init(generator, d_model, n_heads * head_dim,
                          bias=qkv_bias, dtype=dtype),
        "wk": linear_init(generator, d_model, n_kv * head_dim,
                          bias=qkv_bias, dtype=dtype),
        "wv": linear_init(generator, d_model, n_kv * head_dim,
                          bias=qkv_bias, dtype=dtype),
        "wo": linear_init(generator, n_heads * head_dim, d_model,
                          dtype=dtype),
    }


def _qkv(params: Params, x: torch.Tensor, n_heads: int, n_kv: int,
         head_dim: int,
         rope_cs: Optional[Tuple[torch.Tensor, torch.Tensor]]):
    b, s, _ = x.shape
    # packed serving fuses projections sharing this activation into one
    # grouped launch: all of Q/K/V when their shapes agree, else K/V only
    if "wqkv" in params:
        q, k, v = grouped_linear_apply(params["wqkv"], x)
    else:
        if "wkv" in params:
            k, v = grouped_linear_apply(params["wkv"], x)
        else:
            k = linear_apply(params["wk"], x)
            v = linear_apply(params["wv"], x)
        q = linear_apply(params["wq"], x)
    q = q.reshape(b, s, n_heads, head_dim)
    k = k.reshape(b, s, n_kv, head_dim)
    v = v.reshape(b, s, n_kv, head_dim)
    if rope_cs is not None:
        q = apply_rope(q, *rope_cs)
        k = apply_rope(k, *rope_cs)
    return q, k, v


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """Materialized-logits attention with an explicit fp32 masked softmax —
    the cold-prefill path (a plain large product, as the reference leaves
    it to XLA)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * d ** -0.5
    if causal:
        qpos = torch.arange(sq, device=q.device)
        kpos = torch.arange(skv, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = torch.where(mask[None, None, None], logits,
                             torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _paged_write(pages: torch.Tensor, dest: torch.Tensor, rows: torch.Tensor,
                 n_kv: int, head_dim: int) -> torch.Tensor:
    """Scatter K/V rows into a page pool at flat row positions ``dest``, in
    place, cast to the pool dtype. Returns the pool."""
    pages.view(-1, n_kv, head_dim).index_copy_(
        0, dest.reshape(-1).long(),
        rows.reshape(-1, n_kv, head_dim).to(pages.dtype))
    return pages


def paged_write_rows(block_tables: torch.Tensor, cache_len: torch.Tensor,
                     s: int, suffix_len: Optional[torch.Tensor],
                     page_size: int) -> torch.Tensor:
    """Flat pool rows ``table[b, pos // ps] * ps + pos % ps`` where each
    slot's ``s`` new K/V rows land, positions ``cache_len[b] + i``. Rows at
    or past ``suffix_len`` (pads) go to the null page 0, as do inactive
    slots (length 0 over a zeroed table row). Returns (B·s,) int64."""
    n_cols = block_tables.shape[1]
    ar = torch.arange(s, device=block_tables.device)
    pos = cache_len.long()[:, None] + ar[None]                   # (B, S)
    col = torch.clamp(pos // page_size, 0, n_cols - 1)
    dest = (torch.gather(block_tables.long(), 1, col) * page_size
            + pos % page_size)
    if suffix_len is not None:
        dest = torch.where(ar[None] < suffix_len.long()[:, None], dest,
                           torch.zeros_like(dest))
    return dest.reshape(-1)


def attention_apply(
    params: Params, x: torch.Tensor, *, n_heads: int, n_kv: int,
    head_dim: int,
    rope_cs: Optional[Tuple[torch.Tensor, torch.Tensor]],
    cache: Optional[Params] = None, cache_len: Optional[torch.Tensor] = None,
    block_tables: Optional[torch.Tensor] = None,
    suffix_len: Optional[torch.Tensor] = None,
    kv_dest: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Params]:
    """Full attention block.

    ``rope_cs`` (:func:`rope_tables`, None without RoPE) and, with a paged
    cache, ``kv_dest`` (:func:`paged_write_rows`) are computed once per
    forward by the caller and shared by every layer.

    * no ``cache`` — cold prefill (causal, plain fp32 softmax); returns the
      fresh K/V as the cache.
    * ``cache`` + ``block_tables``, one token — paged decode: write K/V at
      ``table[b, len // ps] * ps + len % ps`` (inactive slots, with length
      0 and a zeroed table row, land in the reserved null page 0), then the
      paged attention kernel over each slot's live pages.
    * ``cache`` + ``block_tables``, ``S > 1`` — prefill-append: ``cache_len``
      counts the cached prefix, ``suffix_len`` the true suffix rows; the S
      suffix K/V rows are written at ``cache_len + i`` (pad rows to the null
      page) before attending through the pages.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, n_heads, n_kv, head_dim, rope_cs)

    if cache is not None and block_tables is None:
        raise NotImplementedError(
            "unpaged (capacity-dense) caches come in a later slice of the "
            "port; pass block_tables")
    if cache is not None:
        kp, vp = cache["k"], cache["v"]
        _paged_write(kp, kv_dest, k, n_kv, head_dim)
        _paged_write(vp, kv_dest, v, n_kv, head_dim)
        if s > 1:
            out = paged_prefill_append_attention(
                q, kp, vp, block_tables, cache_len, cache_len + suffix_len)
        else:
            out = paged_decode_attention(q, kp, vp, block_tables,
                                         cache_len + 1)
        new_cache = cache
    else:
        out = dense_attention(q, k, v, causal=True)
        new_cache = {"k": k, "v": v}
    y = linear_apply(params["wo"], out.reshape(b, s, n_heads * head_dim))
    return y, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu_init(generator: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32) -> Params:
    return {
        "wg": linear_init(generator, d_model, d_ff, dtype=dtype),
        "wi": linear_init(generator, d_model, d_ff, dtype=dtype),
        "wo": linear_init(generator, d_ff, d_model, dtype=dtype),
    }


def swiglu_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "wgi" in params:
        # packed serving: ONE fused gate/up launch whose emit step applies
        # bias + silu(g)·h — no separate elementwise pass over the hidden
        h = grouped_linear_apply(params["wgi"], x, epilogue="swiglu")
    else:
        h = F.silu(linear_apply(params["wg"], x)) * linear_apply(
            params["wi"], x)
    return linear_apply(params["wo"], h)
