"""The neural-net substrate: RMSNorm and LayerNorm, RoPE and sinusoidal
positions, embeddings, attention (full-sequence for training and cold
prefill, causal or not; capacity-dense and paged decode, paged
prefill-append; encoder-decoder cross attention), the SwiGLU and GELU MLPs
and the cross-entropy loss. Every projection goes through
``core.sparse_linear`` so BCR-packed weights run through the port's
kernels.

Page writes happen in place (``index_copy_`` into the pool); the reference's
functional ``.at[].set`` returns a new pool instead. int8 pools quantize on
store, writing codes and the sibling per-row scale at the same flat row.

Cold-prefill attention follows ``cfg.attn_impl`` as in the reference:
``"flash"`` (every full config's default) runs :func:`flash_attention`,
the reference's chunked online-softmax attention (XLA code there, a plain
torch chunk loop here); ``"pallas"`` (and its CPU-validation twin
``"pallas_interpret"``) runs the fused flash kernel; ``"dense"`` and the
paged-kernel settings ``"paged"`` / ``"paged_interpret"`` run the
materialized product :func:`dense_attention`; anything else raises. Paged
decode and prefill-append always run the paged attention kernel;
capacity-dense decode runs the plain :func:`decode_attention`, as the
reference runs it outside any Pallas kernel. Cross attention over more than
one query row runs :func:`flash_attention` under ``"flash"`` and
:func:`dense_attention` otherwise.

Both chunked paths keep the reference's chunk rule: ``q_chunk`` and
``kv_chunk`` (each clamped to its length) must divide the lengths. The
engine's prefill buckets respect it (:func:`flash_chunks`); whisper's 1500
frames do not split into the default 512 / 1024, so the encdec callers
clamp each chunk to the whole length when the configured one does not
divide it (``models/encdec.py``).

Training differentiates the full-sequence path with autograd:
:func:`flash_attention` recomputes each q-chunk body in the backward pass
(``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``). The
fused flash kernel has no backward, as the reference's Pallas
``flash_attention_fused`` has none (its ``pallas_call`` cannot be
differentiated), so ``"pallas"`` under a gradient raises.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core.sparse_linear import (grouped_linear_apply,
                                            linear_apply, linear_in_dim,
                                            linear_init)
from repro_torch.kernels.flash_attention import flash_attention_fused
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_prefill_append_attention)
from repro_torch.kernels.quant import quantize_rows
from repro_torch.kernels.ref import NEG_INF
from repro_torch.runtime import partitioning as part
from repro_torch.runtime.collectives import axis_size, maybe_gather

Params = Dict[str, Any]

# the reference's attn_impl values: the fused flash kernel, or the plain
# product for cold prefill
FLASH_ATTN_IMPLS = ("pallas", "pallas_interpret")
PLAIN_ATTN_IMPLS = ("dense", "flash", "paged", "paged_interpret")


# the settings whose cold prefill splits the sequence into q/kv chunks: the
# fused kernel and the chunked flash_attention
CHUNKED_ATTN_IMPLS = FLASH_ATTN_IMPLS + ("flash",)


def flash_chunks(cfg) -> Optional[Tuple[int, int]]:
    """``(q_chunk, kv_chunk)`` when cold prefill runs the fused flash
    kernel or the chunked :func:`flash_attention`, else None (the argument
    of ``prefill_bucket``)."""
    if cfg.attn_impl in CHUNKED_ATTN_IMPLS:
        return cfg.q_chunk, cfg.kv_chunk
    return None


def whole_length_chunk(chunk: int, length: int) -> int:
    """``chunk`` where it divides ``length``, else the whole length: the
    encdec callers' rule for whisper's 1500 frames, which the configured
    512 / 1024 chunks do not split (the reference's chunked attention
    asserts there)."""
    return chunk if length % min(chunk, length) == 0 else length


def check_attn_impl(attn_impl: str) -> None:
    if attn_impl not in FLASH_ATTN_IMPLS + PLAIN_ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; known: "
                         f"{FLASH_ATTN_IMPLS + PLAIN_ATTN_IMPLS}")


# ---------------------------------------------------------------------------
# Norms / RoPE / embeddings
# ---------------------------------------------------------------------------


def rmsnorm_init(dim: int, dtype, device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def _seq_gathered(y: torch.Tensor) -> torch.Tensor:
    """A normed residual stream ``(B, S, d)`` feeds projections: under
    rules it leaves the sequence-parallel layout (the all-gather over the
    sequence the reference's GSPMD inserts before a column-parallel
    projection; DTensor needs it spelled out). No-op without rules."""
    return part.act(y, "batch", "seq", "embed") if y.dim() == 3 else y


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return _seq_gathered((y * params["scale"].float()).to(x.dtype))


def layernorm_init(dim: int, dtype, device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """LayerNorm in fp32 over the population variance, as the reference's
    (``jnp.var``), then cast back to ``x``'s dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), params["scale"].float(),
                     params["bias"].float(), eps)
    return _seq_gathered(y.to(x.dtype))


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """fp32 ``(seq, dim)`` table: sines then cosines of ``pos · f_i``, with
    ``f_i = exp(-ln(10000) · i / max(half - 1, 1))`` — the reference's
    frequencies, whose denominator is ``half - 1``, not ``half``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / max(half - 1, 1))
    angles = pos * freqs[None]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


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
    return part.lookup(params["table"], ids)


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
    q = part.act(q, "batch", "seq", "heads", "head_dim")
    k = part.act(k, "batch", "seq", "kv_heads", "head_dim")
    v = part.act(v, "batch", "seq", "kv_heads", "head_dim")
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


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``a @ b`` of two batched operands in their own dtype, as the
    reference's ``preferred_element_type=jnp.float32``: bf16/fp16 operands
    on the card go in as they are with an fp32 result (``torch.bmm``'s
    ``out_dtype``) when this PyTorch offers it and no gradient is needed
    (it has no backward); otherwise both are upcast to fp32 and multiplied
    in fp32 (TF32 off, as every caller leaves it). Products of bf16 values
    are exact in fp32 either way; only the summation order differs."""
    if (a.is_cuda and a.dtype in (torch.bfloat16, torch.float16)
            and b.dtype == a.dtype and _BMM_OUT_DTYPE
            and not (torch.is_grad_enabled()
                     and (a.requires_grad or b.requires_grad))):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


_BMM_OUT_DTYPE = "dtype" in torch.ops.aten.bmm.overloads()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Online-softmax chunked attention, GQA-aware: the reference's XLA
    ``models/layers.flash_attention`` as a plain torch chunk loop. q ``(B,
    Sq, H, D)``, k/v ``(B, Skv, Hkv, D)``; with ``causal`` query row ``i``
    sits at position ``q_offset + i``.

    Never holds more than ``q_chunk × kv_chunk`` logits a head: for each
    q-chunk, a running max, sum and fp32 accumulator over its kv-chunks.
    Tiles wholly in the future are skipped (statically, as the reference
    skips them at trace time) and only tiles that cross the diagonal are
    masked (-1e30). Logits are fp32 products of the operands in their own
    dtype (:func:`_bmm_f32`: bf16 operands with an fp32 result on the card
    where ``torch.bmm`` takes ``out_dtype``, else both upcast with TF32
    off), scaled by ``D**-0.5``; ``p`` is cast to v's dtype before the PV
    product, whose result is fp32 too. Under a gradient each q-chunk body
    runs under ``torch.utils.checkpoint`` (``use_reentrant=False``), the
    reference's ``jax.checkpoint``: the backward pass recomputes it instead
    of keeping each tile's residuals.

    The chunks, each clamped to its length, must divide the lengths (the
    reference's assertion, kept)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    assert sq % q_chunk == 0 and skv % kv_chunk == 0
    nq, nk = sq // q_chunk, skv // kv_chunk
    scale = d ** -0.5
    bh = b * hkv
    # the merged (B, Hkv) dim over the whole mesh when it divides it, else
    # over the DP axes with the GQA q-groups over model (the reference's
    # adaptive layout; no-ops without rules)
    if part.divides(bh, "batch_heads"):
        t0, tg = "batch_heads", None
    else:
        t0, tg = "batch_kv", ("heads_g" if part.divides(g, "heads_g")
                              else None)
    qm = q.reshape(b, sq, hkv, g, d).permute(0, 2, 1, 3, 4).reshape(
        bh, sq, g, d)
    km = k.permute(0, 2, 1, 3).reshape(bh, skv, d)
    vm = v.permute(0, 2, 1, 3).reshape(bh, skv, d)
    qm = part.act(qm, t0, "seq", tg, "head_dim")
    km = part.act(km, t0, "seq", "head_dim")
    vm = part.act(vm, t0, "seq", "head_dim")
    # no dim the chunk loop reduces over is sharded: each rank attends over
    # its own (B·Hkv, q-group) shard, so the loop runs on the local tensors
    # (the tensors themselves without a DTensor)
    g_all = g
    ql, kl, vl = part.local(qm), part.local(km), part.local(vm)
    bh, g = ql.shape[0], ql.shape[2]
    qr = ql.reshape(bh, nq, q_chunk, g, d)
    kr = kl.reshape(bh, nk, kv_chunk, d)
    vr = vl.reshape(bh, nk, kv_chunk, d)

    def one_q_chunk(qi: int, qc: torch.Tensor) -> torch.Tensor:
        # qc (bh, q_chunk, g, d) → rows (g, q) of one bmm per kv-chunk
        qg = qc.permute(0, 2, 1, 3).reshape(bh, g * q_chunk, d)
        m = torch.full((bh, g, q_chunk), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((bh, g, q_chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((bh, g, q_chunk, d), dtype=torch.float32,
                          device=q.device)
        q_lo = q_offset + qi * q_chunk
        q_hi = q_lo + q_chunk - 1
        for ki in range(nk):
            k_lo = ki * kv_chunk
            if causal and k_lo > q_hi:
                continue              # wholly in the future: skipped
            kc, vc = kr[:, ki], vr[:, ki]
            logits = (_bmm_f32(qg, kc.transpose(1, 2)) * scale).reshape(
                bh, g, q_chunk, kv_chunk)
            logits = part.act(logits, t0, tg, None, None)
            if causal and k_lo + kv_chunk - 1 > q_lo:   # diagonal: mask
                qpos = q_lo + torch.arange(q_chunk, device=q.device)
                kpos = k_lo + torch.arange(kv_chunk, device=q.device)
                logits = logits.masked_fill(qpos[:, None] < kpos[None, :],
                                            -1e30)
            new_m = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - new_m)
            p = torch.exp(logits - new_m[..., None])
            l = l * alpha + p.sum(-1)
            pv = _bmm_f32(p.to(vc.dtype).reshape(bh, g * q_chunk, kv_chunk),
                          vc).reshape(bh, g, q_chunk, d)
            acc = acc * alpha[..., None] + pv
            m = new_m
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.permute(0, 2, 1, 3)       # (bh, q_chunk, g, d)

    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    outs = []
    for qi in range(nq):
        if grad:
            outs.append(torch.utils.checkpoint.checkpoint(
                one_q_chunk, qi, qr[:, qi], use_reentrant=False))
        else:
            outs.append(one_q_chunk(qi, qr[:, qi]))
    out = part.like(torch.stack(outs, dim=1).reshape(bh, sq, g, d), qm)
    out = out.reshape(b, hkv, sq, g_all, d)
    return out.permute(0, 2, 1, 3, 4).reshape(b, sq, h, d).to(q.dtype)


def _paged_write(cache: Params, dest: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, n_kv: int, head_dim: int) -> None:
    """Scatter K/V rows into the layer's page pools at flat row positions
    ``dest``, in place. fp pools store the rows cast to their dtype; int8
    pools (``k_scale``/``v_scale`` leaves) quantize on store: each row's
    per-kv-head codes go into the pool and its fp32 scales into the sibling
    ``(n_pages, page_size, Hkv)`` scale pool at the same flat position, so
    the two never drift apart. K and V are quantized in one pass (half the
    small launches of quantizing each)."""
    dest = dest.reshape(-1).long()
    rows = {"k": k.reshape(-1, n_kv, head_dim),
            "v": v.reshape(-1, n_kv, head_dim)}
    if "k_scale" not in cache:
        for key, r in rows.items():
            cache[key].view(-1, n_kv, head_dim).index_copy_(
                0, dest, r.to(cache[key].dtype))
        return
    codes, scales = quantize_rows(torch.stack([rows["k"], rows["v"]]))
    for i, key in enumerate(("k", "v")):
        cache[key].view(-1, n_kv, head_dim).index_copy_(0, dest, codes[i])
        cache[f"{key}_scale"].view(-1, n_kv).index_copy_(0, dest, scales[i])


def cold_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   attn_impl: str, q_chunk: int, kv_chunk: int,
                   causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (causal for a decoder's cold prefill, not
    for an encoder), q ``(B, S, H, D)``, k/v ``(B, S, Hkv, D)``.
    ``attn_impl="flash"`` runs the chunked :func:`flash_attention`;
    ``"pallas"`` runs the fused flash kernel on the merged-head layout with
    K/V repeated to all q heads (the reference's trade: duplicated K/V
    reads for one fused pass); the other plain settings run
    :func:`dense_attention`."""
    check_attn_impl(attn_impl)
    if attn_impl == "flash":
        return flash_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                               kv_chunk=kv_chunk)
    if attn_impl not in FLASH_ATTN_IMPLS:
        return dense_attention(q, k, v, causal=causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            f"attn_impl={attn_impl!r} under a gradient: flash_attention_fused "
            f"has no backward kernel (the reference's Pallas kernel cannot be "
            f"differentiated either); train with attn_impl 'flash' or 'dense'")
    b, s, h, d = q.shape
    g = h // k.shape[2]

    def merged(t):
        return t.repeat_interleave(g, dim=2).transpose(1, 2).reshape(
            b * h, t.shape[1], d)

    out = flash_attention_fused(
        q.transpose(1, 2).reshape(b * h, s, d), merged(k), merged(v),
        causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk)
    return out.reshape(b, h, s, d).transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-step attention against capacity-dense caches.

    q ``(B, 1, H, D)``; caches ``(B, L, Hkv, D)``; ``cache_len`` a scalar or
    ``(B,)``: the valid positions of each slot, the step's new K/V already
    written. Products in fp32 off the cache dtype, positions at or past a
    slot's length masked before an fp32 softmax whose probabilities are
    rounded to the cache dtype, as the reference's XLA ``decode_attention``
    does (plain torch here: the reference runs no Pallas kernel on this
    path). int8 caches (``k_scale``/``v_scale``, ``(B, L, Hkv)``) are
    dequantized to fp32 first, the reference's correctness fallback."""
    b, _, h, d = q.shape
    l, hkv = k_cache.shape[1], k_cache.shape[2]
    if k_scale is not None:
        k_cache = k_cache.float() * k_scale.float()[..., None]
        v_cache = v_cache.float() * v_scale.float()[..., None]
    k_cache = part.act(k_cache, "batch", "kv_seq", None, None)
    v_cache = part.act(v_cache, "batch", "kv_seq", None, None)
    qg = q.reshape(b, hkv, h // hkv, d).to(k_cache.dtype)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                          k_cache.float()) * d ** -0.5
    logits = part.act(logits, "batch", None, None, "kv_seq")
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1)
    valid = (torch.arange(l, device=q.device)[None]
             < lens.expand(b)[:, None])                       # (B, L)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    p = part.act(part.softmax(logits, dim=-1), "batch", None, None,
                 "kv_seq").to(v_cache.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", p.float(), v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def _dense_write(cache: Params, cache_len: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """Write each slot's step K/V ``(B, 1, Hkv, D)`` at its own position
    ``cache_len[b]`` of the capacity-dense cache, in place; int8 caches
    store codes and the per-row, per-kv-head scales at the same position."""
    if "k_scale" not in cache:
        for key, new in (("k", k), ("v", v)):
            part.write_rows(cache[key], cache_len, new[:, 0])
        return
    rows = torch.arange(k.shape[0], device=k.device)
    idx = (rows, cache_len.to(k.device).long())
    codes, scales = quantize_rows(torch.stack([k[:, 0], v[:, 0]]))
    for i, key in enumerate(("k", "v")):
        cache[key].index_put_(idx, codes[i])
        cache[f"{key}_scale"].index_put_(idx, scales[i])


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
    attn_impl: str = "flash", q_chunk: int = 512, kv_chunk: int = 1024,
    causal: bool = True, tp_axis: str = "",
) -> Tuple[torch.Tensor, Params]:
    """Full attention block.

    ``rope_cs`` (:func:`rope_tables`, None without RoPE) and, with a paged
    cache, ``kv_dest`` (:func:`paged_write_rows`) are computed once per
    forward by the caller and shared by every layer.

    * no ``cache`` — cold prefill (causal unless ``causal=False``, as an
      encoder's; :func:`cold_attention` by ``attn_impl``); returns the
      fresh K/V as the cache.
    * ``cache`` without ``block_tables`` — capacity-dense decode, one
      token: each slot writes its K/V at ``cache_len[b]`` of its own rows
      (``(B, capacity, Hkv, D)`` leaves), then :func:`decode_attention`
      over positions ``<= cache_len[b]``.
    * ``cache`` + ``block_tables``, one token — paged decode: write K/V at
      ``table[b, len // ps] * ps + len % ps`` (inactive slots, with length
      0 and a zeroed table row, land in the reserved null page 0), then the
      paged attention kernel over each slot's live pages.
    * ``cache`` + ``block_tables``, ``S > 1`` — prefill-append: ``cache_len``
      counts the cached prefix, ``suffix_len`` the true suffix rows; the S
      suffix K/V rows are written at ``cache_len + i`` (pad rows to the null
      page) before attending through the pages.

    A cache with ``k_scale``/``v_scale`` leaves holds int8 pages: writes
    quantize on store and attention reads the codes with their scales.

    ``tp_axis`` names the tensor-parallel group when the block runs on one
    rank of a sharded engine (``serving/tp.py``): ``n_heads``/``n_kv`` are
    then the rank's own head counts, the cache leaves its ``Hkv`` slice,
    and the block re-replicates by all-gather (never a reduce: summation
    order stays one device's) at the reference's two points: the head
    axis before ``wo`` (whose reduction spans all heads) and ``wo``'s
    output (the residual stream stays replicated).
    """
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, n_heads, n_kv, head_dim, rope_cs)

    if cache is not None and block_tables is None:
        if s != 1:
            raise ValueError("a capacity-dense cache takes one token a step")
        cache["k"] = part.act(cache["k"], "batch", "kv_seq", None, None)
        cache["v"] = part.act(cache["v"], "batch", "kv_seq", None, None)
        _dense_write(cache, cache_len, k, v)
        out = decode_attention(q, cache["k"], cache["v"], cache_len + 1,
                               k_scale=cache.get("k_scale"),
                               v_scale=cache.get("v_scale"))
        new_cache = cache
    elif cache is not None:
        kp, vp = cache["k"], cache["v"]
        ks, vs = cache.get("k_scale"), cache.get("v_scale")
        _paged_write(cache, kv_dest, k, v, n_kv, head_dim)
        shards = axis_size(tp_axis)
        if s > 1:
            out = paged_prefill_append_attention(
                q, kp, vp, block_tables, cache_len, cache_len + suffix_len,
                k_scale=ks, v_scale=vs, head_shards=shards)
        else:
            out = paged_decode_attention(q, kp, vp, block_tables,
                                         cache_len + 1, k_scale=ks,
                                         v_scale=vs, head_shards=shards)
        new_cache = cache
    else:
        out = cold_attention(q, k, v, attn_impl=attn_impl, q_chunk=q_chunk,
                             kv_chunk=kv_chunk, causal=causal)
        new_cache = {"k": k, "v": v}
    out = part.act(out, "batch", "seq", "heads", "head_dim")
    if tp_axis:
        out = maybe_gather(out, linear_in_dim(params["wo"]) // head_dim,
                           tp_axis, axis=2)
    y = linear_apply(params["wo"], out.reshape(b, s, out.shape[2] * head_dim))
    return maybe_gather(y, x.shape[-1], tp_axis), new_cache


def cross_attention_apply(params: Params, x: torch.Tensor, kv: Params, *,
                          n_heads: int, n_kv: int, head_dim: int,
                          attn_impl: str = "dense", q_chunk: int = 512,
                          kv_chunk: int = 1024) -> torch.Tensor:
    """Encoder-decoder cross attention of the decoder stream ``x`` ``(B,
    S, d)`` against precomputed encoder K/V (``kv["k"]``/``kv["v"]``, ``(B,
    S_enc, Hkv, D)``). Q is never fused with K/V here (it projects another
    activation; see ``kernels/plan.fuse_packed_projections``). One query
    row runs :func:`decode_attention` over every encoder row; more run
    non-causal attention, the chunked :func:`flash_attention` under
    ``attn_impl="flash"`` (the reference's XLA ``flash_attention``, not a
    Pallas kernel; the encdec model passes its config's setting, with
    chunks clamped to divide the lengths) and :func:`dense_attention` under
    the other settings, the default here."""
    b, s, _ = x.shape
    q = linear_apply(params["wq"], x).reshape(b, s, n_heads, head_dim)
    k, v = kv["k"], kv["v"]
    if s == 1:
        out = decode_attention(q, k, v, k.shape[1])
    elif attn_impl == "flash":
        out = flash_attention(q, k, v, causal=False, q_chunk=q_chunk,
                              kv_chunk=kv_chunk)
    else:
        out = dense_attention(q, k, v, causal=False)
    return linear_apply(params["wo"], out.reshape(b, s, n_heads * head_dim))


def cross_kv(params: Params, enc_out: torch.Tensor, *, n_kv: int,
             head_dim: int) -> Params:
    """The cross-attention K/V of encoder states ``(B, S_enc, d)``: one
    grouped launch when packing fused them into ``wkv``."""
    b, s, _ = enc_out.shape
    if "wkv" in params:
        k, v = grouped_linear_apply(params["wkv"], enc_out)
    else:
        k = linear_apply(params["wk"], enc_out)
        v = linear_apply(params["wv"], enc_out)
    return {"k": k.reshape(b, s, n_kv, head_dim),
            "v": v.reshape(b, s, n_kv, head_dim)}


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


def swiglu_apply(params: Params, x: torch.Tensor,
                 tp_axis: str = "") -> torch.Tensor:
    if "wgi" in params:
        # packed serving: ONE fused gate/up launch whose emit step applies
        # bias + silu(g)·h — no separate elementwise pass over the hidden
        h = grouped_linear_apply(params["wgi"], x, epilogue="swiglu")
    else:
        h = F.silu(linear_apply(params["wg"], x)) * linear_apply(
            params["wi"], x)
    h = part.act(h, "batch", "seq", "mlp")
    if tp_axis:
        # column-parallel gate/up made a local d_ff slice (silu·mul is
        # elementwise, so it commutes with the shard): re-replicate to
        # wo's whole reduction width by a gather, never a reduce-scatter
        h = maybe_gather(h, linear_in_dim(params["wo"]), tp_axis)
    return maybe_gather(linear_apply(params["wo"], h), x.shape[-1], tp_axis)


def gelu_mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.float32) -> Params:
    return {
        "wi": linear_init(generator, d_model, d_ff, bias=True, dtype=dtype),
        "wo": linear_init(generator, d_ff, d_model, bias=True, dtype=dtype),
    }


def gelu_mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``wo(gelu(wi(x)))``, both linears with a bias; the tanh GELU, as
    ``jax.nn.gelu``'s default."""
    h = F.gelu(linear_apply(params["wi"], x), approximate="tanh")
    h = part.act(h, "batch", "seq", "mlp")
    return linear_apply(params["wo"], h)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy in fp32 (logsumexp); logits ``(..., V)``,
    targets ``(...)``; with ``mask`` the mean over masked-in tokens."""
    logits = part.act(logits.float(), "batch", "seq", "vocab")
    lse, gold = part.xent_terms(logits, targets)
    nll = lse - gold
    if nll.dim() == 2:
        # per-token losses in the batch layout, so their gradient comes
        # back sharded as they were, not replicated (no-op without rules)
        nll = part.act(nll, "batch", "seq")
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# Scan helper of the recurrent mixers
# ---------------------------------------------------------------------------


def chunked_checkpoint_scan(body: Callable, carry, xs: Sequence[torch.Tensor],
                            chunk: int):
    """``body(carry, inputs_t) -> (carry, y_t)`` over the leading time axis
    of every tensor in ``xs``, ``chunk`` steps at a time; returns the final
    carry and the ``y_t`` stacked on a new leading axis. The reference's
    ``lax.scan`` of ``jax.checkpoint``-ed chunks: under a gradient each
    chunk runs through ``torch.utils.checkpoint`` (only the carries at
    chunk boundaries are kept; a chunk's steps are recomputed in the
    backward pass); without one it is the plain loop. The SSM and RWKV
    recurrences are XLA code in the reference, not Pallas, so a Python
    loop over time is their port."""
    t = xs[0].shape[0]
    if t % chunk:
        raise ValueError(f"time axis {t} is not a multiple of chunk {chunk}")

    def run(c, *xc):
        ys = []
        for i in range(xc[0].shape[0]):
            c, y = body(c, tuple(a[i] for a in xc))
            ys.append(y)
        return c, torch.stack(ys)

    out = []
    for s in range(0, t, chunk):
        xc = tuple(a[s:s + chunk] for a in xs)
        if torch.is_grad_enabled():
            carry, ys = torch.utils.checkpoint.checkpoint(
                run, carry, *xc, use_reentrant=False)
        else:
            carry, ys = run(carry, *xc)
        out.append(ys)
    return carry, torch.cat(out)
