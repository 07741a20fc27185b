"""Causal LM, dense family: init, the training forward and loss, paged
cache, prefill, decode step and prefill-append. A Python loop over
``params["layers"]`` replaces the reference's scanned stack (the converter
unstacks the reference's layer axis); ``cfg.remat`` checkpoints each layer
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does its
one-layer scan body. The other families come in a later slice of the port.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import linear_apply, linear_init
from repro_torch.kernels.quant import quantize_rows
from repro_torch.models import layers as L

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: only the dense family is ported so far; "
            f"the other families come in a later slice of the port")
    if cfg.kv_dtype not in ("", "int8"):
        raise ValueError(f"unsupported kv_dtype {cfg.kv_dtype!r}")
    L.check_attn_impl(cfg.attn_impl)


def _head_logits(cfg: ModelConfig, params: Params,
                 x: torch.Tensor) -> torch.Tensor:
    return linear_apply(params["lm_head"], x)


def layer_init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    dev = generator.device
    return {
        "norm1": L.rmsnorm_init(cfg.d_model, cfg.p_dtype, dev),
        "mixer": L.attention_init(generator, cfg.d_model, cfg.num_heads,
                                  cfg.num_kv_heads, cfg.head_dim,
                                  qkv_bias=cfg.qkv_bias, dtype=cfg.p_dtype),
        "norm2": L.rmsnorm_init(cfg.d_model, cfg.p_dtype, dev),
        "ffn": L.swiglu_init(generator, cfg.d_model, cfg.d_ff,
                             dtype=cfg.p_dtype),
    }


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device``."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.p_dtype),
        "final_norm": L.rmsnorm_init(cfg.d_model, cfg.p_dtype, dev),
        "lm_head": linear_init(gen, cfg.d_model, cfg.vocab_size,
                               dtype=cfg.p_dtype),
        "layers": [layer_init(gen, cfg) for _ in range(cfg.num_layers)],
    }


def init_cache(cfg: ModelConfig, *, kv_pages: int, page_size: int,
               device="cuda") -> Cache:
    """Paged decode cache: one ``(kv_pages, page_size, Hkv, D)`` K and V pool
    per layer. Page 0 is the null page (pad and inactive writes land there;
    no live table entry points at it). ``kv_dtype="int8"`` stores int8 codes
    plus sibling fp32 ``k_scale``/``v_scale`` pools ``(kv_pages, page_size,
    Hkv)`` in the same page index space."""
    _check_cfg(cfg)
    if page_size <= 0:
        raise NotImplementedError(
            "unpaged (capacity-dense) caches come in a later slice of the "
            "port; use page_size > 0")
    dev = resolve_device(device)
    shape = (kv_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    quant = cfg.kv_dtype == "int8"
    kv_dt = torch.int8 if quant else cfg.c_dtype

    def layer():
        c = {"k": torch.zeros(shape, dtype=kv_dt, device=dev),
             "v": torch.zeros(shape, dtype=kv_dt, device=dev)}
        if quant:
            c["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
            c["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
        return c

    return [layer() for _ in range(cfg.num_layers)]


def _layer_body(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                rope_cs, kv_dest=None, cache: Optional[Params] = None,
                cache_len: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                suffix_len: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Params]:
    """One transformer layer: (x', the attention block's K/V or pages)."""
    h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    out, kv = L.attention_apply(
        lp["mixer"], h, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rope_cs=rope_cs, cache=cache,
        cache_len=cache_len, block_tables=block_tables,
        suffix_len=suffix_len, kv_dest=kv_dest, attn_impl=cfg.attn_impl,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    x = x + out
    h2 = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
    return x + L.swiglu_apply(lp["ffn"], h2), kv


def layer_apply(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                rope_cs, kv_dest=None, cache: Optional[Params] = None,
                cache_len: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                suffix_len: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Params]:
    """One serving layer; returns the layer's KV (fresh prefill K/V in
    ``cache_dtype``, or under ``kv_dtype="int8"`` quantized on emission to
    codes + scales, the leaves of :func:`init_cache`; or the updated
    pages). ``rope_cs``/``kv_dest`` are the per-forward tables every layer
    shares (see ``_step_tables``)."""
    x, kv = _layer_body(lp, x, cfg, rope_cs=rope_cs, kv_dest=kv_dest,
                        cache=cache, cache_len=cache_len,
                        block_tables=block_tables, suffix_len=suffix_len)
    if cache is None and cfg.kv_dtype == "int8":
        kc, ks = quantize_rows(kv["k"])
        vc, vs = quantize_rows(kv["v"])
        kv = {"k": kc, "v": vc, "k_scale": ks, "v_scale": vs}
    elif cache is None:
        kv = {"k": kv["k"].to(cfg.c_dtype), "v": kv["v"].to(cfg.c_dtype)}
    return x, kv


def _step_tables(cfg: ModelConfig, positions: torch.Tensor,
                 block_tables=None, cache_len=None, suffix_len=None,
                 page_size: int = 0):
    """What every layer of one forward shares: the RoPE (cos, sin) tables
    and, on a paged cache, the pool rows the new K/V land in."""
    rope_cs = (L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
               if cfg.rope_theta > 0 else None)
    kv_dest = None
    if block_tables is not None:
        kv_dest = L.paged_write_rows(block_tables, cache_len,
                                     positions.shape[1], suffix_len,
                                     page_size)
    return dict(rope_cs=rope_cs, kv_dest=kv_dest)


def _embed_tokens(cfg: ModelConfig, params: Params,
                  tokens: torch.Tensor) -> torch.Tensor:
    return L.embed(params["embed"], tokens).to(cfg.act_dtype)


def forward(cfg: ModelConfig, params: Params,
            tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward → logits ``(B, S, V)`` in the activation dtype
    (train / eval). Differentiable; with ``cfg.remat`` each layer's
    activations are recomputed in the backward pass instead of kept."""
    _check_cfg(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _embed_tokens(cfg, params, tokens)
    rope_cs = _step_tables(cfg, positions)["rope_cs"]

    def run(lp, x):
        return _layer_body(lp, x, cfg, rope_cs=rope_cs)[0]

    for lp in params["layers"]:
        if cfg.remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(run, lp, x,
                                                  use_reentrant=False)
        else:
            x = run(lp, x)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head_logits(cfg, params, x)


def loss_fn(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token-mean fp32 cross entropy of ``forward`` on ``batch["tokens"]``
    against ``batch["targets"]`` (``batch["mask"]`` optional)."""
    logits = forward(cfg, params, batch["tokens"])
    return L.cross_entropy(logits, batch["targets"], batch.get("mask"))


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            length: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Serving prefill: last-position logits ``(B, 1, V)`` + each layer's
    K/V ``(B, S, Hkv, D)``. ``length`` (B,) gives each row's true prompt
    length when ``tokens`` is right-padded: logits are taken at
    ``length - 1``; causality keeps the pads invisible to real positions."""
    _check_cfg(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _embed_tokens(cfg, params, tokens)
    shared = _step_tables(cfg, positions)
    cache: Cache = []
    for lp in params["layers"]:
        x, kv = layer_apply(lp, x, cfg, **shared)
        cache.append(kv)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if length is None:
        last = x[:, -1:]
    else:
        idx = torch.clamp(length.to(tokens.device).long() - 1, 0, s - 1)
        last = torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))
    return _head_logits(cfg, params, last), cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Cache, cache_len: torch.Tensor,
                block_tables: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One serving step: tokens (B, 1) + paged cache → (logits (B, 1, V),
    cache). Slot b writes its K/V at position ``cache_len[b]`` and attends
    to its own history through ``block_tables`` (B, n_cols)."""
    _check_cfg(cfg)
    if block_tables is None:
        raise NotImplementedError(
            "unpaged (capacity-dense) decode comes in a later slice of the "
            "port; pass block_tables")
    cache_len = cache_len.to(tokens.device)
    positions = cache_len[:, None]
    x = _embed_tokens(cfg, params, tokens)
    shared = _step_tables(cfg, positions, block_tables, cache_len,
                          page_size=cache[0]["k"].shape[1])
    for lp, c in zip(params["layers"], cache):
        x, _ = layer_apply(lp, x, cfg, cache=c,
                           cache_len=cache_len, block_tables=block_tables,
                           **shared)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head_logits(cfg, params, x), cache


def prefill_append(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   cache: Cache, prefix_len: torch.Tensor,
                   block_tables: torch.Tensor,
                   length: Optional[torch.Tensor] = None,
                   all_logits: bool = False) -> Tuple[torch.Tensor, Cache]:
    """Suffix-only prefill over a paged cache holding a cached prefix.

    ``tokens`` (B, S) are the uncached suffix tokens (right-padded),
    ``prefix_len`` (B,) the positions already in the slot's pages, ``length``
    (B,) the true suffix lengths. Each layer writes its suffix K/V at
    ``prefix_len + j`` and attends to prefix + suffix through the pages.
    Returns last-real-token logits (B, 1, V), or with ``all_logits`` the
    logits of every suffix position (B, S, V)."""
    _check_cfg(cfg)
    b, s = tokens.shape
    dev = tokens.device
    prefix_len = prefix_len.to(dev)
    slen = (torch.full((b,), s, dtype=torch.int32, device=dev)
            if length is None else length.to(dev))
    positions = prefix_len.long()[:, None] + torch.arange(s, device=dev)[None]
    x = _embed_tokens(cfg, params, tokens)
    shared = _step_tables(cfg, positions, block_tables, prefix_len, slen,
                          page_size=cache[0]["k"].shape[1])
    for lp, c in zip(params["layers"], cache):
        x, _ = layer_apply(lp, x, cfg, cache=c,
                           cache_len=prefix_len, block_tables=block_tables,
                           suffix_len=slen, **shared)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if all_logits:
        return _head_logits(cfg, params, x), cache
    idx = torch.clamp(slen.long() - 1, 0, s - 1)
    last = torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))
    return _head_logits(cfg, params, last), cache
