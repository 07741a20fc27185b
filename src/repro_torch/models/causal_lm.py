"""Causal LM, dense family: init, paged cache, prefill, decode step and
prefill-append. A Python loop over ``params["layers"]`` replaces the
reference's scanned stack (the converter unstacks the reference's layer
axis). The other families come in a later slice of the port.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import linear_apply, linear_init
from repro_torch.models import layers as L

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: only the dense family is ported so far; "
            f"the other families come in a later slice of the port")


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
    _check_family(cfg)
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
    no live table entry points at it)."""
    _check_family(cfg)
    if page_size <= 0:
        raise NotImplementedError(
            "unpaged (capacity-dense) caches come in a later slice of the "
            "port; use page_size > 0")
    if cfg.kv_dtype == "int8":
        raise NotImplementedError(
            "int8 KV pages come in the next slice of the port")
    dev = resolve_device(device)
    shape = (kv_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.c_dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.c_dtype, device=dev)}
            for _ in range(cfg.num_layers)]


def layer_apply(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                rope_cs, kv_dest=None, cache: Optional[Params] = None,
                cache_len: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                suffix_len: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Params]:
    """One transformer layer; returns the layer's KV (fresh prefill K/V in
    ``cache_dtype``, or the updated pages). ``rope_cs``/``kv_dest`` are the
    per-forward tables every layer shares (see ``_step_tables``)."""
    h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    out, kv = L.attention_apply(
        lp["mixer"], h, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rope_cs=rope_cs, cache=cache,
        cache_len=cache_len, block_tables=block_tables,
        suffix_len=suffix_len, kv_dest=kv_dest)
    if cache is None:
        kv = {"k": kv["k"].to(cfg.c_dtype), "v": kv["v"].to(cfg.c_dtype)}
    x = x + out
    h2 = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
    x = x + L.swiglu_apply(lp["ffn"], h2)
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


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            length: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Serving prefill: last-position logits ``(B, 1, V)`` + each layer's
    K/V ``(B, S, Hkv, D)``. ``length`` (B,) gives each row's true prompt
    length when ``tokens`` is right-padded: logits are taken at
    ``length - 1``; causality keeps the pads invisible to real positions."""
    _check_family(cfg)
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
    _check_family(cfg)
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
    _check_family(cfg)
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
