"""Causal LM of the dense, MoE, vlm, ssm and hybrid families: init, the
training forward and loss, paged and capacity-dense caches, prefill, decode
step and prefill-append.

A Python loop over ``params["layers"]`` replaces the reference's scanned
stack (the converter unstacks the reference's layer axis, in execution
order); ``cfg.remat`` checkpoints each layer (``torch.utils.checkpoint``),
as the reference's ``jax.checkpoint`` does its scan body. :func:`layer_plan`
gives each layer's ``(mixer, ffn)`` kinds as the reference's does: the
mixer ``"attn"``, ``"mamba"`` (hybrid: attention once every
``attn_period`` layers, at ``attn_offset``) or ``"rwkv"`` (ssm); the FFN
``"mlp"``, ``"moe"`` (``moe_first_dense`` leading dense layers, then MoE
every ``moe_every``-th) or ``"rwkv_cm"``. A MoE layer's routing reads
``token_mask``, which every serving entry point threads through. A vlm
prompt's first ``num_image_tokens`` embeddings may be replaced by
``image_embeds`` (the stub vision tower's patch embeddings).

The cache is one dict of leaves per layer. An attention layer holds K/V
(paged or capacity-dense, plus int8 scales), whose leaves carry positions;
a recurrent layer holds its state, one row per slot: mamba ``h`` ``(B,
d_in, n)`` fp32 and ``conv`` ``(B, k-1, d_in)``, RWKV ``s`` ``(B, H, hs,
hs)`` fp32, ``shift`` ``(B, d)`` and its channel-mix's ``cm_shift`` ``(B,
d)`` (the reference nests the last as ``{"ffn": {"shift"}}``). Decode
updates both in place. The encdec family is not a causal LM: it runs
through ``models/encdec.py`` (``models.api.model_fns`` dispatches).
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
from repro_torch.models import mixers as M
from repro_torch.models import moe as MOE
from repro_torch.runtime import partitioning as part
from repro_torch.runtime.collectives import maybe_gather

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]

PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: causal_lm runs the decoder-only "
            f"families {PORTED_FAMILIES}; encdec runs through "
            f"models.encdec (models.api.model_fns)")
    if cfg.kv_dtype not in ("", "int8"):
        raise ValueError(f"unsupported kv_dtype {cfg.kv_dtype!r}")
    L.check_attn_impl(cfg.attn_impl)


def _head_logits(cfg: ModelConfig, params: Params,
                 x: torch.Tensor) -> torch.Tensor:
    """``lm_head``; under tensor parallelism (``cfg.tp_axis``) the vocab
    shards are gathered, so every rank holds the whole logits (a
    replicated ``lm_head``, one whose rows do not divide the group, needs
    no gather)."""
    return maybe_gather(linear_apply(params["lm_head"], x), cfg.vocab_size,
                        cfg.tp_axis)


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """``(mixer, ffn)`` per layer, as the reference's ``layer_plan`` gives
    it: ssm layers ``("rwkv", "rwkv_cm")``; otherwise the mixer attention,
    or with ``attn_period`` attention at ``attn_offset`` of each period and
    mamba elsewhere; the FFN ``"moe"`` from layer ``moe_first_dense`` on,
    every ``moe_every``-th layer (the last of each period), else
    ``"mlp"``."""
    plan = []
    for i in range(cfg.num_layers):
        if cfg.family == "ssm":
            plan.append(("rwkv", "rwkv_cm"))
            continue
        mixer = "attn"
        if cfg.attn_period and i % cfg.attn_period != cfg.attn_offset:
            mixer = "mamba"
        ffn = "mlp"
        if cfg.num_experts and i >= cfg.moe_first_dense:
            j = i - cfg.moe_first_dense
            if cfg.moe_every <= 1 or j % cfg.moe_every == cfg.moe_every - 1:
                ffn = "moe"
        plan.append((mixer, ffn))
    return plan


def stacked_layers(cfg: ModelConfig) -> Tuple[str, ...]:
    """Paths of the layers whose params the reference stacks on a leading
    axis: under ``scan_layers`` every layer after a MoE model's
    ``moe_first_dense`` leading ones (its unstacked ``prefix``), else none
    (the reference's ``stack_plan``)."""
    if not cfg.scan_layers:
        return ()
    first = cfg.moe_first_dense if cfg.num_experts else 0
    return tuple(f"['layers'][{i}]" for i in range(first, cfg.num_layers))


def has_attention(cfg: ModelConfig) -> bool:
    """Whether any layer attends (and so holds position leaves)."""
    return any(m == "attn" for m, _ in layer_plan(cfg))


# an attention layer's cache leaves: the only ones whose axis 1 counts
# positions (pages, in a paged cache); every other leaf is a recurrent
# layer's state, one row a slot
POSITION_LEAVES = frozenset({"k", "v", "k_scale", "v_scale"})


def position_keys(cache: Cache) -> List[frozenset]:
    """Per layer, the keys of ``cache``'s position leaves."""
    return [frozenset(layer) & POSITION_LEAVES for layer in cache]


def layer_init(generator: torch.Generator, cfg: ModelConfig,
               kinds: Tuple[str, str]) -> Params:
    dev = generator.device
    mixer, ffn = kinds
    if mixer == "attn":
        mp = L.attention_init(generator, cfg.d_model, cfg.num_heads,
                              cfg.num_kv_heads, cfg.head_dim,
                              qkv_bias=cfg.qkv_bias, dtype=cfg.p_dtype)
    elif mixer == "mamba":
        mp = M.mamba_init(generator, cfg)
    elif mixer == "rwkv":
        mp = M.rwkv_tm_init(generator, cfg)
    else:
        raise ValueError(mixer)
    if ffn == "mlp":
        fp = L.swiglu_init(generator, cfg.d_model, cfg.d_ff,
                           dtype=cfg.p_dtype)
    elif ffn == "moe":
        fp = MOE.moe_init(generator, cfg)
    elif ffn == "rwkv_cm":
        fp = M.rwkv_cm_init(generator, cfg)
    else:
        raise ValueError(ffn)
    return {"norm1": L.rmsnorm_init(cfg.d_model, cfg.p_dtype, dev),
            "mixer": mp,
            "norm2": L.rmsnorm_init(cfg.d_model, cfg.p_dtype, dev),
            "ffn": fp}


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
        "layers": [layer_init(gen, cfg, kinds) for kinds in layer_plan(cfg)],
    }


def init_cache(cfg: ModelConfig, batch: int = 0, capacity: int = 0, *,
               kv_pages: int = 0, page_size: int = 0,
               device="cuda") -> Cache:
    """Decode cache, one dict of leaves per layer.

    Attention layers: with ``page_size > 0`` a paged pool, one
    ``(kv_pages, page_size, Hkv, D)`` K and V pool per layer (page 0 is the
    null page: pad and inactive writes land there; no live table entry
    points at it); otherwise capacity-dense, ``(batch, capacity, Hkv, D)``,
    slot ``b`` owning row ``b`` (the reference's scanned stack puts its
    layer axis first instead). ``kv_dtype="int8"`` stores int8 codes plus
    sibling fp32 ``k_scale``/``v_scale`` leaves shaped as the codes without
    their last axis.

    Recurrent layers (mamba, RWKV) hold ``batch`` rows of state whatever
    the attention layout, one a slot: ``h``/``conv``, or ``s``/``shift``/
    ``cm_shift`` (see the module's docstring)."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    plan = layer_plan(cfg)
    lead = None
    if has_attention(cfg):
        if page_size > 0:
            lead = (kv_pages, page_size)
        elif batch > 0 and capacity > 0:
            lead = (batch, capacity)
        else:
            raise ValueError("init_cache needs page_size > 0 (paged) or "
                             "batch and capacity > 0 (capacity-dense)")
    if any(m != "attn" for m, _ in plan) and batch <= 0:
        raise ValueError(f"{cfg.family}: recurrent state needs batch > 0")
    quant = cfg.kv_dtype == "int8"
    kv_dt = torch.int8 if quant else cfg.c_dtype

    def attention():
        shape = lead + (cfg.num_kv_heads, cfg.head_dim)
        c = {"k": torch.zeros(shape, dtype=kv_dt, device=dev),
             "v": torch.zeros(shape, dtype=kv_dt, device=dev)}
        if quant:
            c["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
            c["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
        return c

    def layer(kinds):
        mixer, ffn = kinds
        if mixer == "attn":
            c = attention()
        elif mixer == "mamba":
            c = M.mamba_init_cache(cfg, batch, cfg.c_dtype, dev)
        else:
            c = M.rwkv_tm_init_cache(cfg, batch, cfg.c_dtype, dev)
        if ffn == "rwkv_cm":
            c["cm_shift"] = torch.zeros((batch, cfg.d_model),
                                        dtype=cfg.c_dtype, device=dev)
        return c

    return [layer(kinds) for kinds in plan]


def _layer_body(kinds: Tuple[str, str], lp: Params, x: torch.Tensor,
                cfg: ModelConfig, *, rope_cs, kv_dest=None,
                cache: Optional[Params] = None,
                cache_len: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                suffix_len: Optional[torch.Tensor] = None,
                token_mask: Optional[torch.Tensor] = None,
                want_state: bool = False) -> Tuple[torch.Tensor, Params]:
    """One layer: (x', the layer's state). With ``cache`` (decode) a
    recurrent mixer steps one token from it and returns its new state; an
    attention mixer writes its K/V into the cache and returns the cache.
    Without (a sequence), attention returns the fresh K/V, and a recurrent
    mixer its state after the last position when ``want_state``.
    ``token_mask`` (B, S) marks the tokens that may claim MoE expert
    capacity (None: all); every other path ignores it."""
    mixer, ffn = kinds
    x = part.act(x, "batch", "seq_sp", "embed")
    h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    mp = lp["mixer"]
    state: Params = {}
    if mixer == "attn":
        out, state = L.attention_apply(
            mp, h, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
            head_dim=cfg.head_dim, rope_cs=rope_cs, cache=cache,
            cache_len=cache_len, block_tables=block_tables,
            suffix_len=suffix_len, kv_dest=kv_dest, attn_impl=cfg.attn_impl,
            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, tp_axis=cfg.tp_axis)
    elif cache is not None:
        step = (M.mamba_apply_step if mixer == "mamba"
                else M.rwkv_tm_apply_step)
        out, state = step(mp, h, cache, cfg)
    else:
        seq = M.mamba_apply_seq if mixer == "mamba" else M.rwkv_tm_apply_seq
        out = seq(mp, h, cfg, return_state=want_state)
        if want_state:
            out, state = out
    # the block output in the residual's (seq-parallel) layout before the
    # add (the reference's perf iteration C4)
    out = part.act(out, "batch", "seq_sp", "embed")
    x = x + out
    h2 = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
    if ffn == "moe":
        y = MOE.moe_apply(lp["ffn"], h2, cfg, token_mask=token_mask)
    elif ffn == "rwkv_cm":
        if cache is not None:
            y, state["cm_shift"] = M.rwkv_cm_apply_step(lp["ffn"], h2,
                                                        cache["cm_shift"])
        else:
            y = M.rwkv_cm_apply_seq(lp["ffn"], h2)
            if want_state:
                state["cm_shift"] = h2[:, -1].to(cfg.c_dtype)
    else:
        y = L.swiglu_apply(lp["ffn"], h2, tp_axis=cfg.tp_axis)
    y = part.act(y, "batch", "seq_sp", "embed")
    return x + y, state


def layer_apply(kinds: Tuple[str, str], lp: Params, x: torch.Tensor,
                cfg: ModelConfig, *, rope_cs, kv_dest=None,
                cache: Optional[Params] = None,
                cache_len: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                suffix_len: Optional[torch.Tensor] = None,
                token_mask: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Params]:
    """One serving layer. Prefill (no ``cache``) returns the layer's leaves
    of :func:`init_cache`: fresh K/V in ``cache_dtype`` (under
    ``kv_dtype="int8"`` quantized on emission to codes + scales), or the
    recurrent state after the prompt. Decode and prefill-append update
    ``cache`` in place and return it. ``rope_cs``/``kv_dest`` are the
    per-forward tables every layer shares (see ``_step_tables``)."""
    x, st = _layer_body(kinds, lp, x, cfg, rope_cs=rope_cs, kv_dest=kv_dest,
                        cache=cache, cache_len=cache_len,
                        block_tables=block_tables, suffix_len=suffix_len,
                        token_mask=token_mask, want_state=cache is None)
    if kinds[0] != "attn":
        if cache is None:
            return x, st
        for key, leaf in st.items():
            cache[key].copy_(leaf)
        return x, cache
    if cache is None and cfg.kv_dtype == "int8":
        kc, ks = quantize_rows(st["k"])
        vc, vs = quantize_rows(st["v"])
        st = {"k": kc, "v": vc, "k_scale": ks, "v_scale": vs}
    elif cache is None:
        st = {"k": st["k"].to(cfg.c_dtype), "v": st["v"].to(cfg.c_dtype)}
    return x, st


def _step_tables(cfg: ModelConfig, positions: torch.Tensor,
                 block_tables=None, cache_len=None, suffix_len=None,
                 page_size: int = 0):
    """What every layer of one forward shares: the RoPE (cos, sin) tables
    and, on a paged cache, the pool rows the new K/V land in (neither
    when no layer attends)."""
    attn = has_attention(cfg)
    rope_cs = (L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
               if attn and cfg.rope_theta > 0 else None)
    kv_dest = None
    if attn and block_tables is not None:
        kv_dest = L.paged_write_rows(block_tables, cache_len,
                                     positions.shape[1], suffix_len,
                                     page_size)
    return dict(rope_cs=rope_cs, kv_dest=kv_dest)


def _page_size(cache: Cache) -> int:
    """Positions a page of the paged cache holds (0: no attention
    layer)."""
    return next((c["k"].shape[1] for c, keys in zip(cache,
                                                    position_keys(cache))
                 if keys), 0)


def _embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  image_embeds: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Token embeddings in the activation dtype; a vlm's ``image_embeds``
    ``(B, P, d)`` replace the first P positions (the image tokens)."""
    h = L.embed(params["embed"], tokens).to(cfg.act_dtype)
    if cfg.num_image_tokens and image_embeds is not None:
        p = image_embeds.shape[1]
        h = torch.cat([torch.as_tensor(image_embeds, device=h.device)
                       .to(h.dtype), h[:, p:]], dim=1)
    return part.act(h, "batch", "seq_sp", "embed")


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward → logits ``(B, S, V)`` in the activation dtype
    (train / eval). Differentiable; with ``cfg.remat`` each layer's
    activations are recomputed in the backward pass instead of kept."""
    _check_cfg(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _embed_tokens(cfg, params, tokens, image_embeds)
    rope_cs = _step_tables(cfg, positions)["rope_cs"]

    def run(kinds, lp, x):
        return _layer_body(kinds, lp, x, cfg, rope_cs=rope_cs)[0]

    for kinds, lp in zip(layer_plan(cfg), params["layers"]):
        if cfg.remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(run, kinds, lp, x,
                                                  use_reentrant=False)
        else:
            x = run(kinds, lp, x)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return part.act(_head_logits(cfg, params, x), "batch", "seq", "vocab")


def loss_fn(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token-mean fp32 cross entropy of ``forward`` on ``batch["tokens"]``
    (and ``batch["image_embeds"]``, optional) against ``batch["targets"]``
    (``batch["mask"]`` optional)."""
    logits = forward(cfg, params, batch["tokens"],
                     image_embeds=batch.get("image_embeds"))
    return L.cross_entropy(logits, batch["targets"], batch.get("mask"))


def _mask(token_mask, like: torch.Tensor) -> Optional[torch.Tensor]:
    return None if token_mask is None else torch.as_tensor(
        token_mask, device=like.device).to(torch.bool)


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            image_embeds: Optional[torch.Tensor] = None,
            length: Optional[torch.Tensor] = None,
            token_mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Serving prefill: last-position logits ``(B, 1, V)`` + each layer's
    leaves: K/V ``(B, S, Hkv, D)``, or a recurrent layer's state after
    position S-1. ``length`` (B,) gives each row's true prompt length when
    ``tokens`` is right-padded: logits are taken at ``length - 1``;
    causality keeps the pads invisible to real positions (recurrent state
    runs through the pads, so those families prefill at exact length).
    ``token_mask`` (B, S) keeps pad positions and rows out of MoE expert
    capacity."""
    _check_cfg(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _embed_tokens(cfg, params, tokens, image_embeds)
    shared = _step_tables(cfg, positions)
    token_mask = _mask(token_mask, tokens)
    cache: Cache = []
    for kinds, lp in zip(layer_plan(cfg), params["layers"]):
        x, st = layer_apply(kinds, lp, x, cfg, token_mask=token_mask,
                            **shared)
        cache.append(st)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if length is None:
        last = x[:, -1:]
    else:
        idx = torch.clamp(length.to(tokens.device).long() - 1, 0, s - 1)
        last = torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))
    return _head_logits(cfg, params, last), cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Cache, cache_len: torch.Tensor,
                block_tables: Optional[torch.Tensor] = None,
                token_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One serving step: tokens (B, 1) + cache → (logits (B, 1, V), cache).
    ``cache_len`` is a scalar (uniform batch) or (B,): slot b writes its
    K/V at position ``cache_len[b]`` and attends to its own history —
    through ``block_tables`` (B, n_cols) over a paged cache, or in its own
    rows of a capacity-dense cache (``block_tables`` None); a recurrent
    layer steps slot b's state row. ``token_mask`` (B, 1) marks the rows
    that may claim MoE expert capacity (the engine passes ``lens > 0``;
    None: every row routes)."""
    _check_cfg(cfg)
    b = tokens.shape[0]
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32,
                                device=tokens.device).reshape(-1).expand(b)
    positions = cache_len[:, None]
    x = _embed_tokens(cfg, params, tokens)
    shared = (_step_tables(cfg, positions) if block_tables is None else
              _step_tables(cfg, positions, block_tables, cache_len,
                           page_size=_page_size(cache)))
    token_mask = _mask(token_mask, tokens)
    for kinds, lp, c in zip(layer_plan(cfg), params["layers"], cache):
        x, _ = layer_apply(kinds, lp, x, cfg, cache=c,
                           cache_len=cache_len, block_tables=block_tables,
                           token_mask=token_mask, **shared)
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
    logits of every suffix position (B, S, V). A MoE layer routes only the
    real suffix positions (the reference's ``valid`` mask). Attention
    layers only: a recurrent layer has no paged state to append to, so a
    model with one raises."""
    _check_cfg(cfg)
    plan = layer_plan(cfg)
    if any(m != "attn" for m, _ in plan):
        raise ValueError(f"{cfg.family}: prefill_append needs every mixer "
                         f"to be attention; recurrent state cannot be "
                         f"appended to through pages")
    b, s = tokens.shape
    dev = tokens.device
    prefix_len = prefix_len.to(dev)
    slen = (torch.full((b,), s, dtype=torch.int32, device=dev)
            if length is None else length.to(dev))
    positions = prefix_len.long()[:, None] + torch.arange(s, device=dev)[None]
    x = _embed_tokens(cfg, params, tokens)
    shared = _step_tables(cfg, positions, block_tables, prefix_len, slen,
                          page_size=_page_size(cache))
    token_mask = (torch.arange(s, device=dev)[None] < slen[:, None]
                  if cfg.num_experts else None)
    for kinds, lp, c in zip(plan, params["layers"], cache):
        x, _ = layer_apply(kinds, lp, x, cfg, cache=c,
                           cache_len=prefix_len, block_tables=block_tables,
                           suffix_len=slen, token_mask=token_mask, **shared)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if all_logits:
        return _head_logits(cfg, params, x), cache
    idx = torch.clamp(slen.long() - 1, 0, s - 1)
    last = torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))
    return _head_logits(cfg, params, last), cache
