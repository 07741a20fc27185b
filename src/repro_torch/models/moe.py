"""Mixture-of-Experts FFN — GShard-style one-hot dispatch, a copy of the
reference package's ``models/moe.py`` in PyTorch.

Token groups of ``moe_group_size`` are routed top-k with a capacity limit;
dispatch and combine are dense einsums over one-hot tensors, as the
reference computes them outside any Pallas kernel. The experts' weights are
stacked on a leading E axis, so BCR pruning packs each expert's matrices
on their own block grid in one batched pass, and each projection of all E
experts is ONE launch of ``bcr_spmm`` / ``bcr_spmm_grouped`` over the
stacked pack (the reference's ``jax.vmap`` over its ``pallas_call``).

Covers deepseek-moe (64e top-6 + 2 shared, fine-grained, first layer
dense) and llama4-maverick (128e top-1 + shared, interleaved).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_linear import linear_apply, linear_init
from repro_torch.models.layers import swiglu_apply, swiglu_init
from repro_torch.runtime import partitioning as part

Params = Dict[str, Any]


def _stacked_linear(generator: torch.Generator, e: int, in_dim: int,
                    out_dim: int, dtype) -> Params:
    """E linears ``{"w": (E, out, in)}`` initialised as ``linear_init``
    initialises one, from one draw."""
    w = (torch.randn((e, out_dim, in_dim), generator=generator,
                     device=generator.device) * in_dim ** -0.5)
    return {"w": w.to(dtype)}


def moe_init(generator: torch.Generator, cfg) -> Params:
    """Router ``(E, d)``, the E experts' SwiGLU weights stacked on a leading
    E axis, and (``num_shared_experts``) one shared SwiGLU of width
    ``moe_d_ff × num_shared_experts``."""
    d = cfg.d_model
    e = cfg.num_experts
    dff = cfg.moe_d_ff or cfg.d_ff
    p: Params = {
        "router": linear_init(generator, d, e, dtype=cfg.p_dtype),
        "experts": {
            "wg": _stacked_linear(generator, e, d, dff, cfg.p_dtype),
            "wi": _stacked_linear(generator, e, d, dff, cfg.p_dtype),
            "wo": _stacked_linear(generator, e, dff, d, cfg.p_dtype),
        },
    }
    if cfg.num_shared_experts:
        p["shared"] = swiglu_init(generator, d, dff * cfg.num_shared_experts,
                                  dtype=cfg.p_dtype)
    return p


def _capacity(cfg, group: int) -> int:
    c = int(group * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(4, -(-c // 4) * 4)


def route(params: Params, x: torch.Tensor, cfg, token_mask=None):
    """The router of :func:`moe_apply`: tokens ``x`` ``(B, S, d)`` cut into
    groups → ``(groups (G, s, d), gate values (G, s, k) fp32, expert
    indices (G, s, k), dispatch (G, s, E, C) bf16, combine (G, s, E, C)
    fp32)``. Each token's k chosen experts take it in token order while the
    expert has room (the GShard capacity cumsum); ``token_mask`` (B, S)
    keeps masked tokens out of that cumsum."""
    d = x.shape[-1]
    e = cfg.num_experts
    tokens = x.reshape(-1, d)
    n_tok = tokens.shape[0]
    g_size = min(cfg.moe_group_size, n_tok)
    if n_tok % g_size:
        g_size = n_tok  # smoke-scale fallback: one group
    n_g = n_tok // g_size
    xg = tokens.reshape(n_g, g_size, d)
    cap = _capacity(cfg, g_size)
    mask_g = None
    if token_mask is not None:
        mask_g = token_mask.reshape(n_g, g_size).to(torch.int32)   # (G, s)

    logits = linear_apply(params["router"], xg).float()
    probs = torch.softmax(logits, dim=-1)                          # (G, s, E)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    # normalize the top-k gates (deepseek/llama4 convention)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    dev = x.device
    counts = torch.zeros((n_g, e), dtype=torch.int32, device=dev)
    dispatch = torch.zeros((n_g, g_size, e, cap), dtype=torch.bfloat16,
                           device=dev)
    combine = torch.zeros((n_g, g_size, e, cap), dtype=torch.float32,
                          device=dev)
    for k in range(cfg.top_k):
        oh_e = F.one_hot(expert_idx[..., k], e).to(torch.int32)    # (G, s, E)
        if mask_g is not None:
            # masked tokens vanish from the capacity cumsum entirely: they
            # neither claim a buffer slot nor shift real tokens' ranks
            oh_e = oh_e * mask_g[..., None]
        pos = (torch.cumsum(oh_e, dim=1, dtype=torch.int32) - oh_e
               + counts[:, None, :])                             # (G, s, E)
        within = (pos < cap) & (oh_e > 0)
        counts = counts + within.to(torch.int32).sum(dim=1, dtype=torch.int32)
        loc = torch.where(within, pos, torch.zeros_like(pos)).sum(-1)  # (G, s)
        oh_c = F.one_hot(loc.long(), cap).float()                   # (G, s, C)
        d_k = within.float()[..., None] * oh_c[..., None, :]       # (G,s,E,C)
        dispatch = dispatch + d_k.to(torch.bfloat16)
        combine = combine + gate_vals[..., k][..., None, None] * d_k
    return xg, gate_vals, expert_idx, dispatch, combine


def moe_apply(params: Params, x: torch.Tensor, cfg,
              token_mask=None) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d).

    ``token_mask`` (B, S) bool marks tokens that may claim expert capacity.
    Routing couples tokens through the shared capacity limit, so garbage
    rows (free decode slots, admission pad rows) must be excluded before
    the position cumsum, or they would take capacity slots and could evict
    real tokens. Masked tokens get a zero routed output (plus the
    row-independent shared-expert term); callers never read those rows.

    Every expert's buffer of ``groups × capacity`` rows is computed, empty
    or not (pad rows are zero), by one ``swiglu_apply`` over the stacked
    experts: one gate/up and one down launch for all E on the card."""
    b, s, d = x.shape
    e = cfg.num_experts
    xg, _, _, dispatch, combine = route(params, x, cfg, token_mask)
    n_g, cap = xg.shape[0], dispatch.shape[-1]

    # dispatch tokens to expert buffers: (E, G, C, d)
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), xg)
    expert_in = part.act(expert_in, "experts", None, None, "embed")
    expert_out = swiglu_apply(params["experts"],
                              expert_in.reshape(e, n_g * cap, d))
    expert_out = expert_out.reshape(e, n_g, cap, d)
    expert_out = part.act(expert_out, "experts", None, None, "embed")
    y = torch.einsum("gsec,egcd->gsd", combine,
                     expert_out.float()).to(x.dtype)
    y = y.reshape(b, s, d)
    if "shared" in params:
        y = y + swiglu_apply(params["shared"], x)
    return y


def aux_load_balance_loss(logits: torch.Tensor, expert_idx: torch.Tensor,
                          e: int) -> torch.Tensor:
    """Switch-style auxiliary loss (for training recipes; the port's
    trainer does not use it yet)."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(dim=tuple(range(probs.dim() - 1)))
    oh = F.one_hot(expert_idx[..., 0].long(), e).float()
    ce = oh.mean(dim=tuple(range(oh.dim() - 1)))
    return e * torch.sum(me * ce)
