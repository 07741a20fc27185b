"""Analytic parameter / FLOPs model per architecture (roofline MODEL_FLOPS),
the reference's ``runtime/analytic.py`` on the port's configs: pure
arithmetic on ``ModelConfig`` / ``ShapeSpec``, equal to the reference's
results exactly.

MODEL_FLOPS follows the convention 6·N·D (train) or 2·N·D (forward) with N
= *active* matmul params (MoE counts shared + top-k routed only) and D =
processed tokens; attention-score FLOPs are excluded by that convention.
``tests/test_torch_analytic.py`` holds it to the reference and to the
port's own parameter trees.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeSpec


def _attn_params(cfg: ModelConfig) -> int:
    d, hd = cfg.d_model, cfg.head_dim
    return (d * cfg.num_heads * hd          # wq
            + 2 * d * cfg.num_kv_heads * hd  # wk, wv
            + cfg.num_heads * hd * d)        # wo


def _mlp_params(cfg: ModelConfig, gelu: bool = False) -> int:
    mult = 2 if gelu else 3
    return mult * cfg.d_model * cfg.d_ff


def _moe_params(cfg: ModelConfig, active: bool) -> int:
    d = cfg.d_model
    dff = cfg.moe_d_ff or cfg.d_ff
    router = d * cfg.num_experts
    shared = 3 * d * dff * cfg.num_shared_experts
    routed = 3 * d * dff * (cfg.top_k if active else cfg.num_experts)
    return router + shared + routed


def _mamba_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_in = cfg.mamba_expand * d
    n, r = cfg.mamba_d_state, cfg.mamba_dt_rank
    return (d * 2 * d_in + cfg.mamba_d_conv * d_in + d_in * (r + 2 * n)
            + r * d_in + d_in * n + d_in + d_in * d)


def _rwkv_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    tm = 5 * d * d + 2 * cfg.rwkv_lora * d + d  # r,k,v,g,o + decay lora
    cm = 2 * d * cfg.d_ff + d * d
    return tm + cm


def param_count(cfg: ModelConfig, *, active: bool = False,
                include_embed: bool = True) -> int:
    """Matmul parameter count (embeddings optional; biases/norms ignored)."""
    from repro_torch.models.causal_lm import layer_plan

    d, v = cfg.d_model, cfg.vocab_size
    total = (v * d if include_embed else 0) + v * d  # embed + lm_head

    if cfg.family == "encdec":
        from repro_torch.models.encdec import MAX_DEC_POS
        n_enc = cfg.encoder_layers or cfg.num_layers
        enc = n_enc * (_attn_params(cfg) + _mlp_params(cfg, gelu=True))
        dec = cfg.num_layers * (2 * _attn_params(cfg)
                                + _mlp_params(cfg, gelu=True))
        return total + enc + dec + (MAX_DEC_POS * d if include_embed else 0)

    for mixer, ffn in layer_plan(cfg):
        if mixer == "attn":
            total += _attn_params(cfg)
        elif mixer == "mamba":
            total += _mamba_params(cfg)
        elif mixer == "rwkv":
            total += _rwkv_params(cfg)  # includes channel-mix (the ffn)
        if ffn == "mlp":
            total += _mlp_params(cfg)
        elif ffn == "moe":
            total += _moe_params(cfg, active)
        # rwkv_cm counted inside _rwkv_params
    return total


def ideal_bytes_per_chip(cfg: ModelConfig, shape: ShapeSpec, n_chips: int
                         ) -> float:
    """First-principles HBM floor per chip per step (roofline sanity bar).

    train : params fp32 r/w + adam m/v r/w + grad read (28 B/param)
            + layer-boundary activations (save bf16 + read ≈ 4 B/tok/dim/L)
    decode: params bf16 read + KV/state cache read + update write
    prefill: params bf16 read + activations write+read per layer
    """
    n = param_count(cfg, active=False, include_embed=True)
    if shape.kind == "train":
        tokens_chip = shape.global_batch * shape.seq_len / max(n_chips, 1)
        act = 4.0 * tokens_chip * cfg.d_model * cfg.num_layers
        return 28.0 * n / n_chips + act
    params_b = 2.0 * n / n_chips
    if shape.kind == "prefill":
        tokens_chip = shape.global_batch * shape.seq_len / max(n_chips, 1)
        return params_b + 4.0 * tokens_chip * cfg.d_model * cfg.num_layers
    # decode: KV cache bytes per chip
    from repro_torch.models.causal_lm import layer_plan
    cache_b = 0.0
    if cfg.family == "encdec":
        cache_b = (cfg.num_layers * shape.global_batch * shape.seq_len
                   * cfg.num_kv_heads * cfg.head_dim * 2 * 2)
        cache_b += (cfg.num_layers * shape.global_batch * cfg.encoder_seq
                    * cfg.num_kv_heads * cfg.head_dim * 2 * 2)
    else:
        for mixer, _ in layer_plan(cfg):
            if mixer == "attn":
                cache_b += (shape.global_batch * shape.seq_len
                            * cfg.num_kv_heads * cfg.head_dim * 2 * 2)
            elif mixer == "mamba":
                cache_b += (shape.global_batch * cfg.mamba_expand
                            * cfg.d_model * cfg.mamba_d_state * 4)
            elif mixer == "rwkv":
                cache_b += (shape.global_batch * cfg.d_model
                            * cfg.rwkv_head_size * 4)
    return params_b + cache_b / n_chips


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, float]:
    """MODEL_FLOPS for one (arch × shape) cell (whole cell, all chips)."""
    n_active = param_count(cfg, active=True, include_embed=False)
    n_total = param_count(cfg, active=False, include_embed=False)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        flops = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        flops = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        flops = 2.0 * n_active * tokens
    return {"model_flops": flops, "n_active": float(n_active),
            "n_total": float(n_total), "tokens": float(tokens)}
