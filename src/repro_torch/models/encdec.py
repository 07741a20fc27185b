"""Whisper-style encoder-decoder of the encdec family (whisper-large-v3).

The conv/mel frontend is a stub, as in the reference: callers pass frame
embeddings ``(B, S_enc, d_model)``. The backbone is real: a bidirectional
encoder over sinusoidal positions, a causal decoder with learned positions
and cross attention, LayerNorm, GELU MLPs, no RoPE; every projection goes
through ``core.sparse_linear`` and so BCR-packs like the decoder-only
families'.

Params: ``enc_layers`` and ``dec_layers`` are lists of layer dicts (the
converter unstacks the reference's scanned ``enc_stack``/``dec_stack``),
beside ``enc_norm``, ``dec_embed``, ``dec_pos`` (``MAX_DEC_POS`` learned
positions), ``dec_norm`` and ``lm_head``. ``cfg.remat`` checkpoints each
layer under a gradient, as the reference's ``jax.checkpoint`` does its scan
body.

The decode cache keeps the reference's stacked leaves: ``self_k``/``self_v``
``(L, B, capacity, Hkv, D)`` and ``cross_k``/``cross_v`` ``(L, B, S_enc,
Hkv, D)``, in the cache dtype; layer ``i`` reads and writes the views
``[i]``. ``prefill`` returns the last position's logits and a cache of the
cross K/V only; the caller seats it and primes the self K/V of the prompt
through ``decode_step``. The reference serves this family through
``model_fns`` only: its engine and ``generate`` refuse it, and so do the
port's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import linear_apply, linear_init
from repro_torch.models import layers as L
from repro_torch.runtime import partitioning as part

Params = Dict[str, Any]

MAX_DEC_POS = 32768  # decoder learned-position capacity (covers decode_32k)
# the layer lists the reference always stacks (``enc_stack``/``dec_stack``,
# scanned whatever ``scan_layers`` says), as paths of the port's tree
STACKED = ("['enc_layers']", "['dec_layers']")


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.family != "encdec":
        raise ValueError(f"family {cfg.family!r} is not encdec")
    L.check_attn_impl(cfg.attn_impl)


def _attention_init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    return L.attention_init(generator, cfg.d_model, cfg.num_heads,
                            cfg.num_kv_heads, cfg.head_dim, qkv_bias=True,
                            dtype=cfg.p_dtype)


def _enc_layer_init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    dev, dt = generator.device, cfg.p_dtype
    return {
        "norm1": L.layernorm_init(cfg.d_model, dt, dev),
        "attn": _attention_init(generator, cfg),
        "norm2": L.layernorm_init(cfg.d_model, dt, dev),
        "mlp": L.gelu_mlp_init(generator, cfg.d_model, cfg.d_ff, dt),
    }


def _dec_layer_init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    dev, dt = generator.device, cfg.p_dtype
    return {
        "norm1": L.layernorm_init(cfg.d_model, dt, dev),
        "self_attn": _attention_init(generator, cfg),
        "norm_x": L.layernorm_init(cfg.d_model, dt, dev),
        "cross_attn": _attention_init(generator, cfg),
        "norm2": L.layernorm_init(cfg.d_model, dt, dev),
        "mlp": L.gelu_mlp_init(generator, cfg.d_model, cfg.d_ff, dt),
    }


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device``."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_enc = cfg.encoder_layers or cfg.num_layers
    enc = [_enc_layer_init(gen, cfg) for _ in range(n_enc)]
    dec = [_dec_layer_init(gen, cfg) for _ in range(cfg.num_layers)]
    pos = torch.randn((MAX_DEC_POS, cfg.d_model), generator=gen,
                      device=dev) * 0.01
    return {
        "enc_layers": enc,
        "enc_norm": L.layernorm_init(cfg.d_model, cfg.p_dtype, dev),
        "dec_embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.p_dtype),
        "dec_pos": pos.to(cfg.p_dtype),
        "dec_layers": dec,
        "dec_norm": L.layernorm_init(cfg.d_model, cfg.p_dtype, dev),
        "lm_head": linear_init(gen, cfg.d_model, cfg.vocab_size,
                               dtype=cfg.p_dtype),
    }


def _run_layers(cfg: ModelConfig, body: Callable, layers: List[Params],
                x: torch.Tensor) -> torch.Tensor:
    """``x = body(i, lp, x)`` over the layers; under a gradient and
    ``cfg.remat`` each layer's activations are recomputed in the backward
    pass instead of kept."""
    for i, lp in enumerate(layers):
        if cfg.remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(body, i, lp, x,
                                                  use_reentrant=False)
        else:
            x = body(i, lp, x)
    return x


def _chunks(cfg: ModelConfig, sq: int, skv: int) -> Dict[str, Any]:
    """``attn_impl`` and the q/kv chunks of an attention over ``sq`` query
    and ``skv`` key rows: each configured chunk where it divides its
    length, else the whole length (``layers.whole_length_chunk``). Whisper's
    1500 frames do not split into the default 512 / 1024 chunks, where the
    reference's chunked attention asserts; one whole-length tile computes
    what it means."""
    return {"attn_impl": cfg.attn_impl,
            "q_chunk": L.whole_length_chunk(cfg.q_chunk, sq),
            "kv_chunk": L.whole_length_chunk(cfg.kv_chunk, skv)}


def encoder_attention(cfg: ModelConfig, lp: Params,
                      h: torch.Tensor) -> torch.Tensor:
    """An encoder layer's attention sublayer on its normed input ``h``:
    non-causal self attention by ``cfg.attn_impl``."""
    s = h.shape[1]
    out, _ = L.attention_apply(
        lp["attn"], h, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rope_cs=None, causal=False,
        **_chunks(cfg, s, s))
    return out


def encoder_layer(cfg: ModelConfig, lp: Params,
                  x: torch.Tensor) -> torch.Tensor:
    """One encoder layer: :func:`encoder_attention`, then the GELU MLP,
    each behind a LayerNorm and a residual."""
    x = x + encoder_attention(cfg, lp,
                              L.layernorm(lp["norm1"], x, cfg.norm_eps))
    h2 = L.layernorm(lp["norm2"], x, cfg.norm_eps)
    return x + L.gelu_mlp_apply(lp["mlp"], h2)


def embed_frames(cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """The encoder's input: frames plus sinusoidal positions, in the
    activation dtype."""
    _, s, d = frames.shape
    act = cfg.act_dtype
    return frames.to(act) + L.sinusoidal_positions(s, d,
                                                   frames.device).to(act)


def encode(cfg: ModelConfig, params: Params,
           frames: torch.Tensor) -> torch.Tensor:
    """Stub frontend output ``(B, S_enc, d)`` → encoder states: sinusoidal
    positions added, non-causal layers, then ``enc_norm``."""
    _check_cfg(cfg)
    x = part.act(embed_frames(cfg, frames), "batch", "seq_sp", "embed")
    x = _run_layers(cfg, lambda i, lp, x: encoder_layer(cfg, lp, x),
                    params["enc_layers"], x)
    return L.layernorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
               pos_offset) -> torch.Tensor:
    """Token embeddings plus learned positions from ``pos_offset``: an int
    (a uniform batch) or a ``(B,)`` vector (ragged decode: each slot at
    its own position)."""
    b, s = tokens.shape
    h = L.embed(params["dec_embed"], tokens).to(cfg.act_dtype)
    if isinstance(pos_offset, int):
        pos = params["dec_pos"][pos_offset:pos_offset + s]
        return h + pos.to(h.dtype)[None]
    po = torch.as_tensor(pos_offset, device=tokens.device).reshape(-1)
    idx = (po.long().expand(b)[:, None]
           + torch.arange(s, device=tokens.device)[None])
    return h + params["dec_pos"][idx].to(h.dtype)


def _decoder(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
             cross: Callable[[int, Params], Params]) -> torch.Tensor:
    """Teacher-forced decoder forward → logits; ``cross(i, lp)`` gives
    layer ``i``'s cross-attention K/V."""
    x = part.act(_dec_embed(cfg, params, tokens, 0), "batch", "seq_sp",
                 "embed")

    def body(i, lp, x):
        h = L.layernorm(lp["norm1"], x, cfg.norm_eps)
        s = h.shape[1]
        out, _ = L.attention_apply(
            lp["self_attn"], h, n_heads=cfg.num_heads,
            n_kv=cfg.num_kv_heads, head_dim=cfg.head_dim, rope_cs=None,
            causal=True, **_chunks(cfg, s, s))
        x = x + out
        hx = L.layernorm(lp["norm_x"], x, cfg.norm_eps)
        kv = cross(i, lp)
        x = x + L.cross_attention_apply(
            lp["cross_attn"], hx, kv, n_heads=cfg.num_heads,
            n_kv=cfg.num_kv_heads, head_dim=cfg.head_dim,
            **_chunks(cfg, s, kv["k"].shape[1]))
        h2 = L.layernorm(lp["norm2"], x, cfg.norm_eps)
        return x + L.gelu_mlp_apply(lp["mlp"], h2)

    x = _run_layers(cfg, body, params["dec_layers"], x)
    x = L.layernorm(params["dec_norm"], x, cfg.norm_eps)
    return linear_apply(params["lm_head"], x)


def _cross_kv(cfg: ModelConfig, lp: Params, enc_out: torch.Tensor) -> Params:
    return L.cross_kv(lp["cross_attn"], enc_out, n_kv=cfg.num_kv_heads,
                      head_dim=cfg.head_dim)


def decode_train(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder forward over encoder states → logits ``(B,
    S, V)``."""
    _check_cfg(cfg)
    return _decoder(cfg, params, tokens,
                    lambda i, lp: _cross_kv(cfg, lp, enc_out))


def loss_fn(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token-mean fp32 cross entropy of the decoder over ``batch["frames"]``
    and ``batch["tokens"]`` against ``batch["targets"]`` (``mask``
    optional)."""
    enc_out = encode(cfg, params, batch["frames"])
    logits = decode_train(cfg, params, batch["tokens"], enc_out)
    return L.cross_entropy(logits, batch["targets"], batch.get("mask"))


def prefill(cfg: ModelConfig, params: Params, frames: torch.Tensor,
            tokens: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """Encode the audio, compute every layer's cross K/V, run the decoder
    over the prompt. Returns the last position's logits ``(B, 1, V)`` and
    ``{"cross_k", "cross_v"}`` stacked ``(L, B, S_enc, Hkv, D)``; the
    prompt's self K/V is primed by the caller through ``decode_step``. Each
    layer's cross K/V is computed once and feeds both (the reference
    computes it twice)."""
    enc_out = encode(cfg, params, frames)
    cross = [_cross_kv(cfg, lp, enc_out) for lp in params["dec_layers"]]
    logits = _decoder(cfg, params, tokens, lambda i, lp: cross[i])[:, -1:]
    return logits, {"cross_k": torch.stack([c["k"] for c in cross]),
                    "cross_v": torch.stack([c["v"] for c in cross])}


def init_cache(cfg: ModelConfig, batch: int, capacity: int, *,
               device="cuda") -> Params:
    """Zeroed decode cache in ``cfg.cache_dtype``: ``self_k``/``self_v``
    ``(L, batch, capacity, Hkv, D)`` and ``cross_k``/``cross_v`` ``(L,
    batch, cfg.encoder_seq, Hkv, D)``."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    lead = (cfg.num_layers, batch)
    tail = (cfg.num_kv_heads, cfg.head_dim)

    def zeros(n):
        return torch.zeros(lead + (n,) + tail, dtype=cfg.c_dtype, device=dev)

    return {"self_k": zeros(capacity), "self_v": zeros(capacity),
            "cross_k": zeros(cfg.encoder_seq),
            "cross_v": zeros(cfg.encoder_seq)}


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Params, cache_len) -> Tuple[torch.Tensor, Params]:
    """One decoder step: tokens ``(B, 1)`` against the self-K/V cache and
    the precomputed cross K/V → (logits ``(B, 1, V)``, cache). ``cache_len``
    is a scalar or ``(B,)``: slot b writes its self K/V at position
    ``cache_len[b]`` (in place) and attends to its own history, and to
    every row of the cross cache."""
    _check_cfg(cfg)
    b = tokens.shape[0]
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32,
                                device=tokens.device).reshape(-1).expand(b)
    x = _dec_embed(cfg, params, tokens, cache_len)
    for i, lp in enumerate(params["dec_layers"]):
        h = L.layernorm(lp["norm1"], x, cfg.norm_eps)
        out, _ = L.attention_apply(
            lp["self_attn"], h, n_heads=cfg.num_heads,
            n_kv=cfg.num_kv_heads, head_dim=cfg.head_dim, rope_cs=None,
            cache={"k": cache["self_k"][i], "v": cache["self_v"][i]},
            cache_len=cache_len)
        x = x + out
        hx = L.layernorm(lp["norm_x"], x, cfg.norm_eps)
        x = x + L.cross_attention_apply(
            lp["cross_attn"], hx,
            {"k": cache["cross_k"][i], "v": cache["cross_v"][i]},
            n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
            head_dim=cfg.head_dim)
        h2 = L.layernorm(lp["norm2"], x, cfg.norm_eps)
        x = x + L.gelu_mlp_apply(lp["mlp"], h2)
    x = L.layernorm(params["dec_norm"], x, cfg.norm_eps)
    return linear_apply(params["lm_head"], x), cache
