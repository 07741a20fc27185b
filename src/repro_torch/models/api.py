"""Uniform model API: the functions the engine and the launchers call, and
the inputs of each assigned shape cell.

    fns = model_fns(cfg)   # init_params / loss_fn / prefill / decode_step
                           # / init_cache / prefill_append
    specs = input_specs(cfg, shape)     # meta-device tensors, no storage
    inputs = synth_inputs(cfg, shape, seed, device=...)   # the same, filled

Batches are dicts of tensors, as in the reference package. The dense, MoE,
vlm, ssm and hybrid families run through ``causal_lm`` (a MoE layer's
routing reads the batch's optional ``token_mask``, a vlm prefill its
optional ``image_embeds``); the encdec family through ``encdec``, whose
batches carry ``frames`` (prefill, loss) and which has no
``prefill_append`` (None).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import causal_lm, encdec
from repro_torch.tree import flatten, unflatten


@dataclasses.dataclass(frozen=True)
class ModelFns:
    init_params: Callable       # (seed, *, device) -> params
    loss_fn: Callable           # (params, batch) -> scalar loss
    prefill: Callable           # (params, batch) -> (logits, cache)
    decode_step: Callable       # (params, batch, cache) -> (logits, cache)
    # (batch, capacity, *, device) -> capacity-dense cache, or
    # (*, kv_pages, page_size, device) -> paged cache
    init_cache: Callable
    # (params, batch, cache) -> (logits, cache); None for families without
    # a paged prefix-append path (encdec)
    prefill_append: Optional[Callable] = None
    # the subtrees (tree paths) whose leaves the reference stacks on a
    # leading axis (its weight-decay mask sees that layout:
    # ``adamw.decay_mask``)
    stacked: Tuple[str, ...] = ()


def model_fns(cfg: ModelConfig) -> ModelFns:
    if cfg.family == "encdec":
        encdec._check_cfg(cfg)
        return ModelFns(
            init_params=functools.partial(encdec.init_params, cfg),
            loss_fn=functools.partial(encdec.loss_fn, cfg),
            prefill=lambda p, b: encdec.prefill(cfg, p, b["frames"],
                                                b["tokens"]),
            decode_step=lambda p, b, c: encdec.decode_step(
                cfg, p, b["tokens"], c, b["cache_len"]),
            init_cache=functools.partial(encdec.init_cache, cfg),
            stacked=encdec.STACKED,
        )
    causal_lm._check_cfg(cfg)
    return ModelFns(
        init_params=functools.partial(causal_lm.init_params, cfg),
        loss_fn=functools.partial(causal_lm.loss_fn, cfg),
        prefill=lambda p, b: causal_lm.prefill(
            cfg, p, b["tokens"], image_embeds=b.get("image_embeds"),
            length=b.get("length"), token_mask=b.get("token_mask")),
        decode_step=lambda p, b, c: causal_lm.decode_step(
            cfg, p, b["tokens"], c, b["cache_len"], b.get("block_tables"),
            token_mask=b.get("token_mask")),
        init_cache=functools.partial(causal_lm.init_cache, cfg),
        prefill_append=lambda p, b, c: causal_lm.prefill_append(
            cfg, p, b["tokens"], c, b["prefix_len"], b["block_tables"],
            length=b.get("length"), all_logits=b.get("all_logits", False)),
        stacked=causal_lm.stacked_layers(cfg),
    )


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Every model input of the cell ``cfg`` × ``shape`` as tensors on the
    ``meta`` device (shape and dtype, no storage), as the reference's
    ``input_specs`` gives ``ShapeDtypeStruct`` stand-ins.

    ``{"batch": ...}``: a train cell has ``tokens`` and ``targets`` (B, S)
    int32, plus ``frames`` (B, S, d) for encdec and ``image_embeds`` (B,
    num_image_tokens, d) for a vlm, in the activation dtype; a prefill cell
    has ``tokens`` (an encdec model's a 16-token task prompt beside its
    frames). A decode cell adds ``"cache"``, the family's capacity-dense
    cache at capacity S (the port's per-layer layout), and its batch has
    ``tokens`` (B, 1) and a per-slot ``cache_len`` (B,)."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=meta)

    def tok():
        return spec((b, s), torch.int32)

    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {"tokens": tok()}
        if shape.kind == "train":
            batch["targets"] = tok()
        if cfg.family == "encdec":
            batch["frames"] = spec((b, s, cfg.d_model), cfg.act_dtype)
            if shape.kind == "prefill":
                batch["tokens"] = spec((b, 16), torch.int32)  # task prompt
        if cfg.num_image_tokens:
            batch["image_embeds"] = spec((b, cfg.num_image_tokens,
                                          cfg.d_model), cfg.act_dtype)
        return {"batch": batch}
    if shape.kind == "decode":
        cache = model_fns(cfg).init_cache(b, s, device=meta)
        return {"batch": {"tokens": spec((b, 1), torch.int32),
                          "cache_len": spec((b,), torch.int32)},
                "cache": cache}
    raise ValueError(shape.kind)


def synth_inputs(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0, *,
                 device="cuda") -> Dict[str, Any]:
    """Concrete random inputs matching :func:`input_specs`, on ``device``
    (the card unless the caller asks for the CPU), by the reference's
    rules: ``cache_len`` is ``seq_len - 1``; every other integer leaf is
    uniform in ``[0, min(vocab_size, 1024))``; float leaves are ``N(0, 1) ×
    0.02`` in their dtype (the activation dtype for frames and
    ``image_embeds``).

    The draws come from one ``torch.Generator`` on ``device`` seeded with
    ``seed``, leaf after leaf in the specs' nesting order, so the same seed
    gives the same inputs on one device. They cannot be bit-equal to the
    reference's ``jax.random`` draws (another generator); only the shapes,
    dtypes, ranges and rules are the reference's."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    high = min(cfg.vocab_size, 1024)

    def materialize(path, spec):
        if not spec.dtype.is_floating_point:
            if "cache_len" in path:
                return torch.full(spec.shape, shape.seq_len - 1,
                                  dtype=spec.dtype, device=dev)
            return torch.randint(0, high, spec.shape, generator=gen,
                                 device=dev).to(spec.dtype)
        return (torch.randn(spec.shape, generator=gen, device=dev)
                * 0.02).to(spec.dtype)

    specs = input_specs(cfg, shape)
    return unflatten(specs, [materialize(path, spec)
                             for path, spec in flatten(specs)])
