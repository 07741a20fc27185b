"""Uniform model API: the functions the engine and the launchers call.

    fns = model_fns(cfg)   # init_params / loss_fn / prefill / decode_step
                           # / init_cache / prefill_append

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
from typing import Callable, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import causal_lm, encdec


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
    # the top-level keys whose layers the reference stacks on a leading
    # axis (its weight-decay mask sees that layout: ``adamw.decay_mask``)
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
        stacked=("layers",) if cfg.scan_layers else (),
    )
