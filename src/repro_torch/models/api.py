"""Uniform model API: the functions the engine and the launchers call.

    fns = model_fns(cfg)   # init_params / loss_fn / prefill / decode_step
                           # / init_cache / prefill_append

Batches are dicts of tensors, as in the reference package. The dense, MoE,
vlm, ssm and hybrid families are ported; all run through ``causal_lm`` (a
MoE layer's routing reads the batch's optional ``token_mask``, a vlm
prefill its optional ``image_embeds``). The encdec family raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import causal_lm


@dataclasses.dataclass(frozen=True)
class ModelFns:
    init_params: Callable       # (seed, *, device) -> params
    loss_fn: Callable           # (params, batch) -> scalar loss
    prefill: Callable           # (params, batch) -> (logits, cache)
    decode_step: Callable       # (params, batch, cache) -> (logits, cache)
    # (batch, capacity, *, device) -> capacity-dense cache, or
    # (*, kv_pages, page_size, device) -> paged cache
    init_cache: Callable
    prefill_append: Callable    # (params, batch, cache) -> (logits, cache)


def model_fns(cfg: ModelConfig) -> ModelFns:
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
    )
