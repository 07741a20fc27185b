"""Uniform model API: the functions the engine and the launchers call.

    fns = model_fns(cfg)   # init_params / prefill / decode_step / init_cache
                           # / prefill_append

Batches are dicts of tensors, as in the reference package. Only the dense
family is ported so far.
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
    prefill: Callable           # (params, batch) -> (logits, cache)
    decode_step: Callable       # (params, batch, cache) -> (logits, cache)
    init_cache: Callable        # (*, kv_pages, page_size, device) -> cache
    prefill_append: Callable    # (params, batch, cache) -> (logits, cache)


def model_fns(cfg: ModelConfig) -> ModelFns:
    causal_lm._check_family(cfg)
    return ModelFns(
        init_params=functools.partial(causal_lm.init_params, cfg),
        prefill=lambda p, b: causal_lm.prefill(
            cfg, p, b["tokens"], length=b.get("length")),
        decode_step=lambda p, b, c: causal_lm.decode_step(
            cfg, p, b["tokens"], c, b["cache_len"], b.get("block_tables")),
        init_cache=functools.partial(causal_lm.init_cache, cfg),
        prefill_append=lambda p, b, c: causal_lm.prefill_append(
            cfg, p, b["tokens"], c, b["prefix_len"], b["block_tables"],
            length=b.get("length"), all_logits=b.get("all_logits", False)),
    )
