"""Serving entry point of the port: BCR-pack a dense causal LM and serve it
through the paged continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --slots 8 --capacity 640 --page-size 16 --bcr-keep 0.25 \\
        --bcr-block 128 --requests 16 --prompt-len 128 --gen 32

runs on the card (``--device cuda``, the default); ``--device cpu --smoke``
runs the plain PyTorch path at smoke size. ``--kv-dtype int8 --weight-dtype
int8`` serves the quantized path (int8 KV pages, int8 packed tiles) and
``--attn-impl pallas`` runs cold prefill through the fused flash kernel.
``generate`` is the naive oracle the engine is held to: one batched
exact-length prefill, then step-by-step greedy decode over a fixed page
table.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bcrc import TBCRC, tbcrc_pack
from repro_torch.kernels.plan import (GroupedTBCRC, fuse_packed_projections,
                                     quantize_packed_params)
from repro_torch.launch.train import default_prune_filter
from repro_torch.models import causal_lm
from repro_torch.models.layers import FLASH_ATTN_IMPLS, PLAIN_ATTN_IMPLS
from repro_torch.serving import EngineConfig, InferenceEngine

PyTree = Any


def _cast_vals(tree: Any, dtype: torch.dtype) -> Any:
    """Cast fp packed vals to ``dtype``; int8 codes stay int8."""
    if isinstance(tree, (TBCRC, GroupedTBCRC)):
        if tree.vals.dtype == torch.int8:
            return tree
        return dataclasses.replace(tree, vals=tree.vals.to(dtype))
    if isinstance(tree, dict):
        return {k: _cast_vals(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_vals(v, dtype) for v in tree]
    return tree


def pack_params(cfg: ModelConfig, params: PyTree, *,
                weight_dtype: str = "") -> PyTree:
    """Replace every prunable linear's ``{"w"}`` with ``{"w_packed": TBCRC}``
    and fuse projections sharing one activation (Q/K/V or K/V, gate/up) into
    grouped entries.

    ``weight_dtype="int8"`` then quantizes every packed tile, fused groups
    included, to int8 codes with one fp32 scale per tile (from the
    param-dtype vals, as the reference does; per-tile scales make the
    result the same before or after fusion).

    Afterwards fp packed ``vals`` are cast to the activation dtype
    ``cfg.dtype``: the reference's TPU kernel casts its tiles to the
    activation dtype on every grid step; here that cast happens once, at
    pack time, and the kernels stream tiles already in that dtype. int8
    codes stay int8."""
    if weight_dtype not in ("", "int8"):
        raise ValueError(f"unsupported weight_dtype {weight_dtype!r}")
    fil = default_prune_filter(cfg)

    def rewrite(node, path=""):
        if isinstance(node, dict) and isinstance(node.get("w"), torch.Tensor):
            spec = fil(path + "['w']", node["w"])
            if spec is not None:
                out = {"w_packed": tbcrc_pack(node["w"], spec)}
                if "b" in node:
                    out["b"] = node["b"]
                return out
        if isinstance(node, dict):
            return {k: rewrite(v, f"{path}['{k}']") for k, v in node.items()}
        if isinstance(node, list):
            return [rewrite(v, f"{path}[{i}]") for i, v in enumerate(node)]
        return node

    packed = fuse_packed_projections(rewrite(params))
    if weight_dtype:
        packed = quantize_packed_params(packed)
    return _cast_vals(packed, cfg.act_dtype)


def tree_bytes(tree: Any) -> int:
    if isinstance(tree, (TBCRC, GroupedTBCRC)):
        return tree.nbytes()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return 0


def packed_fraction(params: PyTree, packed: PyTree) -> float:
    """Bytes of the packed tree (tiles + indices + plan vectors) over the
    bytes of the dense tree it came from."""
    return tree_bytes(packed) / tree_bytes(params)


def build_params(cfg: ModelConfig, log=print, *, seed: int = 0,
                 device="cuda", weight_dtype: str = "") -> PyTree:
    """Random weights from a seeded generator on ``device``, BCR-packed when
    ``cfg.bcr_keep_frac > 0`` (int8 tiles with ``weight_dtype="int8"``)."""
    params = causal_lm.init_params(cfg, seed, device=resolve_device(device))
    if cfg.bcr_keep_frac > 0:
        packed = pack_params(cfg, params, weight_dtype=weight_dtype)
        log(f"packed weight bytes: {packed_fraction(params, packed):.3f}x "
            f"dense")
        params = packed
    return params


def generate(cfg: ModelConfig, params: PyTree, prompts: torch.Tensor, *,
             gen_tokens: int, page_size: int = 16,
             forced: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
    """Naive greedy oracle: prefill a batch of equal-length prompts at their
    exact length, seat the KV (codes and scales under ``kv_dtype="int8"``)
    into a fixed page table (slot b owns pages ``1 + b·max_pages ...``),
    then decode ``gen_tokens - 1`` steps.

    Returns ``tokens`` (B, gen_tokens) and ``logits`` (B, gen_tokens, V):
    the distribution each emitted token was taken from. With ``forced``
    (B, gen_tokens) each step is fed ``forced[:, i]`` instead of its own
    argmax (teacher forcing), so ``tokens`` holds this model's greedy pick
    at every position of a fixed trajectory."""
    prompts = torch.as_tensor(prompts)
    dev = params["embed"]["table"].device
    prompts = prompts.to(device=dev, dtype=torch.int32)
    b, p = prompts.shape
    logits, pcache = causal_lm.prefill(cfg, params, prompts)
    max_pages = -(-(p + gen_tokens) // page_size)
    cache = causal_lm.init_cache(cfg, kv_pages=b * max_pages + 1,
                                 page_size=page_size, device=dev)
    table = (1 + torch.arange(b * max_pages, device=dev,
                              dtype=torch.int32)).reshape(b, max_pages)
    pos = torch.arange(p, device=dev)
    dest = (table[:, pos // page_size].long() * page_size + pos % page_size)
    for pool, new in zip(cache, pcache):
        for key, leaf in pool.items():
            leaf.view(-1, *leaf.shape[2:]).index_copy_(
                0, dest.reshape(-1),
                new[key].reshape(-1, *leaf.shape[2:]).to(leaf.dtype))
    lens = torch.full((b,), p, dtype=torch.int32, device=dev)
    step_logits = [logits[:, -1].float()]
    toks = [torch.argmax(step_logits[-1], dim=-1).to(torch.int32)]
    if forced is not None:
        forced = torch.as_tensor(forced).to(device=dev, dtype=torch.int32)
    for i in range(gen_tokens - 1):
        feed = toks[-1] if forced is None else forced[:, i]
        logits, cache = causal_lm.decode_step(
            cfg, params, feed[:, None], cache, lens + i, block_tables=table)
        step_logits.append(logits[:, -1].float())
        toks.append(torch.argmax(step_logits[-1], dim=-1).to(torch.int32))
    return {"tokens": torch.stack(toks, dim=1),
            "logits": torch.stack(step_logits, dim=1)}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--capacity", type=int, default=128)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--bcr-keep", type=float, default=0.0)
    p.add_argument("--bcr-block", type=int, default=0,
                   help="BCR block side; 0 → 16 for --smoke configs, else "
                        "the config default")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--kv-dtype", default="", choices=["", "int8"],
                   help="int8: KV pages as int8 codes + per-row, per-kv-head "
                        "fp32 scales, read by the paged kernel's int8 form")
    p.add_argument("--weight-dtype", default="", choices=["", "int8"],
                   help="int8: packed BCR tiles as int8 codes + one fp32 "
                        "scale per tile (needs --bcr-keep)")
    p.add_argument("--attn-impl", default="",
                   choices=["", *FLASH_ATTN_IMPLS, *PLAIN_ATTN_IMPLS],
                   help="cold-prefill attention; pallas: the fused flash "
                        "kernel; empty keeps the config's")
    args = p.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, bcr_keep_frac=args.bcr_keep)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    if args.weight_dtype and args.bcr_keep <= 0:
        p.error("--weight-dtype int8 quantizes packed tiles: it needs "
                "--bcr-keep")
    if args.bcr_block or args.smoke:
        b = args.bcr_block or 16
        cfg = dataclasses.replace(cfg, bcr_block=(b, b))
    dev = resolve_device(args.device)
    params = build_params(cfg, seed=args.seed, device=dev,
                          weight_dtype=args.weight_dtype)
    engine = InferenceEngine(cfg, params, EngineConfig(
        n_slots=args.slots, capacity=args.capacity,
        page_size=args.page_size, seed=args.seed, kv_dtype=args.kv_dtype,
        weight_dtype=args.weight_dtype), device=dev)
    pmax = args.capacity - args.gen
    if pmax < 1:
        p.error(f"--capacity {args.capacity} leaves no room for prompts "
                f"after --gen {args.gen}")
    plens = sorted({min(max(x, 1), pmax) for x in
                    (max(4, args.prompt_len // 2), args.prompt_len,
                     args.prompt_len * 2)})
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        n = int(rng.choice(plens))
        engine.submit(rng.integers(0, cfg.vocab_size, size=n),
                      max_new_tokens=args.gen)
    t0 = time.perf_counter()
    done = engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    ttft = np.array([r.first_token_time - r.submit_time for r in done])
    toks = engine.stats["tokens_generated"]
    print(f"{len(done)} requests, {toks} tokens in {wall:.3f} s: "
          f"{toks / wall:.1f} tokens/s; {engine.stats['decode_steps']} decode "
          f"steps, {engine.stats['prefills']} prefills")
    print(f"TTFT p50/p95: {np.percentile(ttft, 50) * 1e3:.1f}/"
          f"{np.percentile(ttft, 95) * 1e3:.1f} ms")
    print(f"KV bytes read over live pages: "
          f"{engine.stats['kv_bytes_read_live']} ({engine._kv_row_bytes} "
          f"bytes per cached position, all layers, K + V)")


if __name__ == "__main__":
    main()
