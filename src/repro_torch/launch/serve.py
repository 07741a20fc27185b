"""Serving entry point of the port: BCR-pack a dense causal LM and serve it
through the paged continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --slots 8 --capacity 640 --page-size 16 --bcr-keep 0.25 \\
        --bcr-block 128 --requests 16 --prompt-len 128 --gen 32

runs on the card (``--device cuda``, the default); ``--device cpu --smoke``
runs the plain PyTorch path at smoke size. ``generate`` is the naive oracle
the engine is held to: one batched exact-length prefill, then step-by-step
greedy decode over a fixed page table.
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
from repro_torch.core.bcr import BCRSpec, choose_block_shape, kept_align
from repro_torch.core.bcrc import TBCRC, tbcrc_pack
from repro_torch.kernels.plan import GroupedTBCRC, fuse_packed_projections
from repro_torch.models import causal_lm
from repro_torch.serving import EngineConfig, InferenceEngine

PyTree = Any


def default_prune_filter(cfg: ModelConfig):
    """BCR on every 2-D projection weight named 'w' (attention and MLP
    projections + lm_head), excluding embeddings and norms — the paper's
    FC/GEMM scope. A copy of the reference's ``launch/train.py`` filter."""
    if cfg.bcr_keep_frac <= 0:
        return lambda name, leaf: None

    def fil(name: str, leaf: torch.Tensor) -> Optional[BCRSpec]:
        if not name.endswith("['w']"):
            return None
        if "embed" in name:
            return None
        if leaf.dim() < 2 or min(leaf.shape[-2:]) < 2 * min(cfg.bcr_block):
            return None
        block = choose_block_shape(tuple(leaf.shape[-2:]), cfg.bcr_block)
        return BCRSpec(block_shape=block, keep_frac=cfg.bcr_keep_frac,
                       align=kept_align(block))

    return fil


def _cast_vals(tree: Any, dtype: torch.dtype) -> Any:
    if isinstance(tree, (TBCRC, GroupedTBCRC)):
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

    Afterwards the packed ``vals`` are cast to the activation dtype
    ``cfg.dtype``: the reference's TPU kernel casts its tiles to the
    activation dtype on every grid step; here that cast happens once, at
    pack time, and the kernels stream tiles already in that dtype."""
    if weight_dtype:
        raise NotImplementedError(
            f"weight_dtype={weight_dtype!r}: int8 packed weights come in the "
            f"next slice of the port")
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
                 device="cuda") -> PyTree:
    """Random weights from a seeded generator on ``device``, BCR-packed when
    ``cfg.bcr_keep_frac > 0``."""
    params = causal_lm.init_params(cfg, seed, device=resolve_device(device))
    if cfg.bcr_keep_frac > 0:
        packed = pack_params(cfg, params)
        log(f"packed weight bytes: {packed_fraction(params, packed):.3f}x "
            f"dense")
        params = packed
    return params


def generate(cfg: ModelConfig, params: PyTree, prompts: torch.Tensor, *,
             gen_tokens: int, page_size: int = 16) -> Dict[str, torch.Tensor]:
    """Naive greedy oracle: prefill a batch of equal-length prompts at their
    exact length, seat the KV into a fixed page table (slot b owns pages
    ``1 + b·max_pages ...``), then decode ``gen_tokens - 1`` steps.

    Returns ``tokens`` (B, gen_tokens) and ``logits`` (B, gen_tokens, V):
    the distribution each emitted token was taken from."""
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
        for key in ("k", "v"):
            pool[key].view(-1, *pool[key].shape[2:]).index_copy_(
                0, dest.reshape(-1),
                new[key].reshape(-1, *new[key].shape[2:]).to(pool[key].dtype))
    lens = torch.full((b,), p, dtype=torch.int32, device=dev)
    step_logits = [logits[:, -1].float()]
    toks = [torch.argmax(step_logits[-1], dim=-1).to(torch.int32)]
    for i in range(gen_tokens - 1):
        logits, cache = causal_lm.decode_step(
            cfg, params, toks[-1][:, None], cache, lens + i,
            block_tables=table)
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
    args = p.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, bcr_keep_frac=args.bcr_keep)
    if args.bcr_block or args.smoke:
        b = args.bcr_block or 16
        cfg = dataclasses.replace(cfg, bcr_block=(b, b))
    dev = resolve_device(args.device)
    params = build_params(cfg, seed=args.seed, device=dev)
    engine = InferenceEngine(cfg, params, EngineConfig(
        n_slots=args.slots, capacity=args.capacity,
        page_size=args.page_size, seed=args.seed), device=dev)
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


if __name__ == "__main__":
    main()
