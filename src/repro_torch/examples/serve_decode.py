"""Batched serving with BCR-packed weights — the GRIM deployment path.

Initializes an LM, BCR-projects and packs every linear, and runs batched
prefill + greedy decode twice (the static loop, ``generate_static``):
projected dense weights against packed weights. The greedy tokens must
agree (the packed model is the projected model); prints the weight-traffic
reduction a decode step then streams.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        --arch llama3.2-1b --bcr-keep 0.25 --batch 4 --gen 12 [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

import argparse
import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import admm as admm_mod
from repro_torch.launch.serve import (ServeConfig, generate_static,
                                      pack_params, packed_fraction)
from repro_torch.launch.train import default_prune_filter
from repro_torch.models.api import model_fns


def project(cfg: ModelConfig, params: Any) -> Any:
    """Hard BCR projection of every prunable linear (training's ADMM does
    this with accuracy in mind; here it is done directly)."""
    specs = admm_mod.specs_for(params, default_prune_filter(cfg))
    projected, _ = admm_mod.finalize(params, specs)
    return projected


def dense_vs_packed(cfg: ModelConfig, projected: Any, sc: ServeConfig,
                    prompts: Optional[torch.Tensor] = None,
                    log=print) -> Dict[str, Any]:
    """Greedy tokens of the static loop over the projected dense weights
    and over their pack, and the packed bytes over the dense bytes."""
    log("== dense (BCR-projected) weights ==")
    dense = generate_static(cfg, projected, sc, prompts=prompts, log=log)
    log("== TBCRC-packed weights ==")
    packed = pack_params(cfg, projected)
    frac = packed_fraction(projected, packed)
    log(f"packed weight bytes: {frac:.3f}x dense "
        f"(-> ~{1 / frac:.1f}x less weight traffic per decode step)")
    out = generate_static(cfg, packed, sc, prompts=prompts, log=log)
    return dict(dense=dense["tokens"], packed=out["tokens"], fraction=frac)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--bcr-keep", type=float, default=0.25)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(get_smoke_config(args.arch),
                              bcr_keep_frac=args.bcr_keep,
                              bcr_block=(16, 16))
    params = model_fns(cfg).init_params(0, device=dev)
    sc = ServeConfig(batch=args.batch, prompt_len=8, gen_tokens=args.gen,
                     capacity=64)
    out = dense_vs_packed(cfg, project(cfg, params), sc)
    match = torch.equal(out["dense"], out["packed"])
    print(f"greedy tokens identical: {match}")
    assert match, "packed serving must reproduce projected-dense outputs"
    print("OK")


if __name__ == "__main__":
    main()
