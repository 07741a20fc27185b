"""End-to-end LM training driver: dense warmup → ADMM-BCR pruning →
mask-frozen retraining, with async checkpointing and resume.

Presets:
  --preset tiny  :  ~1M params, about a minute on a CPU (default)
  --preset 100m  :  ~100M-param llama-style model, a few hundred steps
                    (the end-to-end driver; minutes on the card)

    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset tiny \\
        --steps 60 --admm-start 20 --retrain-start 40 \\
        --ckpt-dir /tmp/lm_ckpt [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

import argparse

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bcr import density
from repro_torch.launch.train import TrainerConfig, train_loop
from repro_torch.optim import adamw
from repro_torch.tree import leaves

PRESETS = {
    "tiny": ModelConfig(
        name="tiny-lm", family="dense", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        dtype="float32", attn_impl="dense", bcr_keep_frac=0.25,
        bcr_block=(32, 32)),
    "100m": ModelConfig(
        name="lm-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32768, dtype="bfloat16", attn_impl="flash",
        bcr_keep_frac=0.25, bcr_block=(128, 128)),
}


def mask_densities(state) -> list:
    """Kept density of every frozen BCR mask (empty before retraining)."""
    if state.masks is None:
        return []
    return [float(density(m)) for m in leaves(state.masks) if m is not None]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="tiny", choices=list(PRESETS))
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--admm-start", type=int, default=None)
    p.add_argument("--retrain-start", type=int, default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = PRESETS[args.preset]
    tc = TrainerConfig(
        steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 3, 10),
        admm_start=args.admm_start, retrain_start=args.retrain_start,
        data_kind="markov", device=args.device)
    out = train_loop(cfg, tc, adamw.AdamWConfig(lr=args.lr,
                                                total_steps=args.steps))

    hist = out["history"]
    print(f"\nloss: first={hist[0]:.4f}  last={hist[-1]:.4f}  "
          f"improved={hist[0] - hist[-1]:.4f}")
    dens = mask_densities(out["state"])
    if dens:
        print(f"BCR-pruned tensors: {len(dens)}; mean kept density "
              f"{sum(dens) / len(dens):.3f} "
              f"(pruning rate {len(dens) / max(sum(dens), 1e-9):.1f}x)")
    assert hist[-1] < hist[0], "training must reduce loss"
    print("OK")
    return out


if __name__ == "__main__":
    main()
