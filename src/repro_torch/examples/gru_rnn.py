"""Paper-faithful RNN workload: a 2-layer GRU (the paper's ESE comparison).

Trains the GRU on a synthetic sequence task, BCR-prunes it at 10x with the
hard-mask schedule, packs, and measures the per-timestep latency unit the
paper reports (81 µs on an Adreno 640): here the step's wall time on the
device it runs on, beside the card's byte bound (the weight bytes a step
reads over the H100's 3.35 TB/s).

    PYTHONPATH=src python -m repro_torch.examples.gru_rnn [--device cpu]
"""

import argparse
import subprocess
import time

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import admm
from repro_torch.core.bcr import BCRSpec, choose_block_shape
from repro_torch.data.pipeline import sequence_dataset
from repro_torch.launch.serve import pack_params, tree_bytes
from repro_torch.models.gru import gru_apply, gru_init, gru_step_latency_fn
from repro_torch.optim import adamw
from repro_torch.tree import leaves, unflatten

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
VOCAB, SEQ, CLASSES, D = 64, 24, 8, 96


def prune_filter(path: str, leaf: torch.Tensor):
    """The example's BCR spec: every 2-D ``w`` in (8, 8)-targeted blocks,
    keep 0.1, kept counts on a granule of 2."""
    if not path.endswith("['w']") or leaf.dim() != 2:
        return None
    return BCRSpec(block_shape=choose_block_shape(tuple(leaf.shape), (8, 8)),
                   keep_frac=0.1, align=2)


def serving_config(d_model: int = D, vocab: int = VOCAB,
                   dtype: str = "float32") -> ModelConfig:
    """The config ``pack_params`` packs the GRU under: BCR keep 0.1 in
    (8, 8)-targeted blocks (the head, too small for them, stays dense);
    packed vals in ``dtype``, the GRU's activation dtype."""
    return ModelConfig(name="gru", family="dense", num_layers=2,
                       d_model=d_model, num_heads=1, num_kv_heads=1,
                       head_dim=d_model, d_ff=d_model, vocab_size=vocab,
                       bcr_keep_frac=0.1, bcr_block=(8, 8), dtype=dtype)


def masked(params, masks):
    """``params`` with every masked leaf multiplied by its mask."""
    if masks is None:
        return params
    return unflatten(params, [w if m is None else w * m
                              for w, m in zip(leaves(params), leaves(masks))])


def loss_fn(params, masks, x, y):
    logits = gru_apply(masked(params, masks), x)
    return F.cross_entropy(logits.float(), y.long())


def train(params, x, y, steps: int, log=print):
    """The example's recipe on ``params`` (trained in place): AdamW (lr 5e-3,
    10 warmup steps, no decay) on dense weights; at ``steps // 3`` the BCR
    masks are frozen (``admm.finalize``, which also projects the weights)
    and AdamW restarts; the remaining steps retrain under the masks through
    autograd. Returns ``(params, masks, losses)``."""
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    opt_cfg = adamw.AdamWConfig(lr=5e-3, warmup_steps=10, total_steps=steps,
                                weight_decay=0.0)
    opt = adamw.init(params)
    specs = admm.specs_for(params, prune_filter)
    masks, losses = None, []
    for s in range(steps):
        if s == steps // 3:
            _, masks = admm.finalize(params, specs)
            opt = adamw.init(params)
            log(f"step {s}: BCR masks frozen (10x), retraining")
        loss = loss_fn(params, masks, x, y)
        grads = torch.autograd.grad(loss, leaves(params))
        params, opt, _ = adamw.update(opt_cfg, unflatten(params, list(grads)),
                                      opt, params)
        losses.append(float(loss.detach()))
        if s % 40 == 0:
            log(f"step {s:4d} loss {losses[-1]:.4f}")
    return params, masks, losses


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name()


def step_wall_us(fn, h, x, reps: int = 50) -> float:
    """Mean wall time of one ``fn(h, x)``, after one warm call; each call
    ends in a synchronise on the card."""
    sync = torch.cuda.synchronize if h.is_cuda else (lambda: None)
    fn(h, x)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(h, x)
        sync()
    return (time.perf_counter() - t0) / reps * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=240)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    x, y = sequence_dataset(n=1500, seq=SEQ, vocab=VOCAB, classes=CLASSES)
    xd = torch.as_tensor(x, device=dev)
    yd = torch.as_tensor(y, device=dev).long()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = gru_init(gen, VOCAB, D, 2, CLASSES)
    params, masks, _ = train(params, xd, yd, args.steps)

    with torch.no_grad():
        params = masked(unflatten(params, [w.detach()
                                           for w in leaves(params)]), masks)
        acc = float((gru_apply(params, xd).argmax(-1) == yd).float().mean())
        print(f"final accuracy at 10x BCR: {acc:.3f}")

        # --- serving latency unit (paper: GRU step, batch 32) -------------
        packed = pack_params(serving_config(), params)
        h = torch.zeros((32, D), device=dev)
        xt = torch.randn((32, D), generator=gen, device=dev)
        where = "card" if dev.type == "cuda" else "host CPU"
        for name, prm in [("dense", params), ("bcr-packed", packed)]:
            us = step_wall_us(gru_step_latency_fn(prm), h, xt)
            print(f"{name:12s} GRU step (batch 32): {us:8.1f} us ({where} "
                  f"wall)")

    # what a step reads: the cells' weights (and, packed, their indices)
    wb_d, wb_p = tree_bytes(params["cells"]), tree_bytes(packed["cells"])
    card = card_line() if dev.type == "cuda" else "no card in this run"
    print(f"H100 byte bound of a GRU step (weight bytes / 3.35 TB/s; "
          f"{card}): dense {wb_d / HBM_BYTES_PER_S * 1e6:.3f} us vs packed "
          f"{wb_p / HBM_BYTES_PER_S * 1e6:.3f} us ({wb_d / wb_p:.1f}x from "
          f"weight traffic)")
    print("OK")


if __name__ == "__main__":
    main()
