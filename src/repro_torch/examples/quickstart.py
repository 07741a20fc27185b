"""Quickstart: the GRIM/BCR pipeline in 60 lines.

1. Take a dense weight matrix.
2. BCR-project it (the paper's fine-grained structured sparsity).
3. Pack survivors into TBCRC (the kernel format; BCRC for storage).
4. Run the block-sparse matmul (the CUDA kernel on the card, its plain
   version on the CPU) and check it against the dense oracle.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core.bcr import BCRSpec, bcr_mask, bcr_project, density
from repro_torch.core.bcrc import (bcrc_pack, csr_extra_bytes, tbcrc_pack,
                                   tbcrc_stats)
from repro_torch.kernels.ops import bcr_matmul
from repro_torch.kernels.ref import bcr_spmm_ref


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, k = 512, 1024
    w = torch.randn((n, k), generator=gen, device=dev)

    # --- 1+2: BCR pruning at 8x (keep 1/8 of weights) -------------------
    spec = BCRSpec(block_shape=(64, 128), keep_frac=0.125, align=8)
    w_sparse = bcr_project(w, spec)
    dens = float(density(bcr_mask(w, spec)))
    print(f"density after BCR projection: {dens:.4f}"
          f"  (pruning rate {1 / dens:.1f}x)")

    # --- 3: pack ----------------------------------------------------------
    packed = tbcrc_pack(w, spec)
    stats = tbcrc_stats(packed)
    print(f"TBCRC packed: {stats['packed_bytes'] / 1e3:.1f} kB vs dense "
          f"{stats['dense_bytes'] / 1e3:.1f} kB -> {stats['compression']:.1f}x "
          f"less weight traffic per decode step")

    w_np = w_sparse.cpu().numpy()
    storage = bcrc_pack(w_np)
    print(f"BCRC index overhead: {storage.nbytes_extra() / 1e3:.1f} kB vs CSR "
          f"{csr_extra_bytes(w_np) / 1e3:.1f} kB")

    # --- 4: the kernel ------------------------------------------------------
    x = torch.randn((8, k), generator=gen, device=dev)
    y_kernel = bcr_matmul(x, packed)
    y_oracle = bcr_spmm_ref(x, packed)
    err = float((y_kernel - y_oracle).abs().max())
    what = "CUDA kernel" if dev.type == "cuda" else "plain version (CPU)"
    print(f"{what} vs oracle: max |err| = {err:.2e}")
    assert err < 1e-4
    print("OK")


if __name__ == "__main__":
    main()
