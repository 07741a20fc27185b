"""PyTorch port of the GRIM reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it. Entry points (``launch.serve.build_params``, ``serving.InferenceEngine``,
``launch.serve.generate``, the CLI) run on the card unless the caller passes
``device="cpu"``. Hand-written CUDA kernels live in ``kernels/csrc`` and are
built with ``nvcc`` at first use (``kernels/build.py``); on CPU tensors every
kernel wrapper runs its plain PyTorch version instead.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of every
    entry point) raises when no card is visible instead of quietly running
    on the CPU; the CPU is used only when a caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
