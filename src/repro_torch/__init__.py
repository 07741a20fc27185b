"""PyTorch port of the GRIM reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it. Entry points (``launch.serve.build_params``, ``serving.InferenceEngine``,
``launch.serve.generate`` and ``run_traffic``, ``serving.start_in_thread``,
the ``launch.serve``, ``launch.api`` and ``launch.train`` CLIs) run on the
card unless the caller passes ``device="cpu"``. Hand-written CUDA kernels
live in ``kernels/csrc`` and are built with ``nvcc`` at first use
(``kernels/build.py``) or by ``InferenceEngine.warmup``; on CPU tensors
every kernel wrapper runs its plain PyTorch version instead.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of every
    entry point) raises when no card is visible instead of quietly running
    on the CPU; the CPU is used only when a caller asks for it. A card
    without an index gets the current one's, so another thread can make
    the same card its current device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
