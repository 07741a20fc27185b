"""Block-size optimization (GRIM §5.1, Listing 1).

The paper decouples the block size from training: it is chosen by latency
alone, on synthesized random weights at the target pruning rate ("the
pruning ratio rather than the specific location of non-zero weights impacts
the latency"). Accuracy then prefers the smallest block size whose latency
meets the threshold.

``find_opt_blk`` takes the latency backend as ``run_layer``. Its default
here is :func:`wallclock_runner`, which times the port's own ``bcr_spmm``
on the device of its tensors: the CUDA kernel under CUDA events on the card
(the default device), the plain version on the host clock for
``device="cpu"``. The reference's default backend is an analytic model of
its TPU kernel; the port carries no model of a TPU, and its GA plan tuner's
backends (the reference's ``analytic_tpu_latency`` and
``wallclock_plan_fitness``) wait for the tuner's own slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.bcr import BCRSpec, choose_block_shape, kept_align


@dataclasses.dataclass(frozen=True)
class SynthLayer:
    """A synthesized GEMM layer: y[M,N] = x[M,K] @ W.T, W (N,K) BCR-pruned."""

    m: int
    k: int
    n: int
    keep_frac: float
    block_shape: Tuple[int, int]


def synthesize(m: int, k: int, n: int, keep_frac: float,
               block_shape: Tuple[int, int]) -> SynthLayer:
    """Paper Listing 1 `synthesize`: weights are random — only the rate and
    block structure matter for latency."""
    return SynthLayer(m=m, k=k, n=n, keep_frac=keep_frac,
                      block_shape=block_shape)


def synth_operands(layer: SynthLayer, *, device="cuda",
                   dtype=torch.bfloat16):
    """``(x, packed)`` for ``layer``: a random ``(n, k)`` weight from a
    generator of seed 0 packed at the layer's block and keep, its tiles cast
    to ``dtype`` with a random ``(m, k)`` x. Kept counts sit on the pack's
    own granule (``kept_align``), as ``launch.serve.pack_params`` packs;
    the reference's runner keeps its default granule of 8, which at blocks
    under 32 keeps more than ``keep_frac``."""
    from repro_torch.core.bcrc import tbcrc_pack

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    w = torch.randn((layer.n, layer.k), generator=gen, device=dev)
    spec = BCRSpec(block_shape=layer.block_shape, keep_frac=layer.keep_frac,
                   align=kept_align(layer.block_shape))
    packed = tbcrc_pack(w, spec)
    packed.vals = packed.vals.to(dtype)
    x = torch.randn((layer.m, layer.k), generator=gen, device=dev).to(dtype)
    return x, packed


def wallclock_runner(layer: SynthLayer, iters: int = 20, *,
                     device="cuda", dtype=torch.bfloat16) -> float:
    """Measured latency (seconds) of the port's ``bcr_spmm`` for ``layer``
    on :func:`synth_operands` (bf16, the serving dtype, by default). After
    one warm launch, ``iters`` launches are timed back to back: between
    CUDA events on the card (the kernel's device time; a recurrent layer
    finds its weights in the L2 as these launches do), on the host clock
    on the CPU. A block the kernel cannot launch (``launch_plan`` refuses a
    tile that no CTA's shared memory holds) scores ``inf``, as the
    reference's plan fitness scores an illegal genome."""
    from repro_torch.kernels.bcr_spmm import bcr_spmm

    x, packed = synth_operands(layer, device=device, dtype=dtype)
    try:
        bcr_spmm(x, packed)
    except ValueError:
        return float("inf")
    if not x.is_cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            bcr_spmm(x, packed)
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        bcr_spmm(x, packed)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters / 1e3


def find_opt_blk(
    m: int, k: int, n: int, keep_frac: float,
    block_sizes: Sequence[Tuple[int, int]],
    run_layer: Callable[[SynthLayer], float] = wallclock_runner,
    threshold: float = 1.10,
) -> Tuple[Tuple[int, int], List[Tuple[Tuple[int, int], float]]]:
    """Paper Listing 1 `find_opt_blk`.

    Iterates candidate block sizes from smallest (most accurate) upward and
    returns the smallest one whose latency is within ``threshold`` × the best
    latency seen over the sweep; also returns the full (size, latency) log.
    """
    log: List[Tuple[Tuple[int, int], float]] = []
    for size in block_sizes:
        if n % size[0] or k % size[1]:
            continue
        layer = synthesize(m, k, n, keep_frac, size)
        log.append((size, run_layer(layer)))
    if not log:
        raise ValueError("no candidate block size divides the layer dims")
    best_latency = min(t for _, t in log)
    # smallest block size (most flexibility/accuracy) meeting the threshold
    ordered = sorted(log, key=lambda e: e[0][0] * e[0][1])
    for size, lat in ordered:
        if lat <= threshold * best_latency:
            return size, log
    return min(log, key=lambda e: e[1])[0], log


def default_candidates(n: int, k: int) -> List[Tuple[int, int]]:
    cands = []
    for br in (32, 64, 128, 256, 512):
        for bc in (128, 256, 512):
            if n % br == 0 and k % bc == 0:
                cands.append((br, bc))
    return cands or [choose_block_shape((n, k))]
