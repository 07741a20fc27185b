"""Block-size optimization (GRIM §5.1, Listing 1).

The paper decouples the block size from training: it is chosen by latency
alone, on synthesized random weights at the target pruning rate ("the
pruning ratio rather than the specific location of non-zero weights impacts
the latency"). Accuracy then prefers the smallest block size whose latency
meets the threshold.

``find_opt_blk`` takes the latency backend as ``run_layer``:

* :func:`wallclock_runner` (its default here) times the port's own
  ``bcr_spmm`` on the device of its tensors: the CUDA kernel under CUDA
  events on the card (the default device), the plain version on the host
  clock for ``device="cpu"``.
* :func:`analytic_latency` is the counterpart of the reference's
  ``analytic_tpu_latency`` (a roofline of its TPU kernel): the plan tuner's
  model of the port's CUDA kernel on an H100 (``core/tuner.launch_cost``)
  at the launch the kernel's rule picks for the layer. No card in the
  loop; ``launch.serve._auto_block_spec`` takes it by default.

:func:`wallclock_plan_fitness` is the GA plan tuner's measured backend: the
kernel's device time under each dispatch genome. Both wall-clock backends
take the median of 5 repeats of 20 back-to-back launches, which holds a
pick steadier than one run of 20.
"""

from __future__ import annotations

import dataclasses
import statistics
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
    packed = tbcrc_pack(w, layer_spec(layer))
    packed.vals = packed.vals.to(dtype)
    x = torch.randn((layer.m, layer.k), generator=gen, device=dev).to(dtype)
    return x, packed


def device_seconds(fn, x: torch.Tensor, iters: int, repeats: int) -> float:
    """Median over ``repeats`` of the mean seconds of ``iters`` back-to-back
    calls of ``fn`` after one warm call: between CUDA events on the card,
    on the host clock on the CPU. On the card a spin of a few milliseconds
    is queued ahead of the start event, so the host has enqueued every
    launch before the card reaches them and the interval is device time,
    not the wrappers' host time (a small launch costs the host more than
    the card)."""
    fn()
    times = []
    for _ in range(repeats):
        if not x.is_cuda:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) / iters)
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters / 1e3)
    return statistics.median(times)


def wallclock_runner(layer: SynthLayer, iters: int = 20, *, repeats: int = 5,
                     device="cuda", dtype=torch.bfloat16) -> float:
    """Measured latency (seconds) of the port's ``bcr_spmm`` for ``layer``
    on :func:`synth_operands` (bf16, the serving dtype, by default): the
    median of ``repeats`` runs of ``iters`` back-to-back launches, between
    CUDA events on the card (the kernel's device time; a recurrent layer
    finds its weights in the L2 as these launches do), on the host clock on
    the CPU. A block the kernel cannot launch (``launch_plan`` refuses a
    tile that no CTA's shared memory holds) scores ``inf``, as the plan
    fitness scores an illegal genome."""
    from repro_torch.kernels.bcr_spmm import bcr_spmm

    x, packed = synth_operands(layer, device=device, dtype=dtype)
    try:
        bcr_spmm(x, packed)
    except ValueError:
        return float("inf")
    return device_seconds(lambda: bcr_spmm(x, packed), x, iters, repeats)


def layer_spec(layer: SynthLayer) -> BCRSpec:
    """``layer``'s pack spec: its keep on the pack's own granule
    (``kept_align``), as ``launch.serve.pack_params`` packs."""
    return BCRSpec(block_shape=layer.block_shape, keep_frac=layer.keep_frac,
                   align=kept_align(layer.block_shape))


def layer_kept(layer: SynthLayer) -> Tuple[int, int]:
    """(R_keep, C_keep) of ``layer``'s pack."""
    return layer_spec(layer).kept_counts()


def analytic_latency(layer: SynthLayer) -> float:
    """Modelled latency (seconds) of the port's tensor-core ``bcr_spmm`` for
    ``layer`` on one H100, at the launch ``launch_plan``'s rule picks for
    it (``core/tuner.launch_cost``: bytes over 3.35 TB/s, MMA rows over 989
    TFLOP/s, stretched by the grid's fill of the 132 SMs). The counterpart
    of the reference's ``analytic_tpu_latency``, which models its TPU
    kernel. A block no CTA can hold scores ``inf``."""
    from repro_torch.core.tuner import H100_SMS, launch_cost
    from repro_torch.kernels.bcr_spmm import launch_plan

    kept = layer_kept(layer)
    try:
        plan = launch_plan(layer.m, layer.n, layer.k, 1,
                           tuple(layer.block_shape), kept, H100_SMS)
    except ValueError:
        return float("inf")
    return launch_cost(plan, layer.m, layer.k, layer.n, kept)


def wallclock_plan_fitness(m: int, k: int, n: int,
                           block_shape: Tuple[int, int], r_keep: int,
                           c_keep: int, *, int8_tiles: bool = False,
                           experts: int = 1, iters: int = 20,
                           repeats: int = 5, device="cuda"
                           ) -> Callable[[dict], float]:
    """Measured-latency fitness for the §4.5 plan tuner (opt-in backend;
    ``tuner.plan_cost_model`` stays the default), as the reference's.

    A packed weight of EXACTLY this geometry — ``(nb_r, nb_c, r_keep,
    c_keep)`` random bf16 tiles (int8 codes with their scales under
    ``int8_tiles``), arange index planes; per §5.1 only the rate matters
    for latency, not which weights survive — is synthesized once with a
    random bf16 x ``([E,] m, k)``; each genome is attached (``attach_plan``
    / ``pack_group``, hint ``m``) and the kernel's device time is taken as
    :func:`wallclock_runner` takes it. On CPU tensors (``device="cpu"``)
    the plain version is timed on the host clock, where no genome matters.
    A genome ``launch_plan`` refuses scores ``inf``; a kernel fault raises.
    The time is per projection (``/ group_size``)."""
    from repro_torch.core.bcrc import TBCRC
    from repro_torch.core.tuner import H100_SMS, genome_knobs
    from repro_torch.kernels.bcr_spmm import (bcr_spmm, bcr_spmm_grouped,
                                              launch_plan)
    from repro_torch.kernels.plan import (attach_plan, pack_group,
                                          quantize_packed)

    dev = resolve_device(device)
    br, bc = block_shape
    nb_r, nb_c = n // br, k // bc
    lead = (experts,) if experts > 1 else ()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    vals = torch.randn((*lead, nb_r, nb_c, r_keep, c_keep), generator=gen,
                       device=dev)
    row_idx = torch.arange(r_keep, dtype=torch.int32, device=dev).expand(
        *lead, nb_r, nb_c, r_keep).contiguous()
    col_idx = torch.arange(c_keep, dtype=torch.int32, device=dev).expand(
        *lead, nb_r, nb_c, c_keep).contiguous()
    packed = attach_plan(TBCRC(vals=vals, row_idx=row_idx, col_idx=col_idx,
                               shape=(n, k), block_shape=tuple(block_shape),
                               plan=None))
    packed = (quantize_packed(packed) if int8_tiles
              else dataclasses.replace(packed,
                                       vals=packed.vals.to(torch.bfloat16)))
    x = torch.randn((*lead, m, k), generator=gen, device=dev).to(
        torch.bfloat16)

    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)

    def fitness(genome: dict) -> float:
        grp = int(genome.get("group_size", 1))
        try:
            launch_plan(m, n, k, grp, tuple(block_shape), (r_keep, c_keep),
                        sms, int8_tiles, True, experts, genome_knobs(genome))
        except ValueError:
            return float("inf")       # a genome launch_plan refuses
        if grp > 1:
            grouped = pack_group([packed] * grp, genome, m=m)
            fn = lambda: bcr_spmm_grouped(x, grouped)     # noqa: E731
        else:
            planned = attach_plan(packed, genome, m=m)
            fn = lambda: bcr_spmm(x, planned)             # noqa: E731
        return device_seconds(fn, x, iters, repeats) / grp

    return fitness


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
