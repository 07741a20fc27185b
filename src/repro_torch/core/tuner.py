"""Genetic-algorithm auto-tuner (GRIM §4.5), retargeted to the port's CUDA
BCR kernel on an H100.

The paper tunes tiling sizes, unroll factors and data placement with a GA
("allows starting parameter search with initializing an arbitrary number of
chromosomes"). Here the genome is a dict of categorical choices and
:func:`genetic_search` is the reference's search (``core/tuner.py`` of the
reference), copied line for line in numpy: the same space, fitness and seed
give the same :class:`GAResult`.

The default fitness, :func:`plan_cost_model`, is a model of the port's own
kernel (``kernels/csrc/bcr_spmm.cu``) on one H100 SXM, built from the
:class:`~repro_torch.kernels.bcr_spmm.LaunchPlan` that ``launch_plan``
gives the genome: no card in the loop, so the tests tune on the CPU. The
reference's fitness models its TPU kernel (VMEM, MXU, grid steps); none of
its constants is used here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np

Genome = Dict[str, Any]
SearchSpace = Dict[str, Sequence[Any]]

# one H100 SXM: device-memory rate, dense bf16 tensor-core peak, SMs
H100_BYTES_PER_S = 3.35e12
H100_BF16_OPS_PER_S = 989e12
H100_SMS = 132
H100_SMEM_PER_SM = 233472
# modelled latency of one stage of the short-block body (its copies landed,
# its scatter and its two block barriers), fitted to the body's times on an
# H100; chip_smoke.py phase 17a prints the model's rank correlation
SHORT_STAGE_S = 3.0e-6


@dataclasses.dataclass
class GAResult:
    best: Genome
    best_fitness: float
    history: List[Tuple[int, float]]   # (generation, best fitness so far)
    evaluations: int


def genetic_search(
    space: SearchSpace,
    fitness: Callable[[Genome], float],   # lower is better (latency seconds)
    *,
    population: int = 24,
    generations: int = 12,
    elite: int = 4,
    mutation_rate: float = 0.25,
    seed: int = 0,
) -> GAResult:
    rng = np.random.default_rng(seed)
    keys = sorted(space.keys())

    def random_genome() -> Genome:
        return {k: space[k][rng.integers(len(space[k]))] for k in keys}

    def crossover(a: Genome, b: Genome) -> Genome:
        return {k: (a if rng.random() < 0.5 else b)[k] for k in keys}

    def mutate(g: Genome) -> Genome:
        out = dict(g)
        for k in keys:
            if rng.random() < mutation_rate:
                out[k] = space[k][rng.integers(len(space[k]))]
        return out

    pop = [random_genome() for _ in range(population)]
    cache: Dict[Tuple, float] = {}
    evals = 0

    def fit(g: Genome) -> float:
        nonlocal evals
        key = tuple(g[k] for k in keys)
        if key not in cache:
            cache[key] = float(fitness(g))
            evals += 1
        return cache[key]

    history: List[Tuple[int, float]] = []
    best_g, best_f = None, float("inf")
    for gen in range(generations):
        scored = sorted(pop, key=fit)
        # when every genome scores inf (an over-constrained space) `<` never
        # updates: keep the least bad genome seen so far
        if best_g is None or fit(scored[0]) < best_f:
            best_g, best_f = scored[0], fit(scored[0])
        history.append((gen, best_f))
        parents = scored[: max(elite, 2)]
        children = [dict(p) for p in parents]
        while len(children) < population:
            a, b = rng.integers(len(parents)), rng.integers(len(parents))
            children.append(mutate(crossover(parents[a], parents[b])))
        pop = children
    return GAResult(best=best_g, best_fitness=best_f, history=history,
                    evaluations=evals)


# ---------------------------------------------------------------------------
# Default fitness: a model of the CUDA BCR kernel on one H100
# ---------------------------------------------------------------------------


def launch_cost(plan, m: int, k: int, n: int, kept: Tuple[int, int], *,
                weight_bytes_per_el: int = 2,
                weight_scale_bytes: int = 0) -> float:
    """Modelled seconds of one tensor-core launch ``plan`` (a ``LaunchPlan``)
    over x ``([E,] m, k)`` bf16 and its G packed ``(n, k)`` weights keeping
    ``kept`` = (R_keep, C_keep) a block, on one H100 SXM.

    * Bytes: every kept tile once with its row and column indices (and its
      scale under int8 tiles), x's rows once per row chunk and block row
      (each such CTA stages the x blocks of its contraction range), the bf16
      output, and a split's fp32 partials written and read back.
    * Operations: the MMA rows the configuration computes, wasted ones
      included (rows past a block row or past G members), by the M tile by
      C_keep rounded up to the MMA's k of 16, per contraction block.
    * Time: the larger of bytes over 3.35 TB/s and operations over 989
      TFLOP/s, stretched by the grid's fill of the 132 SMs: ``waves · 132 /
      grid``, each wave as long as the others.

    A wide-body plan (``plan.body == "wg"``, the 128 M tile) stages x once
    a row group of its flattened rows and multiplies each tile expanded
    across its block's columns.

    A short-body plan (``plan.body == "short"``, blocks under 16 rows)
    counts its own way (:func:`_short_cost`): its P·br rows a CTA, its
    dense ``bc`` depth (the tile expanded to its block), x staged once a
    CTA; and each round of the CTAs the SMs hold at once pays
    ``SHORT_STAGE_S`` for every stage a CTA walks (the copies' landing and
    two block barriers a stage)."""
    r, c = kept
    e, g = plan.experts, plan.group
    w_bytes = e * g * plan.nb_r * plan.nb_c * (
        r * c * weight_bytes_per_el + (r + c) * 4 + weight_scale_bytes)
    y_bytes = e * g * m * n * 2
    partials = plan.workspace_floats * 4 * 2
    waves = -(-plan.grid // H100_SMS)
    if plan.body == "short":
        # CTAs an SM holds at once: shared memory (1 KB reserved a CTA),
        # and at most 4 (64 registers a thread, 256 threads)
        resident = max(1, min(4, H100_SMEM_PER_SM // (plan.smem_bytes
                                                      + 1024)))
        stages = -(-plan.nb_c // (plan.stage_blocks * plan.splits))
        return (_short_cost(plan, m, k, w_bytes + y_bytes + partials)
                * waves * H100_SMS / plan.grid
                + -(-plan.grid // (H100_SMS * resident)) * stages
                * SHORT_STAGE_S)
    if plan.body == "wg":
        # the 128 tile: x staged once a row group, every tile expanded to
        # its block's bc columns over the CTA's 256 MMA rows
        x_bytes = e * plan.chunks * m * k * 2
        ops = (2 * plan.tiles * plan.nb_c * plan.rows * plan.m_tile
               * (k // plan.nb_c))
    else:
        x_bytes = e * plan.nb_r * plan.chunks * m * k * 2
        ops = (2 * plan.tiles * plan.nb_c * plan.rows * plan.m_tile
               * (-(-c // 16) * 16))
    t = max((w_bytes + x_bytes + y_bytes + partials) / H100_BYTES_PER_S,
            ops / H100_BF16_OPS_PER_S)
    return t * waves * H100_SMS / plan.grid


def _short_cost(plan, m: int, k: int, other_bytes: int) -> float:
    """Bytes-or-operations seconds of a short-body launch: x staged once
    for each CTA's P block rows (each group of them reads all of x's
    columns once over its splits), and the MMA work of the expanded tiles,
    P·br rows padded to the configuration's by the M tile by each stage's
    J·bc columns padded to k16."""
    groups = -(-plan.nb_r // plan.block_rows)
    x_bytes = groups * m * k * 2
    bc = k // plan.nb_c
    stages = -(-plan.nb_c // plan.stage_blocks)
    ops = (2 * plan.tiles * plan.rows * plan.m_tile * stages
           * (-(-plan.stage_blocks * bc // 16) * 16))
    return max((x_bytes + other_bytes) / H100_BYTES_PER_S,
               ops / H100_BF16_OPS_PER_S)


def plan_cost_model(
    m: int, k: int, n: int, block_shape: Tuple[int, int],
    r_keep: int, c_keep: int, *, weight_bytes_per_el: int = 2,
    weight_scale_bytes: int = 0, experts: int = 1,
) -> Callable[[Genome], float]:
    """Fitness for tuning the launch of an already-packed TBCRC weight (its
    block and kept counts are fixed by packing; the genome picks the CUDA
    kernel's launch knobs, ``kernels.plan.plan_search_space``).

    Genome keys:
      ``m_tile``      rows of x a CTA takes (one of ``M_TILES``)
      ``config``      which configuration compiled for that tile (warp
                      layout and m16 slabs a warp): the MMA rows a CTA
                      computes and so the row chunks of a block row
      ``split``       whether the contraction blocks of each output tile
                      are shared by the rule's number of CTAs
      ``group_size``  projections fused a launch (Q/K/V, gate/up): x is
                      staged once per row chunk for the whole group, and
                      the group shares one grid

    A genome ``launch_plan`` refuses (a configuration that cannot hold G
    members' rows, or no ring depth that fits a CTA's 232448 B of shared
    memory) scores ``inf``. The cost is per projection (``/ group_size``),
    as in the reference, so one fused launch and G separate ones compare.
    """
    from repro_torch.kernels.bcr_spmm import launch_plan

    def fitness(g: Genome) -> float:
        grp = int(g["group_size"])
        try:
            plan = launch_plan(m, n, k, grp, tuple(block_shape),
                               (r_keep, c_keep), H100_SMS,
                               weight_bytes_per_el == 1, True, experts,
                               genome_knobs(g))
        except ValueError:
            return float("inf")
        return launch_cost(plan, m, k, n, (r_keep, c_keep),
                           weight_bytes_per_el=weight_bytes_per_el,
                           weight_scale_bytes=weight_scale_bytes) / grp

    return fitness


def genome_knobs(g: Genome) -> Tuple[int, int, bool]:
    """The ``launch_plan`` genome ``(m_tile, config, split)`` of a tuner
    genome."""
    return int(g["m_tile"]), int(g["config"]), bool(g["split"])
