"""Pack-time execution plans for BCR matmuls (GRIM §4.4–§4.5): the compile
step.

Everything derivable from the static sparsity pattern is computed once at
pack time and carried beside the packed weight:

* ``gather_cols``  — flat int32 ``(nb_r·nb_c·C_keep,)`` global column ids,
  ``j·bc + col_idx[i, j, c]``: one gather takes every surviving activation
  for the plain path (:func:`repro_torch.kernels.ref.bcr_spmm_packed_ref`).
* ``scatter_rows`` — flat int32 ``(nb_r·nb_c·R_keep,)`` global output rows,
  ``i·br + row_idx[i, j, r]``: one scatter-add places the partial products.
* ``block_scales`` — for int8-quantized vals, one fp32 scale per kept
  ``(R_keep, C_keep)`` tile, ``([G,] nb_r, nb_c)``; ``None`` for fp vals.
* the dispatch genome — ``m_tile``, ``config``, ``split``, ``group_size``
  — chosen by the GA tuner (:func:`tuned_genome`, the reference's §4.5
  search) for a decode batch hint ``m_hint``, cached per unique layer
  shape. It sets the CUDA kernel's launch knobs
  (``kernels/bcr_spmm.py:launch_plan``) for every call of at most
  ``m_hint`` rows; above the hint (prefill, verify) the kernel's own rule
  decides, as a tile tuned for decode says nothing about a prefill.

The CUDA kernels read ``row_idx``/``col_idx`` (and ``block_scales``)
directly; the vectors serve the plain path. The reference's genome has two
more knobs of its TPU kernel with no counterpart here: ``use_planes``
(one-hot gather/scatter planes built on the VPU or streamed from HBM; the
CUDA kernel reads the index planes and builds an inverse row map in shared
memory) and ``grid_order`` (the order of the Pallas grid; the CUDA grid's
order is fixed). The port's genome has ``config`` and ``split`` instead.

:class:`GroupedTBCRC` stacks projections that share one activation (Q/K/V,
gate/up) for a single kernel launch. As in the reference, a group is fused
only when the tuner votes to (:func:`_try_fuse`: the tuned genome's
``group_size`` covers the members); with ``plan=False`` packing neither
tunes nor fuses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.bcrc import TBCRC

Genome = Dict[str, Any]
FITNESS_BACKENDS = ("analytic", "wallclock")


@dataclasses.dataclass
class BCRPlan:
    """Flat gather/scatter vectors for one packed (or grouped) matrix."""

    gather_cols: torch.Tensor                 # (L_c,) int32 flat global cols
    scatter_rows: torch.Tensor                # (L_r,) int32 flat global rows
    # per-tile fp32 dequant scales of int8 vals, ([G,] nb_r, nb_c), applied
    # to each block's fp32 partial before the scatter (None: fp vals)
    block_scales: Optional[torch.Tensor] = None
    # the tuner's dispatch genome (None: untuned, the kernel's rule
    # decides) and the decode batch it was tuned for: it sets the launch of
    # every call of at most m_hint rows. Static: not leaves of a params
    # tree (the reference's plan keeps them as aux data)
    genome: Optional[Dict[str, Any]] = dataclasses.field(
        default=None, metadata={"static": True})
    m_hint: Optional[int] = dataclasses.field(
        default=None, metadata={"static": True})
    # the column-parallel shards the whole weight was split into (1: the
    # whole weight). A shard launches as the whole would: the split rule
    # of ``bcr_spmm.launch_plan`` counts the whole's output tiles, so the
    # partial sums add up in the same order and the tokens of a sharded
    # engine stay bit-identical to one device's (``split_packed``)
    row_shards: int = dataclasses.field(default=1,
                                        metadata={"static": True})

    def nbytes(self) -> int:
        tot = self.gather_cols.numel() * 4 + self.scatter_rows.numel() * 4
        if self.block_scales is not None:
            tot += (self.block_scales.numel()
                    * self.block_scales.element_size())
        return tot


def _index_vectors(row_idx: torch.Tensor, col_idx: torch.Tensor,
                   block_shape: Tuple[int, int],
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-local index planes → flat global take/scatter vectors, one per
    matrix of a stacked pack (the planes' leading axes lead the vectors)."""
    br, bc = block_shape
    *lead, nb_r, nb_c, _ = col_idx.shape
    dev = col_idx.device
    gcols = (torch.arange(nb_c, dtype=torch.int32, device=dev)[None, :, None]
             * bc + col_idx).reshape(*lead, -1)
    srows = (torch.arange(nb_r, dtype=torch.int32, device=dev)[:, None, None]
             * br + row_idx).reshape(*lead, -1)
    return gcols.to(torch.int32), srows.to(torch.int32)


def default_plan(row_idx: torch.Tensor, col_idx: torch.Tensor,
                 block_shape: Tuple[int, int]) -> BCRPlan:
    """Index vectors only — what ``tbcrc_pack`` attaches."""
    gcols, srows = _index_vectors(row_idx, col_idx, block_shape)
    return BCRPlan(gather_cols=gcols, scatter_rows=srows)


def attach_plan(packed: TBCRC, genome: Optional[Genome] = None, *,
                m: Optional[int] = None) -> TBCRC:
    """Rebuild ``packed``'s plan with the dispatch ``genome`` tuned for
    decode batch ``m`` (stacked packs keep their leading axes; the genome
    is the same for every expert, as the launch is one). int8 scales ride
    along."""
    gcols, srows = _index_vectors(packed.row_idx, packed.col_idx,
                                  packed.block_shape)
    scales = packed.plan.block_scales if packed.plan is not None else None
    plan = BCRPlan(gather_cols=gcols, scatter_rows=srows,
                   block_scales=scales,
                   genome=dict(genome) if genome is not None else None,
                   m_hint=m if genome is not None else None,
                   row_shards=plan_shards(packed.plan))
    return dataclasses.replace(packed, plan=plan)


def plan_shards(plan: Any) -> int:
    """How many column-parallel shards ``plan``'s weight is one of (1 for
    a whole weight, or no plan)."""
    return getattr(plan, "row_shards", 1)


def launch_genome(plan: Any, m: int) -> Optional[Tuple[int, int, bool]]:
    """The ``launch_plan`` genome a call of ``m`` rows runs under: the
    plan's tuned knobs when it has them and ``m`` is at most the decode
    hint they were tuned for; None (the kernel's rule) otherwise."""
    from repro_torch.core.tuner import genome_knobs
    genome = getattr(plan, "genome", None)
    if genome is None or m > plan.m_hint:
        return None
    return genome_knobs(genome)


@dataclasses.dataclass
class GroupedTBCRC:
    """G same-shaped TBCRC weights stacked for one fused kernel launch.

    ``plan.gather_cols`` concatenates the members' take vectors and
    ``plan.scatter_rows`` offsets member ``g`` by ``g·N`` so the plain path
    scatters into one ``(M, G·N)`` output. A group of stacked members (an
    MoE layer's experts) keeps the expert axis first: vals ``(E, G, nb_r,
    nb_c, R_keep, C_keep)``, plan vectors ``(E, ·)``, scales ``(E, G,
    nb_r, nb_c)``.
    """

    vals: torch.Tensor        # ([E,] G, nb_r, nb_c, R_keep, C_keep)
    row_idx: torch.Tensor     # ([E,] G, nb_r, nb_c, R_keep)
    col_idx: torch.Tensor     # ([E,] G, nb_r, nb_c, C_keep)
    plan: Any
    shape: Tuple[int, int]          # per-MEMBER dense (N, K)
    block_shape: Tuple[int, int]
    group_size: int

    @property
    def kept_counts(self) -> Tuple[int, int]:
        return self.vals.shape[-2], self.vals.shape[-1]

    def nbytes(self) -> int:
        tot = (self.vals.numel() * self.vals.element_size()
               + self.row_idx.numel() * 4 + self.col_idx.numel() * 4)
        if self.plan is not None:
            tot += self.plan.nbytes()
        return tot


def groupable(members: Sequence[TBCRC]) -> bool:
    """Fusable = identical member geometry (shape, blocks, kept counts,
    dtype). Q with GQA'd K/V usually fails this (different N) — K/V and
    gate/up always pass."""
    first = members[0]
    return all(
        m.shape == first.shape
        and m.block_shape == first.block_shape
        and m.vals.shape == first.vals.shape
        and m.vals.dtype == first.vals.dtype
        for m in members[1:])


def pack_group(members: Sequence[TBCRC], genome: Optional[Genome] = None,
               *, m: Optional[int] = None) -> GroupedTBCRC:
    """Stack same-shaped packed weights into one fused-launch group, with
    the dispatch ``genome`` tuned for decode batch ``m`` (None: untuned);
    stacked members (experts) group per expert, the group axis after
    theirs."""
    members = list(members)
    if not groupable(members):
        raise ValueError("grouped members must share shape/block/kept/dtype")
    n = members[0].shape[0]
    ax = members[0].vals.dim() - 4          # leading (expert) axes
    gcols_parts, srows_parts = [], []
    for g, mem in enumerate(members):
        gc, sr = _index_vectors(mem.row_idx, mem.col_idx, mem.block_shape)
        gcols_parts.append(gc)
        srows_parts.append(sr + g * n)
    mem_scales = [m.plan.block_scales if m.plan is not None else None
                  for m in members]
    bscales = (torch.stack(mem_scales, dim=ax).contiguous()
               if all(sc is not None for sc in mem_scales) else None)
    if genome is not None:
        genome = {**genome, "group_size": len(members)}
    plan = BCRPlan(gather_cols=torch.cat(gcols_parts, dim=-1),
                   scatter_rows=torch.cat(srows_parts, dim=-1),
                   block_scales=bscales, genome=genome,
                   m_hint=m if genome is not None else None)
    return GroupedTBCRC(
        vals=torch.stack([m.vals for m in members], dim=ax).contiguous(),
        row_idx=torch.stack([m.row_idx for m in members], dim=ax).contiguous(),
        col_idx=torch.stack([m.col_idx for m in members], dim=ax).contiguous(),
        plan=plan, shape=members[0].shape,
        block_shape=members[0].block_shape, group_size=len(members))


def stacked_experts(packed) -> int:
    """E of a pack stacked on a leading expert axis (an MoE layer's
    experts), else 0."""
    base = 5 if isinstance(packed, GroupedTBCRC) else 4
    return packed.vals.shape[0] if packed.vals.dim() > base else 0


def expert_slice(packed, e: int):
    """Expert ``e`` of a stacked pack: the unstacked pack the kernels' plain
    versions take."""
    plan = packed.plan
    if plan is not None:
        plan = dataclasses.replace(
            plan, gather_cols=plan.gather_cols[e],
            scatter_rows=plan.scatter_rows[e],
            block_scales=(None if plan.block_scales is None
                          else plan.block_scales[e]))
    return dataclasses.replace(packed, vals=packed.vals[e],
                               row_idx=packed.row_idx[e],
                               col_idx=packed.col_idx[e], plan=plan)


# dict-key patterns of projections sharing one activation (models/layers.py
# naming): attention Q/K/V over x, SwiGLU gate/up over h. The fused entry
# replaces its members with {"w_group": GroupedTBCRC[, "b": (G, N)]}.
# `requires` keys must also be present — they identify the layer type.
_GROUPS = (
    ("wqkv", ("wq", "wk", "wv"), ()),
    ("wkv", ("wk", "wv"), ("wq",)),
    ("wgi", ("wg", "wi"), ()),
)


def _packed_entry(node: Any) -> Optional[TBCRC]:
    if isinstance(node, dict) and isinstance(node.get("w_packed"), TBCRC):
        return node["w_packed"]
    return None


def _try_fuse(tree: Dict[str, Any], fused_key: str,
              member_keys: Tuple[str, ...], m: int,
              fitness: str = "analytic") -> bool:
    members = [_packed_entry(tree.get(k)) for k in member_keys]
    if any(p is None for p in members) or not groupable(members):
        return False
    has_bias = ["b" in tree[k] for k in member_keys]
    if any(has_bias) and not all(has_bias):
        return False
    genome = tune_genome_for(members[0], m=m, max_group=len(members),
                             fitness=fitness)
    if int(genome.get("group_size", 1)) < len(members):
        return False            # the tuner preferred separate launches
    fused: Dict[str, Any] = {"w_group": pack_group(members, genome, m=m)}
    if all(has_bias):
        # group axis at -2, so stacked (expert) axes stay leading
        fused["b"] = torch.stack([tree[k]["b"] for k in member_keys], dim=-2)
    for k in member_keys:
        del tree[k]
    tree[fused_key] = fused
    return True


def fuse_packed_projections(tree: Any, *, m: int = 8,
                            fitness: str = "analytic",
                            _key: Optional[str] = None) -> Any:
    """Walk a packed params tree and fuse Q/K/V and gate/up projections
    whose packed geometry matches and whose tuned genome (decode batch
    ``m``, backend ``fitness``) votes to fuse. Returns a new tree; leaves
    are shared.

    A cross-attention dict (parent key ``cross_attn``) never fuses Q with
    K/V: Q projects the decoder stream, K/V the encoder's output. Its K/V
    still fuse into ``wkv``."""
    if isinstance(tree, dict):
        out = {k: fuse_packed_projections(v, m=m, fitness=fitness, _key=k)
               for k, v in tree.items()}
        for fused_key, member_keys, requires in _GROUPS:
            if fused_key == "wqkv" and _key == "cross_attn":
                continue
            if (all(k in out for k in member_keys)
                    and all(k in out for k in requires)):
                _try_fuse(out, fused_key, member_keys, m, fitness)
        return out
    if isinstance(tree, list):
        return [fuse_packed_projections(v, m=m, fitness=fitness, _key=_key)
                for v in tree]
    return tree


# ---------------------------------------------------------------------------
# GA tuner wiring (§4.5): one search per unique layer shape, cached
# ---------------------------------------------------------------------------

_GENOME_CACHE: Dict[Tuple, Tuple[Genome, float]] = {}


def plan_search_space(m: int, max_group: int,
                      block_shape: Optional[Tuple[int, int]] = None
                      ) -> Dict[str, Sequence[Any]]:
    """The launch knobs of the CUDA kernel at M = ``m``: every M tile up to
    the one the kernel's rule starts from (the smallest holding M, else
    128), each configuration index, split or not, and the group widths.
    The rule's own choice is a point of this space. For blocks shorter than
    one MMA slab (``block_shape`` rows under 16) a G = 1 genome's
    ``config`` indexes the short-block body's configurations
    (``bcr_spmm.short_configs``), so the index runs over as many as the
    most an M tile has of either kind."""
    from repro_torch.kernels.bcr_spmm import (M_TILES, short_configs,
                                              tile_configs)
    m = max(m, 1)
    first = next(mt for mt in M_TILES if m <= mt or mt == M_TILES[-1])
    n_cfg = max(len(tile_configs(mt)) for mt in M_TILES)
    if block_shape is not None and block_shape[0] < 16:
        n_cfg = max(n_cfg, max(len(short_configs(mt)) for mt in M_TILES))
    return {
        "m_tile": [mt for mt in M_TILES if mt <= first],
        "config": list(range(n_cfg)),
        "split": [False, True],
        "group_size": sorted({1, max_group}),
    }


def _tile_bytes(packed) -> Tuple[int, int]:
    """(bytes a weight element, bytes of a tile's scale) the tensor-core
    kernel streams: bf16 tiles (the fp form, whatever dtype the pack holds
    before ``pack_params`` casts it to bf16), or int8 codes with their fp32
    scale."""
    if packed.vals.dtype == torch.int8:
        return 1, _scale_bytes(packed)
    return 2, 0


def tuned_genome(m: int, k: int, n: int, block_shape: Tuple[int, int],
                 r_keep: int, c_keep: int, *, max_group: int = 1,
                 weight_bytes_per_el: int = 2, weight_scale_bytes: int = 0,
                 experts: int = 1, fitness: str = "analytic") -> Genome:
    """§4.5 genetic search over the CUDA kernel's launch knobs (M tile,
    configuration, split, group width) at decode batch ``m``; memoized per
    unique layer shape so a deep stack tunes once.

    ``fitness`` picks the backend: "analytic" (default — the
    ``tuner.plan_cost_model`` model of the kernel on an H100, no card in
    the loop) or "wallclock" (``block_search.wallclock_plan_fitness``:
    CUDA-event times of the kernel itself on synthesized operands of this
    geometry, on the card). Anything else raises. A shape where no genome
    launches (no CTA's shared memory holds its tiles) raises
    ``ValueError``."""
    if fitness not in FITNESS_BACKENDS:
        raise ValueError(f"unknown plan fitness backend {fitness!r}; known: "
                         f"{FITNESS_BACKENDS}")
    key = (m, k, n, tuple(block_shape), r_keep, c_keep, max_group,
           weight_bytes_per_el, weight_scale_bytes, experts, fitness)
    if key not in _GENOME_CACHE:
        from repro_torch.core.tuner import genetic_search, plan_cost_model
        if fitness == "wallclock":
            from repro_torch.core.block_search import wallclock_plan_fitness
            fit = wallclock_plan_fitness(
                m, k, n, block_shape, r_keep, c_keep,
                int8_tiles=weight_bytes_per_el == 1, experts=experts)
            pop, gens = 8, 4     # measured evaluations cost more than math
        else:
            fit = plan_cost_model(
                m, k, n, block_shape, r_keep, c_keep,
                weight_bytes_per_el=weight_bytes_per_el,
                weight_scale_bytes=weight_scale_bytes, experts=experts)
            pop, gens = 16, 8
        res = genetic_search(plan_search_space(m, max_group, block_shape),
                             fit, population=pop, generations=gens, seed=0)
        _GENOME_CACHE[key] = (dict(res.best), res.best_fitness)
    genome, best = _GENOME_CACHE[key]
    if best == float("inf"):
        raise ValueError(
            f"no launch of the BCR kernel fits ({n}, {k}) on "
            f"{tuple(block_shape)} blocks keeping {r_keep}x{c_keep} "
            f"(G <= {max_group}, {experts} experts)")
    return dict(genome)


def tune_genome_for(packed, *, m: int, max_group: int = 1,
                    fitness: str = "analytic") -> Genome:
    """:func:`tuned_genome` for a (stacked) pack's geometry and tile
    bytes."""
    n, k = packed.shape
    wb, sb = _tile_bytes(packed)
    return tuned_genome(
        m, k, n, tuple(packed.block_shape), packed.vals.shape[-2],
        packed.vals.shape[-1], max_group=max_group, weight_bytes_per_el=wb,
        weight_scale_bytes=sb, experts=max(stacked_experts(packed), 1),
        fitness=fitness)


def tune_packed(packed: TBCRC, *, m: int = 8, max_group: int = 1,
                fitness: str = "analytic") -> TBCRC:
    """Attach a GA-tuned plan to ``packed`` (decode batch hint ``m``).
    int8 packs price their true traffic — 1-byte tiles plus the fp32 scale
    a tile — so the tuner retunes for the quantized bytes."""
    return attach_plan(packed, tune_genome_for(packed, m=m,
                                               max_group=max_group,
                                               fitness=fitness), m=m)


def plan_params(tree: Any, *, m: int = 8, fuse: bool = True,
                fitness: str = "analytic") -> Any:
    """Engine-build entry point: GA-tune every packed linear's plan and
    (optionally) fuse shared-activation projection groups. Idempotent —
    fused groups and plans already tuned (a genome set) are left alone;
    only untuned plans are tuned."""
    def tune(node: Any) -> Any:
        if isinstance(node, dict):
            if isinstance(node.get("w_packed"), TBCRC):
                packed = node["w_packed"]
                if packed.plan is not None and packed.plan.genome is not None:
                    return node          # the caller already tuned this plan
                node = dict(node)
                node["w_packed"] = tune_packed(packed, m=m, fitness=fitness)
                return node
            return {k: tune(v) for k, v in node.items()}
        if isinstance(node, list):
            return [tune(v) for v in node]
        return node

    tree = tune(tree)
    return (fuse_packed_projections(tree, m=m, fitness=fitness) if fuse
            else tree)


# ---------------------------------------------------------------------------
# Per-tile int8 quantization: the layout the kernels stream — the kept
# (R_keep, C_keep) tiles — with one scale per tile on the plan
# ---------------------------------------------------------------------------


def _scale_bytes(packed) -> int:
    """Itemsize of the per-tile scale the spmm streams beside a quantized
    tile (0 for an unquantized pack)."""
    plan = packed.plan
    if plan is None or plan.block_scales is None:
        return 0
    return plan.block_scales.element_size()


def quantize_packed(packed: TBCRC) -> TBCRC:
    """int8-quantize a packed weight's kept tiles, one symmetric fp32 scale
    per tile, stored on the plan. Idempotent; a stacked pack's scales gain
    its leading axes, as ``vals`` has them."""
    from repro_torch.kernels.quant import quantize_blocks
    if packed.vals.dtype == torch.int8:
        return packed
    plan = packed.plan
    if plan is None:
        plan = default_plan(packed.row_idx, packed.col_idx,
                            packed.block_shape)
    codes, scales = quantize_blocks(packed.vals)
    return dataclasses.replace(
        packed, vals=codes.contiguous(),
        plan=dataclasses.replace(plan, block_scales=scales.contiguous()))


def quantize_grouped(grouped: GroupedTBCRC) -> GroupedTBCRC:
    """int8-quantize a fused projection group (the scales gain the leading
    member axis the grouped kernels expect). Idempotent."""
    from repro_torch.kernels.quant import quantize_blocks
    if grouped.vals.dtype == torch.int8:
        return grouped
    codes, scales = quantize_blocks(grouped.vals)
    return dataclasses.replace(
        grouped, vals=codes.contiguous(),
        plan=dataclasses.replace(grouped.plan,
                                 block_scales=scales.contiguous()))


def quantize_packed_params(tree: Any) -> Any:
    """Walk a params tree and int8-quantize every packed linear and every
    fused group. Returns a new tree; other leaves are shared."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "w_packed" and isinstance(v, TBCRC):
                out[k] = quantize_packed(v)
            elif k == "w_group" and isinstance(v, GroupedTBCRC):
                out[k] = quantize_grouped(v)
            else:
                out[k] = quantize_packed_params(v)
        return out
    if isinstance(tree, list):
        return [quantize_packed_params(v) for v in tree]
    return tree


# ---------------------------------------------------------------------------
# Column-parallel splitting for tensor-parallel serving (the reference's
# ``kernels/plan.py`` splitters). A packed matrix shards cleanly along nb_r:
# row block i scatters only into output rows [i·br, (i+1)·br), so
# contiguous nb_r ranges, with rows renumbered into each shard's local
# space, are self-contained sub-packs whose outputs concatenate to the
# whole's, in order, through the unmodified kernels. gather_cols index K
# (the activation stays replicated), so they do not change. Every shard
# keeps the whole's dispatch genome and records the shard count
# (``BCRPlan.row_shards``), so it launches as the whole does.
# ---------------------------------------------------------------------------


def _slice_dim(a: torch.Tensor, s: int, step: int, ax: int) -> torch.Tensor:
    return a.narrow(ax % a.dim(), s * step, step).contiguous()


def splittable_packed(packed, n_shards: int) -> Optional[str]:
    """None if ``packed`` splits evenly into ``n_shards`` output shards,
    else the reason, in the reference's words."""
    if n_shards <= 1:
        return None
    nb_r = packed.vals.shape[-4]
    n, _ = packed.shape
    br = packed.block_shape[0]
    if nb_r % n_shards:
        return f"nb_r={nb_r} row blocks not divisible into {n_shards} shards"
    if n != nb_r * br:
        return (f"ragged last row block (N={n}, nb_r={nb_r}, br={br}) "
                f"cannot shard")
    return None


def _sub_plan(plan: Any, gcols: torch.Tensor, srows: torch.Tensor,
              scales: Optional[torch.Tensor], n_shards: int,
              group_size: int = 1) -> BCRPlan:
    """A shard's plan: its own flat vectors and scales, the whole's genome,
    and the whole's shard count times ``n_shards``."""
    genome = getattr(plan, "genome", None)
    return BCRPlan(gather_cols=gcols, scatter_rows=srows,
                   block_scales=scales,
                   genome=dict(genome) if genome is not None else None,
                   m_hint=getattr(plan, "m_hint", None),
                   row_shards=plan_shards(plan) * n_shards)


def split_packed_shard(packed: TBCRC, n_shards: int, s: int) -> TBCRC:
    """Shard ``s`` of :func:`split_packed`: output rows ``[s·N/n,
    (s+1)·N/n)``, its row blocks the contiguous nb_r slice, its
    ``scatter_rows`` regenerated in the shard-local row space and its
    ``shape`` the local ``(N/n, K)``. int8 tile scales slice with their
    blocks; the genome is the whole's. Leading (stacked) axes slice
    along their nb_r axis unchanged."""
    reason = splittable_packed(packed, n_shards)
    if reason:
        raise ValueError(f"split_packed: {reason}")
    step = packed.vals.shape[-4] // n_shards
    n, k = packed.shape
    row_idx = _slice_dim(packed.row_idx, s, step, -3)
    col_idx = _slice_dim(packed.col_idx, s, step, -3)
    gcols, srows = _index_vectors(row_idx, col_idx, packed.block_shape)
    scales = getattr(packed.plan, "block_scales", None)
    if scales is not None:
        scales = _slice_dim(scales, s, step, -2)
    return dataclasses.replace(
        packed, vals=_slice_dim(packed.vals, s, step, -4), row_idx=row_idx,
        col_idx=col_idx, shape=(n // n_shards, k),
        plan=_sub_plan(packed.plan, gcols, srows, scales, n_shards))


def split_packed(packed: TBCRC, n_shards: int) -> List[TBCRC]:
    """Split a packed weight into ``n_shards`` column-parallel sub-packs
    (:func:`split_packed_shard` each); one shard is the pack itself."""
    if n_shards == 1:
        return [packed]
    return [split_packed_shard(packed, n_shards, s)
            for s in range(n_shards)]


def _cat_or_none(parts: Sequence[Optional[torch.Tensor]], ax: int):
    if any(p is None for p in parts):
        return None
    return torch.cat(list(parts), dim=ax)


def merge_packed(shards: Sequence[TBCRC]) -> TBCRC:
    """Inverse of :func:`split_packed`: the whole pack, its flat vectors
    regenerated from the merged index planes."""
    shards = list(shards)
    first = shards[0]
    n_local, k = first.shape
    row_idx = torch.cat([s.row_idx for s in shards], dim=-3)
    col_idx = torch.cat([s.col_idx for s in shards], dim=-3)
    gcols, srows = _index_vectors(row_idx, col_idx, first.block_shape)
    scales = _cat_or_none([getattr(s.plan, "block_scales", None)
                           for s in shards], -2)
    plan = dataclasses.replace(
        _sub_plan(first.plan, gcols, srows, scales, 1),
        row_shards=max(1, plan_shards(first.plan) // len(shards)))
    return dataclasses.replace(
        first, vals=torch.cat([s.vals for s in shards], dim=-4),
        row_idx=row_idx, col_idx=col_idx,
        shape=(n_local * len(shards), k), plan=plan)


def _member(grouped: GroupedTBCRC, g: int) -> TBCRC:
    """Member ``g`` of a fused group as a standalone TBCRC, its tile scales
    and the group's genome riding along and its flat vectors rebuilt."""
    def take(a, ax):
        return a.select(ax % a.dim(), g).contiguous()
    row_idx, col_idx = take(grouped.row_idx, -4), take(grouped.col_idx, -4)
    gcols, srows = _index_vectors(row_idx, col_idx, grouped.block_shape)
    scales = getattr(grouped.plan, "block_scales", None)
    plan = _sub_plan(grouped.plan, gcols, srows,
                     take(scales, -3) if scales is not None else None, 1)
    return TBCRC(vals=take(grouped.vals, -5), row_idx=row_idx,
                 col_idx=col_idx, shape=grouped.shape,
                 block_shape=grouped.block_shape, plan=plan)


def split_grouped_shard(grouped: GroupedTBCRC, n_shards: int, s: int
                        ) -> GroupedTBCRC:
    """Shard ``s`` of :func:`split_grouped`. The fused flat vectors are
    g-major (member, then block), so they do not slice along the output
    axis: each member is split by :func:`split_packed_shard` and the
    shard's fused vectors are rebuilt with member offset ``g·N/n`` in the
    shard-local output space, as :func:`pack_group` lays out local
    members."""
    g_n = grouped.group_size
    mems = [split_packed_shard(_member(grouped, g), n_shards, s)
            for g in range(g_n)]
    n_local = grouped.shape[0] // n_shards
    ax = grouped.vals.dim() - 5          # the group axis, after any expert
    gcols = torch.cat([m.plan.gather_cols for m in mems], dim=-1)
    srows = torch.cat([m.plan.scatter_rows + g * n_local
                       for g, m in enumerate(mems)], dim=-1)
    scales = [m.plan.block_scales for m in mems]
    scales = (torch.stack(scales, dim=ax).contiguous()
              if all(sc is not None for sc in scales) else None)
    plan = _sub_plan(grouped.plan, gcols.to(torch.int32),
                     srows.to(torch.int32), scales, n_shards)
    return GroupedTBCRC(
        vals=torch.stack([m.vals for m in mems], dim=ax).contiguous(),
        row_idx=torch.stack([m.row_idx for m in mems], dim=ax).contiguous(),
        col_idx=torch.stack([m.col_idx for m in mems], dim=ax).contiguous(),
        plan=plan, shape=(n_local, grouped.shape[1]),
        block_shape=grouped.block_shape, group_size=g_n)


def split_grouped(grouped: GroupedTBCRC, n_shards: int
                  ) -> List[GroupedTBCRC]:
    """Split a fused projection group into ``n_shards`` per-shard groups
    (:func:`split_grouped_shard` each)."""
    reason = splittable_packed(_member(grouped, 0), n_shards)
    if reason:
        raise ValueError(f"split_grouped: {reason}")
    if n_shards == 1:
        return [grouped]
    return [split_grouped_shard(grouped, n_shards, s)
            for s in range(n_shards)]


def merge_grouped(shards: Sequence[GroupedTBCRC]) -> GroupedTBCRC:
    """Inverse of :func:`split_grouped`: the canonical g-major vectors
    rebuilt from the merged index planes, as :func:`pack_group` lays them
    out."""
    shards = list(shards)
    first = shards[0]
    g_n = first.group_size
    n_full = first.shape[0] * len(shards)
    row_idx = torch.cat([s.row_idx for s in shards], dim=-3)
    col_idx = torch.cat([s.col_idx for s in shards], dim=-3)
    gcols, srows = [], []
    for g in range(g_n):
        gc, sr = _index_vectors(row_idx.select(row_idx.dim() - 4, g),
                                col_idx.select(col_idx.dim() - 4, g),
                                first.block_shape)
        gcols.append(gc)
        srows.append(sr + g * n_full)
    scales = _cat_or_none([getattr(s.plan, "block_scales", None)
                           for s in shards], -2)
    plan = dataclasses.replace(
        _sub_plan(first.plan, torch.cat(gcols, dim=-1).to(torch.int32),
                  torch.cat(srows, dim=-1).to(torch.int32), scales, 1),
        row_shards=max(1, plan_shards(first.plan) // len(shards)))
    return GroupedTBCRC(
        vals=torch.cat([s.vals for s in shards], dim=-4),
        row_idx=row_idx, col_idx=col_idx, plan=plan,
        shape=(n_full, first.shape[1]), block_shape=first.block_shape,
        group_size=g_n)
