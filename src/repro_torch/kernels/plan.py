"""Pack-time execution plans for BCR matmuls — the data half.

Everything derivable from the static sparsity pattern is computed once at
pack time and carried beside the packed weight:

* ``gather_cols``  — flat int32 ``(nb_r·nb_c·C_keep,)`` global column ids,
  ``j·bc + col_idx[i, j, c]``: one gather takes every surviving activation
  for the plain path (:func:`repro_torch.kernels.ref.bcr_spmm_packed_ref`).
* ``scatter_rows`` — flat int32 ``(nb_r·nb_c·R_keep,)`` global output rows,
  ``i·br + row_idx[i, j, r]``: one scatter-add places the partial products.

* ``block_scales`` — for int8-quantized vals, one fp32 scale per kept
  ``(R_keep, C_keep)`` tile, ``([G,] nb_r, nb_c)``; ``None`` for fp vals.

The CUDA kernels read ``row_idx``/``col_idx`` (and ``block_scales``)
directly; the vectors serve the plain path. The reference's one-hot planes,
``m_tile`` and ``grid_order`` are dispatch knobs of its TPU kernel and are
not ported.

:class:`GroupedTBCRC` stacks projections that share one activation (Q/K/V,
gate/up) for a single kernel launch. The reference fuses a group only when
its GA plan tuner votes to (``kernels/plan.py`` of the reference, the
``group_size`` check in ``_try_fuse``). The port has no tuner yet, so
:func:`fuse_packed_projections` fuses every groupable member set.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.bcrc import TBCRC


@dataclasses.dataclass
class BCRPlan:
    """Flat gather/scatter vectors for one packed (or grouped) matrix."""

    gather_cols: torch.Tensor                 # (L_c,) int32 flat global cols
    scatter_rows: torch.Tensor                # (L_r,) int32 flat global rows
    # per-tile fp32 dequant scales of int8 vals, ([G,] nb_r, nb_c), applied
    # to each block's fp32 partial before the scatter (None: fp vals)
    block_scales: Optional[torch.Tensor] = None

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


def pack_group(members: Sequence[TBCRC]) -> GroupedTBCRC:
    """Stack same-shaped packed weights into one fused-launch group; stacked
    members (experts) group per expert, the group axis after theirs."""
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
    plan = BCRPlan(gather_cols=torch.cat(gcols_parts, dim=-1),
                   scatter_rows=torch.cat(srows_parts, dim=-1),
                   block_scales=bscales)
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
              member_keys: Tuple[str, ...]) -> bool:
    members = [_packed_entry(tree.get(k)) for k in member_keys]
    if any(p is None for p in members) or not groupable(members):
        return False
    has_bias = ["b" in tree[k] for k in member_keys]
    if any(has_bias) and not all(has_bias):
        return False
    fused: Dict[str, Any] = {"w_group": pack_group(members)}
    if all(has_bias):
        # group axis at -2, so stacked (expert) axes stay leading
        fused["b"] = torch.stack([tree[k]["b"] for k in member_keys], dim=-2)
    for k in member_keys:
        del tree[k]
    tree[fused_key] = fused
    return True


def fuse_packed_projections(tree: Any, _key: Optional[str] = None) -> Any:
    """Walk a packed params tree and fuse Q/K/V and gate/up projections
    whose packed geometry matches. Returns a new tree; leaves are shared.

    A cross-attention dict (parent key ``cross_attn``) never fuses Q with
    K/V: Q projects the decoder stream, K/V the encoder's output. Its K/V
    still fuse into ``wkv``."""
    if isinstance(tree, dict):
        out = {k: fuse_packed_projections(v, k) for k, v in tree.items()}
        for fused_key, member_keys, requires in _GROUPS:
            if fused_key == "wqkv" and _key == "cross_attn":
                continue
            if (all(k in out for k in member_keys)
                    and all(k in out for k in requires)):
                _try_fuse(out, fused_key, member_keys)
        return out
    if isinstance(tree, list):
        return [fuse_packed_projections(v, _key) for v in tree]
    return tree


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
