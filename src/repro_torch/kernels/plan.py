"""Pack-time execution plans for BCR matmuls — the data half.

Everything derivable from the static sparsity pattern is computed once at
pack time and carried beside the packed weight:

* ``gather_cols``  — flat int32 ``(nb_r·nb_c·C_keep,)`` global column ids,
  ``j·bc + col_idx[i, j, c]``: one gather takes every surviving activation
  for the plain path (:func:`repro_torch.kernels.ref.bcr_spmm_packed_ref`).
* ``scatter_rows`` — flat int32 ``(nb_r·nb_c·R_keep,)`` global output rows,
  ``i·br + row_idx[i, j, r]``: one scatter-add places the partial products.

The CUDA kernels read ``row_idx``/``col_idx`` directly; the vectors serve the
plain path. The reference's one-hot planes, ``m_tile`` and ``grid_order``
are dispatch knobs of its TPU kernel and are not ported.

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

    def nbytes(self) -> int:
        return self.gather_cols.numel() * 4 + self.scatter_rows.numel() * 4


def _index_vectors(row_idx: torch.Tensor, col_idx: torch.Tensor,
                   block_shape: Tuple[int, int],
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-local index planes → flat global take/scatter vectors."""
    br, bc = block_shape
    nb_r, nb_c = col_idx.shape[0], col_idx.shape[1]
    dev = col_idx.device
    gcols = (torch.arange(nb_c, dtype=torch.int32, device=dev)[None, :, None]
             * bc + col_idx).reshape(-1)
    srows = (torch.arange(nb_r, dtype=torch.int32, device=dev)[:, None, None]
             * br + row_idx).reshape(-1)
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
    scatters into one ``(M, G·N)`` output.
    """

    vals: torch.Tensor        # (G, nb_r, nb_c, R_keep, C_keep)
    row_idx: torch.Tensor     # (G, nb_r, nb_c, R_keep)
    col_idx: torch.Tensor     # (G, nb_r, nb_c, C_keep)
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
    """Stack same-shaped packed weights into one fused-launch group."""
    members = list(members)
    if not groupable(members):
        raise ValueError("grouped members must share shape/block/kept/dtype")
    n = members[0].shape[0]
    gcols_parts, srows_parts = [], []
    for g, mem in enumerate(members):
        gc, sr = _index_vectors(mem.row_idx, mem.col_idx, mem.block_shape)
        gcols_parts.append(gc)
        srows_parts.append(sr + g * n)
    plan = BCRPlan(gather_cols=torch.cat(gcols_parts),
                   scatter_rows=torch.cat(srows_parts))
    return GroupedTBCRC(
        vals=torch.stack([m.vals for m in members]).contiguous(),
        row_idx=torch.stack([m.row_idx for m in members]).contiguous(),
        col_idx=torch.stack([m.col_idx for m in members]).contiguous(),
        plan=plan, shape=members[0].shape,
        block_shape=members[0].block_shape, group_size=len(members))


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
        fused["b"] = torch.stack([tree[k]["b"] for k in member_keys])
    for k in member_keys:
        del tree[k]
    tree[fused_key] = fused
    return True


def fuse_packed_projections(tree: Any) -> Any:
    """Walk a packed params tree and fuse Q/K/V and gate/up projections
    whose packed geometry matches. Returns a new tree; leaves are shared."""
    if isinstance(tree, dict):
        out = {k: fuse_packed_projections(v) for k, v in tree.items()}
        for fused_key, member_keys, requires in _GROUPS:
            if (all(k in out for k in member_keys)
                    and all(k in out for k in requires)):
                _try_fuse(out, fused_key, member_keys)
        return out
    if isinstance(tree, list):
        return [fuse_packed_projections(v) for v in tree]
    return tree
