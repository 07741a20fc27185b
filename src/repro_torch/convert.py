"""Convert a reference-package param tree (as numpy) into the port's params.

``from_jax_params`` takes the reference's params after its ``pack_params`` /
``plan_params`` with every array leaf turned into numpy (for example with
``jax.tree_util.tree_map(np.asarray, params)``, which keeps the packed
containers and swaps their leaves). It handles:

* dense ``{"w", "b"}`` linears and every other plain array leaf;
* ``{"w_packed": TBCRC}`` — vals and index planes, plus the plan's flat
  gather/scatter vectors and, for int8-quantized packs, its per-tile
  ``block_scales``;
* ``{"w_group": GroupedTBCRC[, "b": (G, N)]}`` — fused ``wkv`` / ``wqkv`` /
  ``wgi`` groups.

The reference scans its layers: ``params["stack"]`` is a list (one entry per
position of the repeating layer pattern) whose leaves — index planes and
plan vectors included — carry a leading repeat axis. The converter unstacks
that axis into the port's ``params["layers"]`` list, in the reference's
execution order (unscanned ``prefix`` layers first).

The packed containers are recognised by their attributes, not their class:
the port imports nothing of the reference. fp packed ``vals`` are cast to
the activation dtype, as the port's ``pack_params`` leaves them; int8 codes
stay int8 and their scales fp32. The TPU dispatch knobs of a plan (one-hot
planes, ``m_tile``, ``grid_order``) are dropped.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bcrc import TBCRC
from repro_torch.kernels.plan import BCRPlan, GroupedTBCRC


def _tensor(a: Any, index: Optional[int], device) -> torch.Tensor:
    a = np.asarray(a)
    if index is not None:
        a = a[index]
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def _is_packed(node: Any) -> bool:
    return all(hasattr(node, f) for f in ("vals", "row_idx", "col_idx",
                                          "block_shape", "plan"))


def _plan(plan: Any, index: Optional[int], device) -> BCRPlan:
    scales = getattr(plan, "block_scales", None)
    return BCRPlan(
        gather_cols=_tensor(plan.gather_cols, index, device).to(torch.int32),
        scatter_rows=_tensor(plan.scatter_rows, index, device).to(torch.int32),
        block_scales=(None if scales is None else
                      _tensor(scales, index, device).to(torch.float32)))


def _convert(node: Any, index: Optional[int], cfg: ModelConfig, device):
    if isinstance(node, dict):
        return {k: _convert(v, index, cfg, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, index, cfg, device) for v in node]
    if _is_packed(node):
        vals = _tensor(node.vals, index, device)
        common = dict(
            vals=vals if vals.dtype == torch.int8 else vals.to(cfg.act_dtype),
            row_idx=_tensor(node.row_idx, index, device).to(torch.int32),
            col_idx=_tensor(node.col_idx, index, device).to(torch.int32),
            shape=tuple(int(d) for d in node.shape),
            block_shape=tuple(int(d) for d in node.block_shape),
            plan=_plan(node.plan, index, device))
        if hasattr(node, "group_size"):
            return GroupedTBCRC(group_size=int(node.group_size), **common)
        return TBCRC(**common)
    if node is None:
        return None
    return _tensor(node, index, device)


def _repeats(stack_entry: Any) -> int:
    """Length of the leading (scanned) axis of a stacked layer dict."""
    while isinstance(stack_entry, dict):
        stack_entry = next(iter(stack_entry.values()))
    if _is_packed(stack_entry):
        return int(np.asarray(stack_entry.row_idx).shape[0])
    return int(np.asarray(stack_entry).shape[0])


def from_jax_params(tree: Any, cfg: ModelConfig, device="cuda") -> dict:
    """The port's params for a reference param tree of numpy leaves."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: only the dense family is ported so far")
    dev = resolve_device(device)
    layers = [_convert(lp, None, cfg, dev) for lp in tree.get("prefix", [])]
    stack = tree.get("stack", [])
    if stack:
        for rep in range(_repeats(stack[0])):
            for lp in stack:
                layers.append(_convert(lp, rep, cfg, dev))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"converted {len(layers)} layers, config has "
                         f"{cfg.num_layers}")
    return {
        "embed": _convert(tree["embed"], None, cfg, dev),
        "final_norm": _convert(tree["final_norm"], None, cfg, dev),
        "lm_head": _convert(tree["lm_head"], None, cfg, dev),
        "layers": layers,
    }
