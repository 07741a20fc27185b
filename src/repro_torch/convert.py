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
  ``wgi`` groups;
* a MoE layer's ``{"router", "experts"[, "shared"]}``: the router and the
  shared experts as above, the experts' packs (or dense ``w``) stacked on
  their leading E axis, index planes, plan vectors and int8 scales with
  it;
* the recurrent mixers' plain leaves (mamba ``A_log``, ``D``, ``conv_w``,
  ``conv_b``; RWKV ``mu``, ``w0``, ``w_lora_a``/``w_lora_b``, ``u``,
  ``ln_scale``) as arrays, and their linears as above (mamba's
  ``dt_proj`` with its bias).

The reference scans its layers: ``params["stack"]`` is a list (one entry per
position of the repeating layer pattern: one layer for a dense or ssm
stack, jamba's whole 8-layer period) whose leaves — index planes and plan
vectors included — carry a leading repeat axis. The converter unstacks
that axis into the port's ``params["layers"]`` list, in the reference's
execution order (unscanned ``prefix`` layers first, then repeat by repeat
each position of the pattern). An encdec tree's ``enc_stack`` and
``dec_stack`` are each one layer dict with a leading layer axis (fused
``wqkv``/``wkv`` groups and their ``(G, N)`` biases included); they unstack
into ``enc_layers`` and ``dec_layers``, beside ``enc_norm``,
``dec_embed``, ``dec_pos``, ``dec_norm`` and ``lm_head``.

``from_jax_gru`` converts the reference's GRU (``models/gru.py``: embed,
cells, head; dense, or packed by its ``pack_params``) with the same leaf
rules.

``from_jax_train_state`` carries a reference ``TrainState`` across the same
way: params, AdamW moments (nested like the params) and step, and the ADMM
Z/U trees (None on unpruned leaves) or the retrain masks. ``from_jax_skip``
converts a reference ``SkipPacked`` and computes the port's ``row_start``.

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
from repro_torch.core.admm import ADMMState
from repro_torch.core.bcrc import TBCRC
from repro_torch.kernels.bcr_spmm_skip import SkipPacked, row_start_from_bi
from repro_torch.kernels.plan import BCRPlan, GroupedTBCRC
from repro_torch.launch.train import TrainState
from repro_torch.models.causal_lm import PORTED_FAMILIES
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import leaves


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


def _first_leaf(node: Any) -> Any:
    """The first non-None leaf of a layer dict (None if it has none)."""
    if _is_packed(node) or not isinstance(node, (dict, list, tuple)):
        return node
    items = node.values() if isinstance(node, dict) else node
    for v in items:
        leaf = _first_leaf(v)
        if leaf is not None:
            return leaf
    return None


def _repeats(stack_entry: Any) -> int:
    """Length of the leading (scanned) axis of a stacked layer dict."""
    leaf = _first_leaf(stack_entry)
    if _is_packed(leaf):
        return int(np.asarray(leaf.row_idx).shape[0])
    return int(np.asarray(leaf).shape[0])


def from_jax_params(tree: Any, cfg: ModelConfig, device="cuda") -> dict:
    """The port's params for a reference param tree of numpy leaves (also
    any tree nested like it: AdamW moments, ADMM Z/U with None leaves)."""
    if cfg.family == "encdec":
        return _from_jax_encdec(tree, cfg, device)
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: only the {PORTED_FAMILIES} families are "
            f"ported so far")
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


def _from_jax_encdec(tree: Any, cfg: ModelConfig, device) -> dict:
    dev = resolve_device(device)

    def unstack(stack: str, n: int) -> list:
        if _repeats(tree[stack]) != n:
            raise ValueError(f"{stack} holds {_repeats(tree[stack])} "
                             f"layers, config has {n}")
        return [_convert(tree[stack], i, cfg, dev) for i in range(n)]

    def leaf(key: str):
        return _convert(tree[key], None, cfg, dev)

    # the order of encdec.init_params
    return {"enc_layers": unstack("enc_stack",
                                  cfg.encoder_layers or cfg.num_layers),
            "enc_norm": leaf("enc_norm"), "dec_embed": leaf("dec_embed"),
            "dec_pos": leaf("dec_pos"),
            "dec_layers": unstack("dec_stack", cfg.num_layers),
            "dec_norm": leaf("dec_norm"), "lm_head": leaf("lm_head")}


def from_jax_gru(tree: Any, cfg: ModelConfig, device="cuda") -> dict:
    """The port's GRU params for a reference GRU tree of numpy leaves. Its
    linears are dense ``{"w"}`` or, after the reference's ``pack_params``
    under ``cfg``, ``{"w_packed": TBCRC}``, whose fp vals are cast to
    ``cfg.dtype`` as the port's ``pack_params`` leaves them."""
    if set(tree) != {"embed", "cells", "head"}:
        raise ValueError(f"not a GRU tree: keys {sorted(tree)}")
    dev = resolve_device(device)
    return {k: _convert(tree[k], None, cfg, dev)
            for k in ("embed", "cells", "head")}


def from_jax_train_state(state: Any, cfg: ModelConfig, device="cuda"):
    """The port's ``launch.train.TrainState`` for a reference ``TrainState``
    of numpy leaves: params, ``AdamWState(m, v, step)``, ``ADMMState(z, u,
    admm_iter)`` or None, masks or None — each tree unstacked like the
    params. Step counters become int32 0-d CPU tensors."""
    def tree(t):
        return None if t is None else from_jax_params(t, cfg, device)

    def counter(c):
        return torch.tensor(int(np.asarray(c)), dtype=torch.int32)

    params = tree(state.params)
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    opt = AdamWState(tree(state.opt.m), tree(state.opt.v),
                     counter(state.opt.step))
    admm = None
    if state.admm is not None:
        admm = ADMMState(tree(state.admm.z), tree(state.admm.u),
                         counter(state.admm.admm_iter))
    return TrainState(params, opt, admm, tree(state.masks))


def from_jax_skip(packed: Any, device="cuda"):
    """The port's ``SkipPacked`` for a reference one (numpy leaves): the
    same tiles, ``bi``/``bj``/``last`` and ``row_mask``, plus ``row_start``
    computed from ``bi``."""
    dev = resolve_device(device)
    bi = _tensor(packed.bi, None, dev).to(torch.int32)
    n, br = int(packed.shape[0]), int(packed.block_shape[0])
    row_mask = getattr(packed, "row_mask", None)
    return SkipPacked(
        tiles=_tensor(packed.tiles, None, dev), bi=bi,
        bj=_tensor(packed.bj, None, dev).to(torch.int32),
        last=_tensor(packed.last, None, dev).to(torch.int32),
        shape=tuple(int(d) for d in packed.shape),
        block_shape=tuple(int(d) for d in packed.block_shape),
        row_mask=(None if row_mask is None
                  else _tensor(row_mask, None, dev).to(torch.bool)),
        row_start=row_start_from_bi(bi, n // br))
