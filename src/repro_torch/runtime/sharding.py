"""Sharding rules (the reference's ``runtime/sharding.py``): params
(TP/FSDP/EP), batches (DP over pod×data), and decode caches
(context-parallel KV), as specs over a ``torch.distributed`` mesh.

Rules are *safe by construction*: any dim not divisible by its target mesh
axes falls back to replication, so one rule set serves every arch (e.g.
whisper's 51866 vocab or rwkv's 40 heads simply replicate on a 16-wide
model axis instead of erroring).

A spec is a tuple with one entry a dim, each None (replicated), a mesh
axis name, or a tuple of names (the reference's ``PartitionSpec``
entries); :func:`placements` turns one into DTensor placements over a
``DeviceMesh``. The rules read only a mesh's axis names and sizes
(:func:`axis_sizes`): a ``DeviceMesh`` (``mesh_dim_names``, ``shape``) or
any object with the reference mesh's ``axis_names`` and ``devices.shape``.

The port's layers are unstacked (``convert.py``): where the reference
stacks a layer's leaves on a leading repeat axis, the port's leaf has no
such axis. The functions take that axis's size as ``stack`` and apply the
reference's rule to the stacked shape, then drop its leading entry, so the
port's spec of a leaf is the reference's spec of the stacked leaf without
it (:func:`stack_sizes` gives each stacked layer's size).
"""

from __future__ import annotations

import fnmatch
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

PyTree = Any
Spec = Tuple[Any, ...]

# (glob over param path) -> right-aligned logical spec for the trailing dims.
# Leading dims (layer-stacking) are padded with None. "fsdp" resolves to the
# data axis only when fsdp=True.
PARAM_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    ("*embed*table", ("model", None)),
    ("*dec_pos*", (None, None)),
    ("*lm_head*w", ("model", "fsdp")),
    # MoE experts FIRST (before the generic attention/mlp rules, which would
    # otherwise shadow them): 2D sharding — experts over data (EP),
    # per-expert FFN over model (TP). E-over-model-only replicates all
    # experts across data (50 GB/chip for llama4-maverick → OOM; perf
    # iteration B1).
    ("*ffn*experts*wo*w", ("data", None, "model")),    # (E, d, dff)
    ("*ffn*experts*w[gi]*w", ("data", "model", None)), # (E, dff, d)
    ("*router*w", (None, None)),
    # attention
    ("*w[qkv]*w", ("model", "fsdp")),
    ("*w[qkv]*b", ("model",)),
    ("*wo*w", ("fsdp", "model")),
    ("*w[gi]*w", ("model", "fsdp")),
    ("*mlp*wi*b", ("model",)),
    # mamba
    ("*in_proj*w", ("model", "fsdp")),
    ("*out_proj*w", ("fsdp", "model")),
    ("*conv_w", (None, "model")),
    ("*conv_b", ("model",)),
    ("*x_proj*w", (None, "model")),
    ("*dt_proj*w", ("model", None)),
    ("*A_log", ("model", None)),
    ("*/D", ("model",)),
    # rwkv
    ("*w_lora_[ab]", (None, None)),
    ("*mixer*wr*w", ("model", "fsdp")),
    ("*mixer*wk*w", ("model", "fsdp")),
    ("*mixer*wv*w", ("model", "fsdp")),
    ("*mixer*wg*w", ("model", "fsdp")),
]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a reference-style
    mesh (``axis_names``, ``devices.shape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``: ``Shard(d)`` on each
    mesh dim that spec entry ``d`` names (a tuple entry shards dim ``d``
    over its axes, major to minor in mesh order, as the reference's
    ``PartitionSpec`` does), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axis_sizes(mesh):
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        if len(dims) > 1:
            raise ValueError(f"axis {name!r} shards dims {dims} of {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One rank's shard shape of a ``shape`` tensor laid out by ``spec``
    (every sharded dim divides its axes: the rules shard no other)."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, ax in zip(shape, spec):
        n = math.prod(sizes[a] for a in
                      (ax if isinstance(ax, tuple) else (ax,))) if ax else 1
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {ax} ({n})")
        out.append(dim // n)
    return tuple(out)


def _path_str(path: str) -> str:
    """A ``repro_torch.tree`` path (``['layers'][0]['mixer']['wq']['w']``)
    in the reference's form (``/layers/0/mixer/wq/w``)."""
    return path.replace("'", "").replace("]", "").replace("[", "/")


def _resolve(axis: Optional[str], fsdp: bool) -> Optional[str]:
    if axis == "fsdp":
        return "data" if fsdp else None
    return axis


def _fits(dim: int, axis: Optional[str], mesh) -> bool:
    if axis is None:
        return True
    sizes = axis_sizes(mesh)
    if axis not in sizes:
        return False
    return dim % sizes[axis] == 0 and dim >= sizes[axis]


def _unstack(spec: List[Any], stack: int) -> Spec:
    if stack:
        if spec[0] is not None:
            raise ValueError(f"a rule shards the stacking axis: {spec}")
        spec = spec[1:]
    return tuple(spec)


def param_pspec(path: str, leaf, mesh, *, fsdp: bool, stack: int = 0
                ) -> Spec:
    """The reference's spec of the param at ``path``; ``stack`` is the size
    of the repeat axis the reference's leaf carries ahead of ``leaf``'s
    shape (0: none)."""
    name = _path_str(path)
    shape = ((stack,) if stack else ()) + tuple(leaf.shape)
    ndim = len(shape)
    for pattern, logical in PARAM_RULES:
        if fnmatch.fnmatch(name, pattern):
            if len(logical) > ndim:
                break
            spec: List[Optional[str]] = [None] * (ndim - len(logical))
            for d, ax in zip(range(ndim - len(logical), ndim), logical):
                ax = _resolve(ax, fsdp)
                spec.append(ax if _fits(shape[d], ax, mesh) else None)
            return _unstack(spec, stack)
    return (None,) * len(leaf.shape)  # replicate (norms, biases, tables)


def _stack_of(path: str, stacks: Dict[str, int]) -> int:
    return next((n for prefix, n in stacks.items()
                 if path.startswith(prefix + "[")), 0)


def param_specs(params: PyTree, mesh, *, fsdp: bool = False,
                stacks: Optional[Dict[str, int]] = None) -> Dict[str, Spec]:
    """``{path: spec}`` (:func:`param_pspec`) of every tensor leaf of
    ``params``; ``stacks`` maps a stacked layer's path to its repeat size
    (:func:`stack_sizes`)."""
    from repro_torch.tree import flatten
    stacks = stacks or {}
    return {path: param_pspec(path, leaf, mesh, fsdp=fsdp,
                              stack=_stack_of(path, stacks))
            for path, leaf in flatten(params) if leaf is not None}


def param_shardings(params: PyTree, mesh, *, fsdp: bool = False,
                    stacks: Optional[Dict[str, int]] = None
                    ) -> Dict[str, tuple]:
    """``{path: DTensor placements}`` of every param leaf."""
    return {k: placements(v, mesh) for k, v in
            param_specs(params, mesh, fsdp=fsdp, stacks=stacks).items()}


def _find_period(plan: List[Tuple[str, str]]) -> int:
    n = len(plan)
    for p in range(1, n + 1):
        if n % p == 0 and plan == plan[:p] * (n // p):
            return p
    return n


def stack_sizes(cfg) -> Dict[str, int]:
    """``{layer path: repeat size}`` of the layers the reference stacks:
    a causal LM's layers after its unstacked MoE prefix (the reference's
    ``stack_plan``: ``repeats`` of the layer pattern's period), an encdec
    model's ``enc_layers`` and ``dec_layers``."""
    if cfg.family == "encdec":
        return {f"['enc_layers'][{i}]": cfg.encoder_layers
                for i in range(cfg.encoder_layers)} | {
            f"['dec_layers'][{i}]": cfg.num_layers
            for i in range(cfg.num_layers)}
    from repro_torch.models.causal_lm import layer_plan
    plan = layer_plan(cfg)
    first = cfg.moe_first_dense if cfg.num_experts else 0
    rest = plan[first:]
    if not rest or not cfg.scan_layers:
        return {}
    repeats = len(rest) // _find_period(rest)
    return {f"['layers'][{i}]": repeats for i in range(first, len(plan))}


# ---------------------------------------------------------------------------
# Batches and caches
# ---------------------------------------------------------------------------


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def _axes_size(mesh, axes: Sequence[str]) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes) if axes else 1


def batch_pspec(leaf_shape, mesh) -> Spec:
    """Shard dim0 (global batch) over pod×data when divisible."""
    dp = _dp_axes(mesh)
    if leaf_shape and leaf_shape[0] % max(_axes_size(mesh, dp), 1) == 0 \
            and leaf_shape[0] >= _axes_size(mesh, dp):
        return (dp,) + (None,) * (len(leaf_shape) - 1)
    return (None,) * len(leaf_shape)


def cache_pspec(leaf_shape, mesh, *, batch: int, capacity: int,
                stack: int = 0) -> Spec:
    """Decode-cache sharding (DESIGN.md §5); ``stack`` as in
    :func:`param_pspec` (the reference stacks a scanned layer's cache
    leaves like its params).

    Dims are identified by SIZE (the cache tree mixes layer-stacked KV,
    SSM state, and conv tails — positional heuristics mis-shard the
    leading layer-stack dim):

    * the dim equal to ``batch``    → pod×data (DP), when divisible;
    * the dim equal to ``capacity`` → "model"  (context-parallel KV);
    * else (SSM state / conv tail) the widest remaining dim ≥ model size
      that divides → "model";
    * if batch is unshardable (long_500k B=1), the capacity dim takes
      data+model jointly so the whole mesh holds the 500k cache.
    """
    leaf_shape = ((stack,) if stack else ()) + tuple(leaf_shape)
    names = axis_sizes(mesh)
    ndim = len(leaf_shape)
    spec: List[Any] = [None] * ndim
    dp = _dp_axes(mesh)
    dp_n = _axes_size(mesh, dp)
    model_n = _axes_size(mesh, ("model",)) if "model" in names else 1
    joint = tuple(a for a in ("data", "model") if a in names)
    jn = _axes_size(mesh, joint)

    batch_ok = batch % max(dp_n, 1) == 0 and batch >= dp_n
    batch_dim = next((d for d, s in enumerate(leaf_shape) if s == batch), None)
    # the capacity dim: prefer one *after* the batch dim (B=1 collides)
    cap_dim = next((d for d, s in enumerate(leaf_shape)
                    if s == capacity and d != batch_dim), None)

    if batch_dim is not None and batch_ok:
        spec[batch_dim] = dp
    if cap_dim is not None:
        if not (batch_dim is not None and batch_ok) and \
                capacity % jn == 0 and capacity >= jn:
            spec[cap_dim] = joint         # long-context, tiny batch
        elif capacity % model_n == 0 and capacity >= model_n:
            spec[cap_dim] = "model"
    else:
        # SSM/conv state: widest remaining dim onto "model"
        cands = [(s, d) for d, s in enumerate(leaf_shape)
                 if spec[d] is None and d > 0
                 and s % model_n == 0 and s >= model_n]
        if cands:
            _, d = max(cands)
            spec[d] = "model"
    return _unstack(spec, stack)


def batch_shardings(batch: PyTree, mesh) -> Dict[str, tuple]:
    """``{path: DTensor placements}`` of every batch leaf."""
    from repro_torch.tree import flatten
    return {path: placements(batch_pspec(leaf.shape, mesh), mesh)
            for path, leaf in flatten(batch)}


def cache_specs(cache: PyTree, mesh, *, batch: int, capacity: int,
                stacks: Optional[Dict[str, int]] = None) -> Dict[str, Spec]:
    """``{path: spec}`` (:func:`cache_pspec`) of every cache leaf. A causal
    LM's cache is a list of per-layer dicts (``['layers'][i]`` in
    ``stacks`` is entry ``[i]`` here); an encdec cache keeps the
    reference's stacked layout."""
    from repro_torch.tree import flatten
    stacks = {k.replace("['layers']", "", 1): v
              for k, v in (stacks or {}).items() if k.startswith("['layers']")}
    return {path: cache_pspec(leaf.shape, mesh, batch=batch,
                              capacity=capacity,
                              stack=_stack_of(path, stacks))
            for path, leaf in flatten(cache)}


def cache_shardings(cache: PyTree, mesh, *, batch: int, capacity: int,
                    stacks: Optional[Dict[str, int]] = None
                    ) -> Dict[str, tuple]:
    """``{path: DTensor placements}`` of every cache leaf."""
    return {k: placements(v, mesh) for k, v in
            cache_specs(cache, mesh, batch=batch, capacity=capacity,
                        stacks=stacks).items()}


def replicated(mesh) -> tuple:
    return placements((), mesh)
