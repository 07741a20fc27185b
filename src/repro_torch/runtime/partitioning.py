"""Logical-axis partitioning (the reference's ``runtime/partitioning.py``,
MaxText-style logical rules) over ``torch.distributed`` meshes.

Models annotate activations with *logical* axis names; the launcher
installs a rule set and a mesh with :func:`use_rules`. Outside that context
:func:`act` returns its argument itself, so tests, the engine and the chip
phases run untouched. Under rules, :func:`act` redistributes a ``DTensor``
to the placements the rules give (the reference's
``with_sharding_constraint``); a plain tensor comes back unchanged. Dims not
divisible by their mapped mesh axes stay replicated (safe by construction,
as ``runtime/sharding.py``).

The rules read only a mesh's axis names and sizes
(:func:`repro_torch.runtime.sharding.axis_sizes`).

Where the reference's plain op on a sharded array is partitioned by GSPMD
into local work and a small collective, and DTensor's own strategy would
gather a whole dim on every rank, the models call this module's form of
the op instead: :func:`softmax` (along a context-parallel dim),
:func:`lookup` (a vocab-parallel embedding), :func:`xent_terms` (a
vocab-parallel cross entropy) and :func:`write_rows` (a context-parallel
cache write). On plain tensors each is the plain op, so the models hold no
placement types.
"""

from __future__ import annotations

import contextlib
import math
import sys
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.runtime.sharding import axis_sizes, placements

Axis = Union[None, str, Tuple[str, ...]]

# Default logical rules for the production mesh. "batch" spans pod+data so
# pure DP scales across pods; tensor dims live on "model"; "seq_sp" is the
# sequence-parallel residual mapping used by large-model training.
TRAIN_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "batch_heads": ("pod", "data", "model"),  # merged (B, Hkv) in attention
    "batch_kv": ("pod", "data"),   # fallback split: (B, Hkv) over DP axes...
    "heads_g": "model",            # ...and GQA q-groups over model
    "seq": None,
    "seq_sp": "model",       # sequence-parallel residual stream
    "kv_seq": None,          # KV length dim (context parallel at decode)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "data",   # EP over data; per-expert FFN is TP over model
    "fsdp": "data",
}

# Decode: a seq axis of length 1 cannot be sequence-parallel; the KV cache
# is context-parallel over "model" instead (partial attention + small psum).
DECODE_RULES: Dict[str, Axis] = dict(TRAIN_RULES, seq_sp=None,
                                     kv_seq="model", kv_heads=None)


class _Active:
    """The installed rules. Process-wide, where the reference's are
    thread-local: autograd runs a card's backward pass (and a checkpointed
    layer's recompute) on a worker thread of its own, which must see the
    rules the forward pass saw."""

    def __init__(self):
        self.rules: Optional[Dict[str, Axis]] = None
        self.mesh = None
        self.sizes: Dict[str, int] = {}


_ACTIVE = _Active()


@contextlib.contextmanager
def use_rules(rules: Dict[str, Axis], mesh):
    """Install logical→physical rules + mesh (launcher only; one
    installation at a time in a process)."""
    prev = (_ACTIVE.rules, _ACTIVE.mesh, _ACTIVE.sizes)
    _ACTIVE.rules = dict(rules)
    _ACTIVE.mesh = mesh
    _ACTIVE.sizes = axis_sizes(mesh)
    try:
        yield
    finally:
        _ACTIVE.rules, _ACTIVE.mesh, _ACTIVE.sizes = prev


def rules_active() -> bool:
    return _ACTIVE.rules is not None


def _axis_size(axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(_ACTIVE.sizes.get(a, 1) for a in axis)
    return _ACTIVE.sizes.get(axis, 1)


def _resolve_axis(axis: Axis) -> Axis:
    """Drop mesh-absent axes (e.g. 'pod' on a single-pod mesh)."""
    if axis is None:
        return None
    if isinstance(axis, tuple):
        kept = tuple(a for a in axis if a in _ACTIVE.sizes)
        return kept if kept else None
    return axis if axis in _ACTIVE.sizes else None


def divides(n: int, logical: str) -> bool:
    """True when dim size ``n`` splits evenly over the axes mapped to
    ``logical`` under the active rules (False without rules)."""
    if _ACTIVE.rules is None:
        return False
    axis = _resolve_axis(_ACTIVE.rules.get(logical))
    size = _axis_size(axis)
    return size > 1 and n % size == 0 and n >= size


def spec_for(shape, *logical_axes: Optional[str]) -> Tuple[Axis, ...]:
    """The physical spec the active rules give a tensor of ``shape``
    annotated ``logical_axes``: one entry a dim, None where the dim stays
    replicated."""
    if len(logical_axes) != len(shape):
        raise ValueError(f"{len(logical_axes)} axes for rank-{len(shape)} "
                         f"tensor")
    spec = []
    for dim, name in zip(shape, logical_axes):
        axis = _resolve_axis(_ACTIVE.rules.get(name)) if name else None
        n = _axis_size(axis)
        spec.append(None if axis is None or n <= 1 or dim % n or dim < n
                    else axis)
    return tuple(spec)


def act(x, *logical_axes: Optional[str]):
    """Constrain an activation's layout by logical axes: ``x`` itself
    without rules or when it is a plain tensor; a ``DTensor`` is
    redistributed to the rules' placements (unchanged if it has them)."""
    if _ACTIVE.rules is None:
        return x
    spec = spec_for(x.shape, *logical_axes)
    if not is_dtensor(x):
        return x
    want = placements(spec, _ACTIVE.mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(_ACTIVE.mesh, want)


def local(x):
    """A ``DTensor``'s local shard (differentiable), else ``x`` itself: for
    a region each rank computes on its own shard alone."""
    return x.to_local() if is_dtensor(x) else x


def like(y, ref, dims: Optional[Tuple[Optional[int], ...]] = None):
    """``y``, one rank's shard of a tensor of ``ref``'s global shape, as a
    ``DTensor`` laid out as ``ref`` (differentiable); ``y`` itself when
    ``ref`` is a plain tensor. With ``dims``, ``y`` is a shard of another
    shape: its dim ``i`` is laid out as ``ref``'s dim ``dims[i]`` (None:
    whole on every rank), and each dim ``ref`` shards must be one of
    them."""
    if not is_dtensor(ref):
        return y
    if dims is None:
        return _from_local(y, ref.device_mesh, ref.placements, ref.shape)
    from torch.distributed.tensor import Replicate, Shard

    mesh, shape, out = ref.device_mesh, list(y.shape), []
    for m, p in enumerate(ref.placements):
        if isinstance(p, Replicate):
            out.append(p)
            continue
        if not isinstance(p, Shard) or p.dim not in dims:
            raise ValueError(f"{ref.placements} has {p} outside dims {dims}")
        i = dims.index(p.dim)
        shape[i] *= mesh.size(m)
        out.append(Shard(i))
    return _from_local(y, mesh, tuple(out), shape)


def whole(params):
    """A layer's param dict with each ``DTensor`` leaf gathered whole on
    every rank, as its local tensor (other leaves as they are): for a
    product on each rank's own rows."""
    return {k: local(act(v, *(None,) * v.dim())) if is_dtensor(v) else v
            for k, v in params.items()}


def laid_out_as(y, ref):
    """``y`` redistributed to ``ref``'s placements (a ``DTensor`` of the
    same mesh); ``y`` itself when either is a plain tensor."""
    if not (is_dtensor(y) and is_dtensor(ref)) or \
            tuple(y.placements) == tuple(ref.placements):
        return y
    return y.redistribute(ref.device_mesh, ref.placements)


def _from_local(y, mesh, placements, shape):
    """``y`` as the local shard of a contiguous ``DTensor`` of ``shape``."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(y, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (without importing DTensor: none
    exists before its module is)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def shard_offset(x, dim: int) -> int:
    """Where this rank's shard of ``DTensor`` ``x`` starts along ``dim``:
    its index over the mesh dims sharding ``dim`` (row-major, as the
    placements order them) times the local size."""
    from torch.distributed.tensor import Shard

    mesh, coord, index = x.device_mesh, x.device_mesh.get_coordinate(), 0
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            index = index * mesh.size(m) + coord[m]
    return index * x.to_local().shape[dim]


# ---------------------------------------------------------------------------
# Ops whose sharded form DTensor does not give: what GSPMD partitions the
# reference's plain op into. Each is the plain op on plain tensors.
# ---------------------------------------------------------------------------


def _reduced_over(val, x, dim: int, op: str, shape):
    """``val``, this rank's per-row value of ``x`` reduced along ``dim``
    (global ``shape``; ``dim`` kept at 1, or the last dim dropped), reduced
    over the ranks that shard ``x`` along ``dim`` with ``op``: a ``DTensor``
    replicated over those mesh dims, laid out as ``x`` over the others."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, pl = x.device_mesh, x.placements
    rows = [p if isinstance(p, Shard) and p.dim != dim else Replicate()
            for p in pl]
    partial = [Partial(op) if isinstance(p, Shard) and p.dim == dim else p
               for p in pl]
    return _from_local(val, mesh, partial, shape).redistribute(mesh, rows)


def _sharded_along(x, dim: int) -> bool:
    from torch.distributed.tensor import Shard
    return is_dtensor(x) and any(isinstance(p, Shard) and p.dim == dim
                                 for p in x.placements)


def softmax(x, dim: int = -1):
    """``torch.softmax(x, dim)``; along a dim a ``DTensor`` shards (the
    decode cache's context-parallel ``kv_seq``) each rank exponentiates
    its own shard and only per-row values cross ranks — the max over the
    shards and the sum of their exponentials (all-reduces of one value a
    row), where DTensor's own softmax gathers the whole dim on every
    rank."""
    dim = dim % x.dim()
    if not _sharded_along(x, dim):
        return torch.softmax(x, dim=dim)
    shape = tuple(1 if i == dim else n for i, n in enumerate(x.shape))
    local = x.to_local()
    m = _reduced_over(local.detach().amax(dim, keepdim=True), x, dim, "max",
                      shape).to_local()
    e = torch.exp(local - m)
    s = _reduced_over(e.sum(dim, keepdim=True), x, dim, "sum",
                      shape).to_local()
    return like(e / s, x)


def lookup(table, ids):
    """``table[ids]``: the embedding's rows. A ``DTensor`` table whose vocab
    (dim 0) may be sharded, looked up by ``DTensor`` ids, is a
    vocab-parallel embedding: each rank looks up the ids inside its own
    vocab shard (zero rows outside) and the shards sum (DTensor's own
    gather replicates the ids' rows and the table's gradient on every
    rank)."""
    if not (is_dtensor(table) and is_dtensor(ids)):
        return table[ids.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    vocab = {m for m, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0}
    if ids.dim() == 2:          # this rank's rows of the batch, as the rules
        ids = act(ids, "batch", "seq")
    rows = [Replicate() if m in vocab else p
            for m, p in enumerate(ids.placements)]
    local = table.to_local()
    at = ids.redistribute(mesh, rows).to_local().long() - \
        shard_offset(table, 0)
    inside = (at >= 0) & (at < local.shape[0])
    out = local[torch.clamp(at, 0, local.shape[0] - 1)]
    out = torch.where(inside[..., None], out, torch.zeros_like(out))
    return _from_local(out, mesh, [Partial() if m in vocab else p
                                   for m, p in enumerate(rows)],
                       tuple(ids.shape) + (local.shape[1],))


def xent_terms(logits, targets):
    """``(logsumexp(logits, -1), logits[..., targets])`` of fp32 logits
    ``(..., V)``. A ``DTensor`` whose vocab (last) dim may be sharded takes
    the vocab-parallel cross entropy: every logits-sized op runs on this
    rank's shard (its backward too); only per-token values cross ranks —
    the max over the shards, the sum of their exponentials, and the
    target's logit from the one shard that holds it (DTensor's own
    logsumexp and gather, or their gradients' strategies, gather the batch
    or allocate the whole logits on every rank)."""
    if not is_dtensor(logits):
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        return lse, gold
    from torch.distributed.tensor import Replicate, Shard

    vdim = logits.dim() - 1
    mesh = logits.device_mesh
    rows = [p if isinstance(p, Shard) and p.dim != vdim else Replicate()
            for p in logits.placements]
    shape = tuple(logits.shape[:-1])
    local = logits.to_local()
    m = _reduced_over(local.detach().amax(-1), logits, vdim, "max",
                      shape).to_local()
    lse = _reduced_over(torch.exp(local - m[..., None]).sum(-1), logits,
                        vdim, "sum", shape)
    lse = torch.log(lse) + _from_local(m, mesh, rows, shape)
    if not is_dtensor(targets):
        targets = _from_local(targets, mesh, [Replicate()] * mesh.ndim,
                              targets.shape)
    at = (targets.redistribute(mesh, rows).to_local().long()
          - shard_offset(logits, vdim))
    v = local.shape[-1]
    inside = (at >= 0) & (at < v)
    g = torch.gather(local, -1, torch.clamp(at, 0, v - 1)[..., None])[..., 0]
    return lse, _reduced_over(torch.where(inside, g, torch.zeros_like(g)),
                              logits, vdim, "sum", shape)


def write_rows(dst, pos, new) -> None:
    """``dst[b, pos[b]] = new[b]`` for every row ``b``, in place: a decode
    step's K or V ``new`` ``(B, ...)`` into a capacity-dense cache leaf
    ``dst`` ``(B, capacity, ...)``. Into a ``DTensor`` leaf sharded by
    batch (dim 0) and context (dim 1) each rank writes the rows of its own
    batch shard whose position falls inside its own capacity shard, in its
    local shard (the context-parallel write the reference's
    ``dynamic_update_slice`` becomes under GSPMD)."""
    if not is_dtensor(dst):
        rows = torch.arange(new.shape[0], device=new.device)
        dst.index_put_((rows, pos.to(new.device).long()),
                       new.to(dst.dtype))
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = dst.device_mesh
    batch_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in dst.placements]

    def rows_of(t):          # this rank's batch rows of a (B, ...) tensor
        return t.redistribute(mesh, batch_pl).to_local() if is_dtensor(t) \
            else t

    local = dst.to_local()
    cap = local.shape[1]
    at = rows_of(pos).long() - shard_offset(dst, 1)
    inside = (at >= 0) & (at < cap)
    at = torch.clamp(at, 0, cap - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    new = rows_of(new).to(local.dtype)
    inside = inside.reshape((-1,) + (1,) * (new.dim() - 1))
    local.index_put_((rows, at), torch.where(inside, new, local[rows, at]))
