"""Per-rank cost accounting for the dry-run roofline (the reference's
``runtime/hlo_analysis.py``).

torch has no HLO: this module counts the aten ops a call dispatches, as
they run, under a ``TorchDispatchMode`` (:class:`CostMode`). Python loops
over layers, microbatches and attention chunks are counted as they run, so
nothing needs the reference's ``while``-body trip-count correction.

The count is per rank, over local shapes, as the reference counts the
per-device program: the mode declines ``DTensor`` ops, so the DTensor
dispatcher runs them as local ops on each shard, and those (with the
``_c10d_functional`` collectives its redistributions issue) are what the
mode counts. The global-shape ops DTensor's sharding propagation runs to
infer output metadata are not counted (:func:`skip_sharding_propagation`).

Rules, op class by op class, as the reference counts them:

* matmul and convolution: ``torch.utils.flop_counter``'s formulas (2·M·N·K
  for a product); bytes are inputs plus outputs;
* pointwise arithmetic (the ``pointwise`` tag, less copies, casts,
  compares and selects; the reference's ``_ELEMENTWISE``): one FLOP per
  output element; reductions (the ``reduction`` tag): one per input
  element; a fused op that XLA lowers to several (softmax, log-softmax,
  logsumexp and their gradients: ``_COMPOSITE``) counts its parts by those
  rules — a softmax's max, subtract, exp, sum and divide are 5 per input
  element, as the reference's program holds them;
* bytes: each op's inputs plus outputs. Eager torch does not fuse, so this
  is what eager torch moves (the reference's fusion bytes are what XLA's
  fused program moves: fewer). A gather (``index``, ``embedding``) reads
  its output's worth of rows; an in-place update (``copy_``,
  ``index_put_``) moves twice its source, not the whole destination; empty
  allocations move nothing;
* views and metadata (``prim`` ops): zero;
* collectives: the operand bytes of each ``_c10d_functional`` (and
  ``c10d``) all-gather, reduce-scatter, all-reduce (twice: a ring moves
  ≈2× the buffer), all-to-all, broadcast and send (a ``recv`` is its
  sender's), by op under the reference's names.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry, shape_wrapper

_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
    "send": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d",
                  "_dtensor")
_REDUCTIONS = {"cumsum", "topk", "sort", "argmax", "argmin"}
# FLOPs an input element of an op that XLA runs as several, by the rules
# above: softmax = max, subtract, exp, sum, divide; log-softmax = max,
# subtract, exp, sum, subtract; logsumexp = max, subtract, exp, sum; the
# softmax gradient = multiply, sum, subtract, multiply; log-softmax's =
# exp, multiply, sum, subtract
_COMPOSITE = {"_softmax": 5, "_log_softmax": 5, "logsumexp": 4,
              "_softmax_backward_data": 4, "_log_softmax_backward_data": 4}
_GATHERS = {"index", "embedding", "gather", "index_select", "take"}
_EMPTY = {"empty", "empty_strided", "empty_like", "new_empty",
          "new_empty_strided"}
_FREE = {"_local_scalar_dense", "wait_tensor", "detach", "lift_fresh",
         "set_", "_unsafe_view"}
# pointwise ops that move data without arithmetic (the reference's HLO
# counts no FLOP for a copy, convert, compare or select either)
_NO_FLOPS = {"clone", "_to_copy", "copy", "copy_", "fill", "fill_", "zero_",
             "eq", "ne", "lt", "le", "gt", "ge", "where", "masked_fill",
             "masked_fill_", "logical_and", "logical_or", "logical_not",
             "bitwise_and", "bitwise_or", "bitwise_not", "isnan", "isinf",
             "isfinite"}


def bmm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """2·B·M·N·K of ``aten.bmm``, its ``out_dtype`` overload too (whose
    dtype argument the registry's formula takes for its output shape)."""
    b, m, k = a_shape
    return 2 * b * m * b_shape[2] * k


# torch.utils.flop_counter's formulas, with the bmm fix: also the
# FlopCounterMode mapping of the dry run's raw global count
FLOP_FORMULAS = {**flop_registry,
                 torch.ops.aten.bmm: shape_wrapper(bmm_flop)}


class _Propagation(threading.local):
    depth = 0


_PROP = _Propagation()
_PATCH = {"count": 0, "orig": None}


def propagating() -> bool:
    """Whether DTensor's sharding propagation is running an op for its
    output metadata (those ops are not the program's)."""
    return _PROP.depth > 0


def _targets():
    """(owner, attribute, real) of DTensor's metadata helpers: the
    propagator's output-metadata run, and a strided shard's index
    arithmetic, which runs ``arange`` and ``item()`` on the host and so must
    run on real tensors under a ``FakeTensorMode``."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    return ((ShardingPropagator, "_propagate_tensor_meta_non_cached", False),
            (_StridedShard, "local_shard_size_and_offset", True))


@contextlib.contextmanager
def skip_sharding_propagation():
    """Mark the ops DTensor's sharding propagation runs on global-shape
    stand-ins to infer an output's metadata, and its host-side shard
    arithmetic (:func:`propagating`), while the context is open
    (re-entrant)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    if _PATCH["count"] == 0:
        _PATCH["orig"] = []
        for owner, name, real in _targets():
            orig = getattr(owner, name)

            def marked(*args, _orig=orig, _real=real, **kwargs):
                _PROP.depth += 1
                try:
                    if _real:
                        with unset_fake_temporarily():
                            return _orig(*args, **kwargs)
                    return _orig(*args, **kwargs)
                finally:
                    _PROP.depth -= 1

            _PATCH["orig"].append((owner, name, orig))
            setattr(owner, name, marked)
    _PATCH["count"] += 1
    try:
        yield
    finally:
        _PATCH["count"] -= 1
        if _PATCH["count"] == 0:
            for owner, name, orig in _PATCH["orig"]:
                setattr(owner, name, orig)


def is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _mutates_first(func) -> bool:
    args = func._schema.arguments
    return bool(args) and args[0].alias_info is not None \
        and args[0].alias_info.is_write


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes and collective bytes of the local ops it sees
    (module docstring); :meth:`report` gives the reference's keys."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.collective_bytes = 0.0
        self.collective_count = 0
        self.collective_by_op: Dict[str, float] = {}
        self._skip = None

    def __enter__(self):
        self._skip = skip_sharding_propagation()
        self._skip.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._skip.__exit__(*exc)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(is_dtensor_type(t) for t in types):
            return NotImplemented    # the DTensor dispatcher runs local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not propagating():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns, name = func.namespace, func._opname
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if ns in _COLLECTIVE_NS and name in _COLLECTIVES:
            operand = sum(nbytes(t) for t in ins[:1])
            wire = 2.0 if _COLLECTIVES[name] == "all-reduce" else 1.0
            op = _COLLECTIVES[name]
            self.collective_bytes += wire * operand
            self.collective_count += 1
            self.collective_by_op[op] = (self.collective_by_op.get(op, 0.0)
                                         + wire * operand)
            self.bytes_accessed += operand + sum(nbytes(t) for t in outs)
            return
        if (ns == "prim" or name in _FREE or name in _EMPTY
                or _is_view(func)):
            return
        packet = func._overloadpacket
        if packet in FLOP_FORMULAS:
            self.flops += float(FLOP_FORMULAS[packet](*args, **kwargs,
                                                      out_val=out))
        elif name in _COMPOSITE:
            self.flops += float(_COMPOSITE[name] * ins[0].numel())
        elif torch.Tag.pointwise in func.tags and name not in _NO_FLOPS:
            self.flops += float(sum(t.numel() for t in outs[:1]))
        elif torch.Tag.reduction in func.tags or name in _REDUCTIONS:
            self.flops += float(sum(t.numel() for t in ins[:1]))
        out_b = sum(nbytes(t) for t in outs)
        if name in _GATHERS:
            idx = sum(nbytes(t) for t in ins
                      if not t.dtype.is_floating_point)
            self.bytes_accessed += 2 * out_b + idx
        elif (_mutates_first(func) and ins
              and torch.Tag.pointwise not in func.tags):
            self.bytes_accessed += 2 * sum(nbytes(t) for t in ins[1:])
        elif not ins:
            self.bytes_accessed += out_b      # a filled factory: one write
        else:
            self.bytes_accessed += sum(nbytes(t) for t in ins) + out_b

    def report(self) -> Dict[str, float]:
        out = {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "collective_count": float(self.collective_count),
        }
        for k, v in self.collective_by_op.items():
            out[f"collective_bytes:{k}"] = v
        return out


def analyze(fn, *args: Any, **kwargs: Any) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` once under :class:`CostMode` and return
    its per-rank counts: ``flops``, ``bytes_accessed``,
    ``collective_bytes``, ``collective_count`` and
    ``collective_bytes:<op>``."""
    mode = CostMode()
    with mode:
        fn(*args, **kwargs)
    return mode.report()
