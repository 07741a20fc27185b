"""Nested parameter and state trees: dicts, lists and dataclasses whose
leaves are tensors (or numpy arrays, or None).

The reference walks its pytrees with ``jax.tree_util``; the port walks the
same nesting with these helpers. A leaf's path is written the way
``jax.tree_util.keystr`` writes dict keys and list indices (``['layers'][0]
['mixer']['wq']['w']``), with ``.field`` for a dataclass field, so the
port's prune filters and ADMM specs key on strings like the reference's.
``None`` is a leaf here (the reference keeps it as one in its ADMM trees).
A dataclass field marked ``metadata={"static": True}`` (a plan's tuned
dispatch genome) is not part of the tree, as the reference keeps such
values as a pytree's static aux data.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Tuple


def _is_node(tree: Any) -> bool:
    return (isinstance(tree, (dict, list, tuple))
            or (dataclasses.is_dataclass(tree) and not isinstance(tree, type)))


def _fields(tree: Any) -> List[dataclasses.Field]:
    """A dataclass node's child fields (static ones are not children)."""
    return [f for f in dataclasses.fields(tree)
            if not f.metadata.get("static")]


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) for every leaf, in nesting order; ``None`` included."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in flatten(v, f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten(v, f"{prefix}[{i}]")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for f in _fields(tree)
                for kv in flatten(getattr(tree, f.name),
                                  f"{prefix}.{f.name}")]
    return [(prefix, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def _rebuild(like: Any, it: Iterator[Any]) -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(v, it) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), it)
            for f in _fields(like) if f.init})
    return next(it)


def unflatten(like: Any, new_leaves: List[Any]) -> Any:
    """A tree with ``like``'s nesting and ``new_leaves`` in flatten order."""
    it = iter(new_leaves)
    out = _rebuild(like, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *other_leaves)`` over trees of one nesting."""
    others = [leaves(r) for r in rest]
    mine = leaves(tree)
    for o in others:
        if len(o) != len(mine):
            raise ValueError("trees do not have the same nesting")
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(mine)])
