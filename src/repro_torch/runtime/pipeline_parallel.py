"""Pipeline parallelism (the reference's ``runtime/pipeline_parallel.py``,
a GPipe schedule) over ``torch.distributed`` ranks.

Completes the parallelism menu (DP/TP/EP/SP in ``sharding.py``; PP here).
Each rank of ``group`` is one stage and holds only its stage's params (a
disjoint layer group, :func:`split_stages`); microbatches stream through:
wall-clock steps = n_micro + n_stages − 1 (the GPipe bubble), and
activations cross stages once a step, neighbour to neighbour (``isend`` /
``irecv``, the reference's ``ppermute``). The last stage's outputs then
reach every rank (a broadcast from it: the reference's masked ``psum``).

A stage computes only the steps it has a microbatch for (the reference's
scan computes every step and masks the idle ones: the same outputs). It
runs on NCCL (one card a rank) and on gloo, whose point-to-point ops take
host memory only: over gloo, a tensor on a card goes through the host.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

PyTree = Any


def split_stages(stacked_params: PyTree, n_stages: int) -> PyTree:
    """(L, ...) layer-stacked params → (n_stages, L/n_stages, ...); a list
    of L layers (the port's unstacked layout) → ``n_stages`` lists of
    L/n_stages consecutive layers."""
    if isinstance(stacked_params, list):
        n = len(stacked_params)
        assert n % n_stages == 0, (n, n_stages)
        per = n // n_stages
        return [stacked_params[i * per:(i + 1) * per]
                for i in range(n_stages)]
    from repro_torch.tree import tree_map

    def r(x):
        l = x.shape[0]
        assert l % n_stages == 0, (l, n_stages)
        return x.reshape((n_stages, l // n_stages) + tuple(x.shape[1:]))
    return tree_map(r, stacked_params)


def _through_host(group) -> bool:
    return dist.get_backend(group) == "gloo"


def pipeline_apply(
    stage_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
    stage_params: PyTree,
    x: torch.Tensor,
    *,
    group: Optional[Any] = None,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """GPipe forward.

    stage_fn(this rank's stage params, microbatch) -> microbatch (same
    shape). ``x``: (n_micro, mb, ...) microbatched input, the same on every
    rank (stage 0 reads it). Returns (n_micro, mb, ...) outputs on every
    rank. Stage ``i`` is rank ``i`` of ``group`` (the default group when
    None). ``stats`` (a dict), when given, receives ``steps``, the
    ``launched`` steps of this stage and the ``bytes_sent`` to the next
    stage."""
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    n_micro = x.shape[0]
    total = n_micro + n_stages - 1
    host = _through_host(group)

    def peer(i):
        return dist.get_global_rank(group, i) if group is not None else i

    def wire(t):                       # what crosses the link
        return t.cpu() if host and t.is_cuda else t

    outs = torch.zeros_like(x)
    inp = torch.empty_like(x[0])
    recv_buf = wire(torch.empty_like(x[0]))
    launched, sent = 0, 0
    for t in range(total):
        mb = t - stage
        y = None
        if 0 <= mb < n_micro:
            y = stage_fn(stage_params, x[mb] if stage == 0 else inp)
            launched += 1
            if stage == n_stages - 1:
                outs[mb] = y
        # hand activations to the next stage: stage s sends microbatch mb
        # at step t; stage s+1 consumes it at step t+1
        reqs: List[Any] = []
        if stage > 0 and 0 <= t - (stage - 1) < n_micro:
            reqs.append(dist.irecv(recv_buf, src=peer(stage - 1),
                                   group=group))
        if y is not None and stage < n_stages - 1:
            payload = wire(y.contiguous())
            reqs.append(dist.isend(payload, dst=peer(stage + 1),
                                   group=group))
            sent += payload.numel() * payload.element_size()
        for r in reqs:
            r.wait()
        if stage > 0 and 0 <= t - (stage - 1) < n_micro:
            inp = recv_buf.to(x.device, copy=True)
    # the last stage's outputs to every rank (the reference's psum)
    if n_stages > 1:
        buf = wire(outs)
        dist.broadcast(buf, src=peer(n_stages - 1), group=group)
        if buf is not outs:
            outs.copy_(buf)
    if stats is not None:
        stats.update(steps=total, launched=launched, bytes_sent=sent)
    return outs


def pipeline_bubble_fraction(n_micro: int, n_stages: int) -> float:
    """GPipe efficiency model: bubble = (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
