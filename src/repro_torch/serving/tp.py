"""Tensor-parallel serving: the engine's params and KV pool sharded over a
group of ranks, one process a rank (the reference's ``serving/tp.py``).

The contract that drives every layout choice is the reference's:
**bit-exact equivalence with one device** — greedy tokens equal token for
token, so no collective may change an fp32 summation order.

* **Every projection is column-parallel** (output dim sharded, input
  replicated): each rank computes whole-``K`` dot products for its slice
  of output rows, the single-device arithmetic, and the activation is
  re-replicated by an all-gather (pure data movement,
  ``runtime/collectives.tp_all_gather``).
* **Packed BCR weights shard along their output row blocks**
  (``kernels/plan.split_packed`` / ``split_grouped``): each rank holds a
  self-contained sub-pack in its local index space and runs the unmodified
  kernels on it. A shard keeps the whole weight's launch decisions (its
  tuned genome, and the split the whole's tile count gives), so on the
  card it sums the same partials in the same order.
* **Attention is head-parallel**: Q/K/V shards are whole head groups, and
  the paged KV pool (and its int8 scale pools) is split along ``Hkv``;
  the paged kernel plans for the whole pool's heads
  (``paged_plan(head_shards=...)``). Block tables stay on rank 0's host,
  so every page-pool invariant holds per shard by construction.
* Weights whose output does not divide the group **fall back to
  replicated** and the layers' shape-driven ``maybe_gather`` then does
  nothing. Attention projections are the exception: their shards must be
  the heads the pool holds, so an unshardable one is a build-time error.

One process a rank, PyTorch's own idiom, in place of the reference's
single-controller ``jit(shard_map)``. Rank 0 runs the engine's host logic
(scheduler, pool bookkeeping, admission, sampling, HTTP) and broadcasts
every device-touching operation with its host-side arguments — the model
calls (``prefill``, ``decode_step``, ``prefill_append``, ``init_cache``:
:func:`sharded_fns`) and the pool's device writes (seating a prefill cache,
copy-on-write: :class:`ShardedPagedSlotPool`) — to the other ranks, each
of which runs it on its own shard (:func:`_worker_main`). The logits are
replicated after the ``lm_head`` gather, so sampling runs on rank 0 alone,
and no rank's clock or thread can make the ranks diverge. A speculative
drafter runs on rank 0 alone, unsharded, as the reference's drafter runs
outside its mesh.

The group (:func:`make_model_group`) is explicit about its devices: one
card a rank by default (raising when fewer are visible), or a list such as
``["cuda:0", "cuda:0"]`` (ranks sharing a card) or ``["cpu"] * 4``. NCCL
carries the gathers when every rank has a card of its own, gloo otherwise;
operations travel to the ranks over ``multiprocessing`` queues and the
weights over a gloo group. Every collective has a timeout, so a dead rank
fails rank 0 instead of hanging it.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import pickle
import queue
import tempfile
import traceback
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bcrc import TBCRC
from repro_torch.kernels.plan import (GroupedTBCRC, _member,
                                      split_grouped_shard,
                                      split_packed_shard, splittable_packed)
from repro_torch.models.api import ModelFns, model_fns
from repro_torch.runtime.collectives import register_group, unregister_group
from repro_torch.serving.kv_slots import (PagedSlotPool, _leaf_keys,
                                          copy_pages_into, seat_pages)
from repro_torch.tree import flatten, unflatten

PyTree = Any

AXIS = "model"

# attention projections MUST shard (their slices are the head groups the
# per-rank KV pool holds); anything else may fall back to replicated
_ATTN_PROJ_KEYS = ("wq", "wk", "wv", "wqkv", "wkv")

# the only dicts whose DENSE ``w`` may shard: linears. Anything else with a
# 2-D "w" (an embedding table, indexed by token id) stays replicated.
_LINEAR_KEYS = _ATTN_PROJ_KEYS + ("wo", "wg", "wi", "wgi", "lm_head")


# ---------------------------------------------------------------------------
# Gating, config localization, accounting
# ---------------------------------------------------------------------------


def shardable(cfg: ModelConfig, tp: int, page_size: int) -> Optional[str]:
    """None if the sharded engine serves this config at mesh ``tp``, else
    the reason it cannot (the reference's words)."""
    if tp <= 1:
        return None
    if page_size <= 0:
        return "sharded serving needs a paged KV pool (--page-size > 0)"
    if cfg.family not in ("dense", "vlm"):
        return (f"family {cfg.family!r} not supported by the sharded "
                f"engine (pure-attention dense/vlm only)")
    if cfg.num_experts:
        return "MoE FFNs are not supported by the sharded engine"
    if cfg.attn_period:
        return "hybrid attn/mamba stacks are not supported sharded"
    if cfg.num_heads % tp:
        return f"num_heads={cfg.num_heads} not divisible by mesh {tp}"
    if cfg.num_kv_heads % tp:
        return f"num_kv_heads={cfg.num_kv_heads} not divisible by mesh {tp}"
    return None


def localize_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The config each rank's model sees: its own head counts, and
    ``tp_axis`` set so the layers re-replicate after each projection.
    ``d_model``/``d_ff``/``vocab_size`` stay whole: the layers take working
    widths from the (sharded) weights."""
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp, tp_axis=AXIS)


def per_device_kv_bytes(total_bytes: int, tp: int) -> int:
    """Aggregate KV traffic → one rank's: every page leaf splits along its
    head axis and nothing is replicated, so each rank moves ``1/tp`` of
    the bytes (the engine reports both, ``kv_bytes_read`` and
    ``kv_bytes_read_device``)."""
    return total_bytes // max(tp, 1)


# ---------------------------------------------------------------------------
# Params: each rank's local tree (the reference's prepare_params + placed)
# ---------------------------------------------------------------------------


def _rows(t: torch.Tensor, tp: int, rank: int, ax: int) -> torch.Tensor:
    n = t.shape[ax] // tp
    return t.narrow(ax % t.dim(), rank * n, n).contiguous()


def shard_params(params: PyTree, tp: int, rank: int) -> PyTree:
    """Rank ``rank``'s local tree of a (packed, fused, quantized or dense)
    params tree at mesh ``tp``: what the reference's ``prepare_params``
    global arrays cut by their ``PartitionSpec`` give that device.

    Packed and fused linears split by the plan splitters when their row
    blocks divide the mesh, dense linears by output rows when ``N``
    divides it, biases with them; any other linear stays replicated, but
    an attention projection that cannot shard raises. Every other leaf
    (the embedding, norms) is replicated: the same tensor object."""
    def walk(node: Any, key: Optional[str] = None):
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        if not isinstance(node, dict):
            return node
        out, reason = dict(node), None
        if isinstance(node.get("w_packed"), TBCRC):
            reason = splittable_packed(node["w_packed"], tp)
            if reason is None:
                out["w_packed"] = split_packed_shard(node["w_packed"], tp,
                                                     rank)
        elif isinstance(node.get("w_group"), GroupedTBCRC):
            reason = splittable_packed(_member(node["w_group"], 0), tp)
            if reason is None:
                out["w_group"] = split_grouped_shard(node["w_group"], tp,
                                                     rank)
        elif key in _LINEAR_KEYS and isinstance(node.get("w"), torch.Tensor):
            n = node["w"].shape[-2]
            if n % tp:
                reason = f"output dim {n} not divisible by mesh {tp}"
            else:
                out["w"] = _rows(node["w"], tp, rank, -2)
        else:
            return {k: walk(v, k) for k, v in node.items()}
        if reason is not None:
            if key in _ATTN_PROJ_KEYS:
                raise ValueError(
                    f"attention projection {key!r} cannot shard over mesh "
                    f"{tp}: {reason} (pick a bcr_block whose row blocks "
                    f"divide the mesh, or serve dense)")
            return out                    # replicated fallback
        if "b" in node:
            out["b"] = _rows(node["b"], tp, rank, -1)
        return out

    return walk(params)


# ---------------------------------------------------------------------------
# Cache axes: which axis of each pool leaf is Hkv, found by probing
# init_cache at two num_kv_heads values (the reference's probe)
# ---------------------------------------------------------------------------


def cache_axes(cfg: ModelConfig, batch: int, capacity: int, *,
               kv_pages: int = 0, page_size: int = 0) -> List[Dict[str, int]]:
    """Per layer, per leaf, the index of the ``Hkv`` axis (−1: a replicated
    leaf), probed on the ``meta`` device."""
    def shapes(c):
        return model_fns(c).init_cache(batch=batch, capacity=capacity,
                                       kv_pages=kv_pages,
                                       page_size=page_size, device="meta")

    a = shapes(cfg)
    b = shapes(dataclasses.replace(cfg, num_kv_heads=cfg.num_kv_heads * 2))

    def ax(la, lb):
        diffs = [i for i, (x, y) in enumerate(zip(la.shape, lb.shape))
                 if x != y]
        if len(diffs) > 1:
            raise AssertionError((la.shape, lb.shape))
        return diffs[0] if diffs else -1

    return [{k: ax(la[k], lb[k]) for k in la} for la, lb in zip(a, b)]


def cache_specs(cfg: ModelConfig, batch: int, capacity: int, *,
                kv_pages: int = 0, page_size: int = 0
                ) -> List[Dict[str, Optional[int]]]:
    """Per leaf, the axis split over the mesh (``None``: replicated), the
    port's form of the reference's ``PartitionSpec`` tree: KV codes and
    their int8 scale siblings split along ``Hkv`` (the scale leaf's own
    axis diffs in the same probe), everything else replicated. The same
    axes serve the persistent pool and a prefill's output cache."""
    return [{k: (None if a < 0 else a) for k, a in layer.items()}
            for layer in cache_axes(cfg, batch, capacity, kv_pages=kv_pages,
                                    page_size=page_size)]


# ---------------------------------------------------------------------------
# Moving trees between ranks
# ---------------------------------------------------------------------------


class _Slot:
    """Where a tensor leaf sat in a tree sent between ranks (a leaf of the
    tree helpers: not a dataclass, whose fields they would walk)."""

    def __init__(self, index: int):
        self.index = index


def _send_tree(tree: PyTree, dst: int, group) -> None:
    """Send ``tree`` to rank ``dst``: its skeleton (every tensor leaf a
    :class:`_Slot`) pickled, then each tensor's bytes from the CPU."""
    tensors = [leaf for _, leaf in flatten(tree)
               if isinstance(leaf, torch.Tensor)]
    it = iter(range(len(tensors)))
    skeleton = unflatten(tree, [_Slot(next(it))
                                if isinstance(leaf, torch.Tensor) else leaf
                                for _, leaf in flatten(tree)])
    meta = [(t.dtype, tuple(t.shape)) for t in tensors]
    payload = pickle.dumps((skeleton, meta))
    dist.send(torch.tensor([len(payload)], dtype=torch.int64), dst,
              group=group)
    dist.send(torch.frombuffer(bytearray(payload), dtype=torch.uint8), dst,
              group=group)
    for t in tensors:
        if t.numel():
            dist.send(t.detach().to("cpu").contiguous().reshape(-1)
                      .view(torch.uint8), dst, group=group)


def _recv_tree(src: int, group, device: torch.device) -> PyTree:
    """Receive a tree :func:`_send_tree` sent, its tensors on ``device``."""
    n = torch.zeros(1, dtype=torch.int64)
    dist.recv(n, src, group=group)
    buf = torch.empty(int(n), dtype=torch.uint8)
    dist.recv(buf, src, group=group)
    skeleton, meta = pickle.loads(buf.numpy().tobytes())
    tensors = []
    for dtype, shape in meta:
        t = torch.empty(shape, dtype=dtype)
        if t.numel():
            dist.recv(t.reshape(-1).view(torch.uint8), src, group=group)
        tensors.append(t.to(device))
    return unflatten(skeleton, [tensors[leaf.index]
                                if isinstance(leaf, _Slot) else leaf
                                for _, leaf in flatten(skeleton)])


def _host(batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def _device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return {k: (torch.as_tensor(v, device=device)
                if isinstance(v, np.ndarray) else v)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The group: rank 0's handle and the other ranks' loop
# ---------------------------------------------------------------------------


class ModelGroup:
    """Rank 0's handle on a tensor-parallel group (the counterpart of the
    reference's ``make_model_mesh``): the worker processes of ranks
    ``1 .. tp-1``, their operation queues, and the process group. Made by
    :func:`make_model_group`; :meth:`close` stops the workers and tears the
    process group down. Engines built on it in turn (``InferenceEngine(...,
    group=...)``) reuse its ranks."""

    def __init__(self, tp: int, devices: List[torch.device], backend: str,
                 procs: List[Any], ops: List[Any], errors: Any, replies: Any,
                 cpu_group, timeout_s: float):
        self.tp = tp
        self.devices = devices
        self.backend = backend
        self._procs = procs
        self._ops = ops
        self._errors = errors
        self._replies = replies
        self.cpu_group = cpu_group
        self.timeout_s = timeout_s
        self.closed = False

    def __enter__(self) -> "ModelGroup":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _check(self) -> None:
        if self.closed:
            raise RuntimeError("the model group is closed")
        try:
            err = self._errors.get_nowait()
        except queue.Empty:
            err = None
        if err is not None:
            raise RuntimeError(f"a tensor-parallel rank failed:\n{err}")
        dead = [r + 1 for r, p in enumerate(self._procs) if not p.is_alive()]
        if dead:
            raise RuntimeError(f"tensor-parallel ranks {dead} exited")

    def send(self, op: str, *args: Any) -> None:
        """Have every other rank run ``op`` on its shard (rank 0 runs its
        own part after this returns)."""
        self._check()
        for q in self._ops:
            q.put((op,) + args)

    def query(self, op: str, *args: Any) -> List[Any]:
        """Have every other rank run ``op`` and return their replies, in
        rank order (ranks ``1 .. tp-1``)."""
        self.send(op, *args)
        return self._replies_to(op)

    def call(self, fn: Any, *args: Any) -> List[Any]:
        """``fn(*args)`` on every rank, this one too (``fn`` importable by
        name in a fresh process, as everything sent to a rank is pickled);
        its results in rank order. Collectives inside ``fn`` run over the
        group's ranks."""
        self.send("call", fn, args)
        mine = fn(*args)
        return [mine] + self._replies_to("call")

    def _replies_to(self, op: str) -> List[Any]:
        got = {}
        for _ in range(self.tp - 1):
            try:
                rank, reply = self._replies.get(timeout=self.timeout_s)
            except queue.Empty:
                self._check()
                raise RuntimeError(f"no reply to {op!r} within "
                                   f"{self.timeout_s} s") from None
            got[rank] = reply
        return [got[r] for r in range(1, self.tp)]

    def load(self, params: PyTree, cfg_local: ModelConfig) -> PyTree:
        """Hand ranks ``1 .. tp-1`` their shard of ``params``
        (:func:`shard_params`, one rank at a time) and their config; return
        rank 0's own shard."""
        self._check()
        for r in range(1, self.tp):
            self._ops[r - 1].put(("load", cfg_local))
            _send_tree(shard_params(params, self.tp, r), r, self.cpu_group)
        return shard_params(params, self.tp, 0)

    def close(self, timeout: float = 30.0) -> None:
        if self.closed:
            return
        self.closed = True
        for q in self._ops:
            q.put(("stop",))
        for p in self._procs:
            p.join(timeout)
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        unregister_group(AXIS)
        if dist.is_initialized():
            dist.destroy_process_group()


def _normalize(devices: Sequence[Any]) -> List[torch.device]:
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out


def make_model_group(tp: int, devices: Optional[Sequence[Any]] = None, *,
                     timeout_s: float = 600.0,
                     init_method: Optional[str] = None) -> ModelGroup:
    """Start ranks ``1 .. tp-1`` and join them with this process as rank 0.

    ``devices`` (one a rank, rank 0's first) defaults to one card a rank,
    ``cuda:0 .. cuda:tp-1``, and raises when fewer cards are visible, as
    the reference raises with fewer devices. Ranks may share a card
    (``["cuda:0"] * tp``) or run on the CPU (``["cpu"] * tp``): the
    counterpart of the reference's forced host device count. The backend
    follows: NCCL when every rank has a card of its own, gloo otherwise.
    The kernels are built here, before any rank starts. ``init_method``
    defaults to a fresh file under the temporary directory; collectives
    time out after ``timeout_s``."""
    if tp < 2:
        raise ValueError(f"a model group needs at least 2 ranks, got {tp}")
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < tp:
            raise ValueError(
                f"mesh_model={tp} but only {n} CUDA devices visible (ranks "
                f"sharing a card or on the CPU take a device list, e.g. "
                f"['cuda:0'] * {tp} or ['cpu'] * {tp})")
        devices = [f"cuda:{i}" for i in range(tp)]
    devices = _normalize(devices)
    if len(devices) != tp:
        raise ValueError(f"{len(devices)} devices for {tp} ranks")
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"ranks must all be on cards or all on the CPU: "
                         f"{devices}")
    backend = ("nccl" if kinds == {"cuda"}
               and len({d.index for d in devices}) == tp else "gloo")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this "
                           "process: close the other model group first")
    if kinds == {"cuda"}:
        from repro_torch.kernels import build
        build.build_all(["bcr_spmm", "flash_attention", "paged_attention"])
    if init_method is None:
        init_method = ("file://" + tempfile.mkdtemp(prefix="repro_tp_")
                       + "/rendezvous")
    ctx = mp.get_context("spawn")
    errors, replies = ctx.Queue(), ctx.Queue()
    ops = [ctx.Queue() for _ in range(tp - 1)]
    names = [str(d) for d in devices]
    threads = torch.get_num_threads()
    procs = [ctx.Process(target=_worker_main, daemon=True,
                         name=f"tp-rank-{r}",
                         args=(r, tp, names, backend, init_method, timeout_s,
                               threads, ops[r - 1], errors, replies))
             for r in range(1, tp)]
    for p in procs:
        p.start()
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=tp, rank=0,
            timeout=datetime.timedelta(seconds=timeout_s))
        cpu_group = (dist.new_group(backend="gloo") if backend == "nccl"
                     else dist.group.WORLD)
        register_group(AXIS, dist.group.WORLD)
    except BaseException:
        for p in procs:
            p.terminate()
        if dist.is_initialized():
            dist.destroy_process_group()
        raise
    return ModelGroup(tp, devices, backend, procs, ops, errors, replies,
                      cpu_group, timeout_s)


class _Worker:
    """One rank's shard: its config, params, pool and last prefill cache,
    and the operations rank 0 broadcasts."""

    def __init__(self, rank: int, device: torch.device, cpu_group, replies):
        self.rank = rank
        self.device = device
        self.cpu_group = cpu_group
        self.replies = replies
        self._unload()

    def _unload(self) -> None:
        self.fns: Optional[ModelFns] = None
        self.params = self.cache = self.pcache = None

    def run(self, op: str, *args: Any) -> None:
        getattr(self, "op_" + op)(*args)

    def op_load(self, cfg: ModelConfig) -> None:
        self._unload()
        self.fns = model_fns(cfg)
        self.params = _recv_tree(0, self.cpu_group, self.device)

    def op_unload(self) -> None:
        self._unload()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def op_init_cache(self, args: tuple, kwargs: Dict[str, Any]) -> None:
        self.cache = self.fns.init_cache(*args, **kwargs,
                                         device=self.device)

    def op_prefill(self, batch: Dict[str, Any]) -> None:
        _, self.pcache = self.fns.prefill(self.params,
                                          _device(batch, self.device))

    def op_decode(self, batch: Dict[str, Any]) -> None:
        self.fns.decode_step(self.params, _device(batch, self.device),
                             self.cache)

    def op_append(self, batch: Dict[str, Any]) -> None:
        self.fns.prefill_append(self.params, _device(batch, self.device),
                                self.cache)

    def op_seat(self, dest: np.ndarray, slots: np.ndarray) -> None:
        pos, slot = _leaf_keys(self.cache)
        seat_pages(self.cache, self.pcache, pos, slot, dest, slots)

    def op_copy(self, src: np.ndarray, dst: np.ndarray) -> None:
        copy_pages_into(self.cache, _leaf_keys(self.cache)[0], src, dst)

    def op_report(self) -> None:
        self.replies.put((self.rank, rank_report(self.params, self.cache)))

    def op_call(self, fn: Any, args: tuple) -> None:
        self.replies.put((self.rank, fn(*args)))

    def op_zero_counters(self) -> None:
        for counter in kernel_counters():
            for key in counter:
                counter[key] = 0
        self.replies.put((self.rank, None))


def kernel_counters() -> List[Dict[str, int]]:
    """Every kernel wrapper's launch counters (``LAUNCHES``) in this
    process."""
    import importlib
    return [importlib.import_module(f"repro_torch.kernels.{m}").LAUNCHES
            for m in ("bcr_spmm", "paged_decode_attention",
                      "flash_attention", "bcr_spmm_skip")]


def tree_nbytes(tree: PyTree) -> int:
    return sum(t.numel() * t.element_size() for _, t in flatten(tree)
               if isinstance(t, torch.Tensor))


def rank_report(params: PyTree, cache: PyTree) -> Dict[str, Any]:
    """What one rank holds and has launched: its params' and KV pool's
    bytes, every kernel counter, and (on a card) the device memory its
    process has allocated."""
    launches = {k: v for c in kernel_counters() for k, v in c.items()}
    dev = next((t.device for _, t in flatten(params)
                if isinstance(t, torch.Tensor)), None)
    return dict(param_bytes=tree_nbytes(params),
                kv_pool_bytes=tree_nbytes(cache), launches=launches,
                cuda_allocated=(torch.cuda.memory_allocated(dev)
                                if dev is not None and dev.type == "cuda"
                                else None))


def _worker_main(rank: int, tp: int, devices: List[str], backend: str,
                 init_method: str, timeout_s: float, threads: int, ops,
                 errors, replies) -> None:
    """Rank ``rank``'s process: join the group, then run the operations
    rank 0 sends until ``stop`` (or until rank 0's process is gone)."""
    try:
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=init_method, world_size=tp, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        cpu_group = (dist.new_group(backend="gloo") if backend == "nccl"
                     else dist.group.WORLD)
        register_group(AXIS, dist.group.WORLD)
        worker = _Worker(rank, device, cpu_group, replies)
        parent = mp.parent_process()
        with torch.no_grad():
            while True:
                try:
                    op = ops.get(timeout=1.0)
                except queue.Empty:
                    if parent is not None and not parent.is_alive():
                        break
                    continue
                if op[0] == "stop":
                    break
                worker.run(*op)
    except BaseException:
        errors.put(f"rank {rank}: {traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Rank 0's side of the engine: model calls and pool writes broadcast first
# ---------------------------------------------------------------------------


def sharded_fns(group: ModelGroup, fns: ModelFns) -> ModelFns:
    """Rank 0's ``ModelFns``: each call first has every other rank run it on
    its shard, then runs rank 0's (``fns``, the localized config's).
    ``params`` and ``cache`` are rank 0's own; the other ranks use theirs.
    """
    def prefill(p, batch):
        group.send("prefill", _host(batch))
        return fns.prefill(p, batch)

    def decode_step(p, batch, cache):
        group.send("decode", _host(batch))
        return fns.decode_step(p, batch, cache)

    def prefill_append(p, batch, cache):
        group.send("append", _host(batch))
        return fns.prefill_append(p, batch, cache)

    def init_cache(*args, device="cuda", **kwargs):
        group.send("init_cache", args, kwargs)
        return fns.init_cache(*args, device=device, **kwargs)

    return dataclasses.replace(fns, prefill=prefill, decode_step=decode_step,
                               prefill_append=prefill_append,
                               init_cache=init_cache)


class ShardedPagedSlotPool(PagedSlotPool):
    """Rank 0's paged pool: the host bookkeeping is the single-device
    pool's; each device write (seating a prefill cache, a copy-on-write)
    runs on every rank's ``Hkv`` shard of the pages, each rank seating its
    own prefill cache. Its ``init_cache`` is :func:`sharded_fns`'s, so
    every rank allocates its shard of the pool."""

    def __init__(self, group: ModelGroup, *args: Any, **kwargs: Any):
        self.group = group
        super().__init__(*args, **kwargs)

    def _device_copy(self, src: np.ndarray, dst: np.ndarray) -> None:
        self.group.send("copy", src, dst)
        super()._device_copy(src, dst)

    def _device_seat(self, prefill_cache, dest: np.ndarray,
                     slots: np.ndarray) -> None:
        self.group.send("seat", dest, slots)
        super()._device_seat(prefill_cache, dest, slots)
