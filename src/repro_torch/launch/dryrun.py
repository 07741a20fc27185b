"""Pod-scale dry run (the reference's ``launch/dryrun.py``): run every
(arch × shape × mesh) cell once on fake tensors over a fake 256- or
512-rank process group in one process, proving the distribution config is
coherent, and record the per-rank memory and roofline terms.

Each cell builds its call as the reference's ``build_lowering`` does:
params from ``model_fns(cfg).init_params`` under ``FakeTensorMode`` (no
storage), laid out as ``DTensor`` shards by ``runtime/sharding.py`` (FSDP
for the 405B class; a ``--bcr`` train cell's ADMM duals like the params),
the batch and the decode cache likewise; then ``make_train_step``,
``prefill`` or ``decode_step`` runs once under
``partitioning.use_rules``. Only rank 0's shards exist: every op runs on
local shapes, the collectives go to the fake group.

Per cell this writes experiments/dryrun/<arch>__<shape>__<mesh>.json with:
  * memory_analysis: rank 0's bytes — the state it holds at the start
    (``argument_size_in_bytes``) and the peak of its live storages
    (``peak_memory_in_bytes``), tracked op by op (:class:`LivePeak`)
  * torch_flop_counter: ``torch.utils.flop_counter``'s raw count, over
    the global shapes of DTensor ops (the whole mesh's work) but over one
    rank's shard inside local regions (flash attention's chunk loop); kept
    as the reference keeps XLA's raw cost analysis, not used
  * hlo_corrected: the per-rank FLOPs, bytes and collective bytes by op
    (``runtime/hlo_analysis.py``; the name is the reference's)
  * analytic MODEL_FLOPS (6·N_active·D convention) + params
  * timings: building the cell and running it, in seconds
  * roofline: the H100's terms (below)

Roofline constants are the H100 SXM5's (NVIDIA H100 datasheet), the
model's figures, not measured ones: 989e12 FLOP/s dense bf16, 3.35e12 B/s
HBM3, and 50e9 B/s for the collective term — the per-GPU InfiniBand NDR
link (400 Gb/s), since a 16-wide axis spans two 8-GPU nodes (NVLink 4
gives 450e9 B/s a direction inside one node).

Usage (the card's device type unless ``--device cpu``; the tensors are
fake either way):
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]

One cell runs in this process; a sweep of several runs each cell in a
child process of its own (:data:`SWEEP_PROCESSES` at a time, each stopped
at :data:`CELL_LIMIT_S`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.runtime import partitioning as part
from repro_torch.runtime import sharding as shard
from repro_torch.runtime.analytic import ideal_bytes_per_chip, model_flops
from repro_torch.runtime.hlo_analysis import (CostMode, bmm_flop,
                                              is_dtensor_type, propagating)
from repro_torch.tree import flatten, leaves, tree_map, unflatten

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun")

# H100 SXM5 (NVIDIA H100 datasheet): roofline denominators
PEAK_FLOPS = 989e12     # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12        # HBM3 bytes/s
LINK_BW = 50e9          # bytes/s: one InfiniBand NDR link a GPU (a 16-wide
#                         axis spans two 8-GPU nodes; NVLink 4 inside one
#                         node gives 450e9 a direction)
HBM_BYTES = 80 * 2**30  # the H100's device memory

# A sweep (more than one cell) runs each cell in a child process, this many
# at a time, and stops a cell at this limit: the recurrent families' train
# and prefill cells run their per-token scans op by op under DTensor and
# would take hours (ROADMAP §1); their records then say so.
SWEEP_PROCESSES = min(8, os.cpu_count() or 1)
CELL_LIMIT_S = 240.0


def _json_default(o):
    return str(o)


# ---------------------------------------------------------------------------
# The fake group and per-rank memory
# ---------------------------------------------------------------------------


def fake_group(world: int) -> None:
    """Make the default group a fake one of ``world`` ranks in this
    process (rank 0), replacing a fake group of another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is already initialized")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(shape: Sequence[int], names: Sequence[str], device: str):
    """A ``DeviceMesh`` of ``shape`` over a fake group of as many ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    fake_group(math.prod(shape))
    if tuple(shape) in ((16, 16), (2, 16, 16)) and tuple(names) in (
            ("data", "model"), ("pod", "data", "model")):
        from repro_torch.launch.mesh import make_production_mesh
        return make_production_mesh(multi_pod=len(shape) == 3, device=device)
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(names))


class LivePeak(TorchDispatchMode):
    """Rank 0's live bytes, op by op: every storage a local op returns
    counts from its creation until it is freed (a weak reference's
    callback); :meth:`track` adds the state that exists before the run.
    ``DTensor`` ops are declined (their local ops are tracked), and the
    global-shape ops of DTensor's sharding propagation are not rank 0's."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, Any] = {}
        self.now = 0
        self.peak = 0

    def track(self, tree) -> int:
        self.peak = float("inf")      # no collection while adding the state
        for t in leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(getattr(t, "_local_tensor", t))
        self.peak = self.now
        return self.now

    def _add(self, t: torch.Tensor, own_bytes: bool = False) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        n = t.numel() * t.element_size() if own_bytes else st.nbytes()
        self.live[key] = (weakref.ref(st, functools.partial(self._drop, key)),
                          n)
        self.now += n
        if self.now > self.peak + max(self.peak // 100, 2**24):
            # DTensor's autograd bookkeeping leaves reference cycles whose
            # storages a run without it frees at once: collect them before
            # taking a new peak (within 1% or 16 MiB of the true one)
            gc.collect()
            self.peak = max(self.peak, self.now)

    def _drop(self, key, _ref) -> None:
        _, n = self.live.pop(key, (None, 0))
        self.now -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(is_dtensor_type(t) for t in types):
            return NotImplemented
        if func is torch.ops._c10d_functional.wait_tensor.default:
            # a fake wait returns a new tensor where the real one returns
            # its argument: do not count the buffer twice
            return args[0]
        out = func(*args, **(kwargs or {}))
        # the all-to-all's fake kernel returns a view of every rank's
        # blocks; the collective itself writes only this rank's
        own = func is torch.ops._dtensor.shard_dim_alltoall.default
        if not propagating():
            for t in torch.utils._pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._add(t, own)
        return out


_SHARDING_FAILURES = ("Sharding propagation failed", "sharding strategy",
                      "unevenly sharded", "not evenly divisible",
                      # a local view DTensor planned for a shard it cannot
                      # take (a head dim split over more ranks than heads)
                      "is invalid for input of size")


class ReshardOnFailure(TorchDispatchMode):
    """Where DTensor has no sharding for an op on its arguments' layouts
    (a view that splits a sharded dim unevenly — 20 heads over a 16-wide
    axis — or an op without a strategy), gather the cheapest operand along
    one mesh dim and run the op again, as GSPMD reshards around such an
    op: each (operand, sharded mesh dim) in order of the bytes its
    all-gather brings in, then every operand replicated. An in-place op
    runs on the gathered copy and is written back into its sharded
    destination. A dispatch mode, so it also acts in the backward pass and
    in recomputed (checkpointed) layers. Counts the ops it resharded
    (``fallbacks``); their all-gathers are counted by the cost mode like
    any other."""

    def __init__(self):
        super().__init__()
        self.fallbacks: Dict[str, int] = {}
        self.gathered: Dict[str, int] = {}    # bytes a rank gained, by op

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(is_dtensor_type(t) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError, AssertionError) as e:
            if not any(m in str(e) for m in _SHARDING_FAILURES):
                raise
            first = e
        from torch.distributed.tensor import DTensor, Replicate

        flat, spec = torch.utils._pytree.tree_flatten((args, kwargs))
        cands = []
        for i, t in enumerate(flat):
            if isinstance(t, DTensor):
                n = t.device_mesh.size()
                for m, p in enumerate(t.placements):
                    if not p.is_replicate():
                        cands.append((t.to_local().numel() * n
                                      * t.element_size(), i, m))
        tries = [[(i, m)] for _, i, m in sorted(cands)]
        tries.append([(i, m) for _, i, m in cands])
        for moves in tries:
            new = list(flat)
            try:
                for i, m in moves:
                    pl = list(new[i].placements)
                    pl[m] = Replicate()
                    new[i] = new[i].redistribute(new[i].device_mesh, pl)
                rargs, rkwargs = torch.utils._pytree.tree_unflatten(new, spec)
                out = func(*rargs, **rkwargs)
            except (RuntimeError, NotImplementedError, AssertionError):
                continue
            name = str(func)
            self.fallbacks[name] = self.fallbacks.get(name, 0) + 1
            grown = sum(new[i].to_local().numel() * new[i].element_size()
                        - flat[i].to_local().numel() * flat[i].element_size()
                        for i, _ in moves)
            self.gathered[name] = self.gathered.get(name, 0) + grown
            schema = func._schema.arguments
            if (schema and schema[0].alias_info is not None
                    and schema[0].alias_info.is_write
                    and rargs[0] is not args[0]):
                args[0].copy_(rargs[0])    # an in-place op: write it back
                return args[0]
            return out
        raise first


@contextlib.contextmanager
def alltoall_as_one_op():
    """DTensor moves a shard to another dim with one all-to-all, except on
    a CPU mesh, where it gathers the whole dim first (gloo has no
    all-to-all): a CPU-mesh dry run would count a rank holding that. Here
    every mesh takes the one all-to-all op (whose fake kernel gives the
    moved shard), so a CPU dry run counts what a card's does."""
    from torch.distributed.tensor import placement_types

    orig = placement_types.shard_dim_alltoall

    def one_op(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    placement_types.shard_dim_alltoall = one_op
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


def distribute(t: torch.Tensor, spec, mesh, *, device, dtype=None,
               requires_grad: bool = False):
    """A fresh (fake) rank-0 shard of ``t``'s global shape laid out by
    ``spec``, as a ``DTensor`` over ``mesh`` (a plain tensor on a one-rank
    mesh)."""
    from torch.distributed.tensor import DTensor

    dtype = dtype or t.dtype
    if mesh.size() == 1:
        local = torch.empty(tuple(t.shape), dtype=dtype, device=device)
        return local.requires_grad_(requires_grad)
    local = torch.empty(shard.local_shape(t.shape, spec, mesh), dtype=dtype,
                        device=device)
    d = DTensor.from_local(local, mesh, shard.placements(spec, mesh),
                           run_check=False, shape=tuple(t.shape),
                           stride=_contiguous_stride(t.shape))
    return d.requires_grad_(requires_grad)


def _grad_as_param(p) -> None:
    """A param's gradient, once accumulated, laid out as the param (FSDP's
    reduce-scatter): DTensor may leave it gathered over the axes the
    forward gathered the weight over, one whole layer's weights a rank."""
    if tuple(p.grad.placements) != tuple(p.placements):
        p.grad = p.grad.redistribute(p.device_mesh, p.placements)


def _host_zero() -> torch.Tensor:
    """A real int32 0-d step counter on the host, made outside fake mode:
    the trainer reads the step on the host (``float(schedule(...))``)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return torch.zeros((), dtype=torch.int32)


def build_call(cfg: ModelConfig, shape: ShapeSpec, mesh, device,
               full: Optional[ModelConfig] = None):
    """(fn, args, state) of one cell, inside an active ``FakeTensorMode``:
    the sharded params (and optimizer and ADMM state), batch and cache;
    ``state`` is every tensor rank 0 holds before the call. ``full`` is the
    uncut config of a depth-cut ``cfg``: it decides FSDP and the stack
    sizes the rules see, so a cut layer is laid out as the full model's."""
    from repro_torch.launch.train import (TrainState, default_prune_filter,
                                          make_train_step)
    from repro_torch.models.api import input_specs, model_fns
    from repro_torch.optim import adamw

    fns = model_fns(cfg)
    specs = input_specs(cfg, shape)
    train = shape.kind == "train"
    glob = fns.init_params(0, device=device)
    full = full or cfg
    fsdp = full.num_layers * full.d_model >= 126 * 16384   # 405B-class
    repeats = set(shard.stack_sizes(full).values()) or {0}
    stacks = {k: max(repeats) for k in shard.stack_sizes(cfg)}
    pspecs = shard.param_specs(glob, mesh, fsdp=fsdp, stacks=stacks)

    def like_params(dtype=None, requires_grad=False, keep=None):
        return unflatten(glob, [
            None if keep is not None and path not in keep else
            distribute(t, pspecs[path], mesh, device=device, dtype=dtype,
                       requires_grad=requires_grad)
            for path, t in flatten(glob)])

    params = like_params(requires_grad=train)
    if train:
        for p in leaves(params):
            if p is not None and part.is_dtensor(p):
                p.register_post_accumulate_grad_hook(_grad_as_param)
    batch = tree_map(lambda t: distribute(
        t, shard.batch_pspec(t.shape, mesh), mesh, device=device),
        specs["batch"])

    if train:
        opt_cfg = adamw.AdamWConfig(total_steps=1000)
        opt = adamw.AdamWState(like_params(torch.float32),
                               like_params(torch.float32), _host_zero())
        admm_state = admm_cfg = admm_specs = None
        if cfg.bcr_keep_frac > 0:
            # the paper's ADMM pruning phase at pod scale: per-leaf Z/U
            # duals (sharded like params) + the penalty term in the loss
            from repro_torch.core import admm as admm_mod
            admm_cfg = admm_mod.ADMMConfig()
            admm_specs = admm_mod.specs_for(glob, default_prune_filter(cfg))
            admm_state = admm_mod.ADMMState(like_params(keep=admm_specs),
                                            like_params(keep=admm_specs),
                                            _host_zero())
        del glob
        state = TrainState(params, opt, admm_state, None)
        step = make_train_step(cfg, opt_cfg, admm_cfg, admm_specs)
        return step, (state, batch), (state, batch)

    del glob
    if shape.kind == "prefill":
        return fns.prefill, (params, batch), (params, batch)
    cache = specs["cache"]
    cspecs = shard.cache_specs(cache, mesh, batch=shape.global_batch,
                               capacity=shape.seq_len, stacks=stacks)
    cache = unflatten(cache, [distribute(t, cspecs[path], mesh,
                                         device=device)
                              for path, t in flatten(cache)])
    return fns.decode_step, (params, batch, cache), (params, batch, cache)


def measure_once(cfg: ModelConfig, shape: ShapeSpec, mesh, device,
                 full: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Build and run one cell on fake tensors (``full``: see
    :func:`build_call`); returns its memory, cost and timing records."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    rules = part.DECODE_RULES if shape.kind == "decode" else part.TRAIN_RULES
    grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True), \
            implicit_replication(), alltoall_as_one_op(), \
            part.use_rules(rules, mesh):
        fn, args, state = build_call(cfg, shape, mesh, device, full)
        t_build = time.time() - t0
        mem, cost = LivePeak(), CostMode()
        held = mem.track(state)
        del state
        flops = FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.bmm: bmm_flop})
        reshard = ReshardOnFailure()
        t0 = time.time()
        with mem, cost, reshard, flops, grad:
            out = fn(*args)
        del out, args
        t_run = time.time() - t0
    return {
        "resharded_ops": reshard.fallbacks,
        "resharded_bytes": reshard.gathered,
        "memory_analysis": {"argument_size_in_bytes": held,
                            "peak_memory_in_bytes": mem.peak,
                            "temp_size_in_bytes": mem.peak - held},
        "torch_flop_counter": {"flops": float(flops.get_total_flops())},
        "hlo_corrected": cost.report(),
        "timings": {"build_s": t_build, "run_s": t_run},
    }


def stack_unit(cfg: ModelConfig):
    """``(unstacked layers, layers a repeat, repeats)`` of the config's
    layer stack (the reference's ``stack_plan``; an encdec model's repeat
    is one encoder and one decoder layer), or None when it has no repeat
    to cut."""
    if cfg.family == "encdec":
        if cfg.encoder_layers != cfg.num_layers:
            return None
        return 0, 1, cfg.num_layers
    stacks = shard.stack_sizes(cfg)
    if not stacks:
        return None
    repeats = next(iter(stacks.values()))
    first = cfg.num_layers - len(stacks)
    return first, len(stacks) // repeats, repeats


def _cut(cfg: ModelConfig, shape: ShapeSpec, k: int, a: int):
    """The cell at ``k`` repeats of its layer stack and, for a train cell,
    ``a`` microbatches of its microbatch size."""
    first, per, _ = stack_unit(cfg)
    over = {"num_layers": first + k * per}
    if cfg.family == "encdec":
        over["encoder_layers"] = k
    if shape.kind == "train":
        accum = max(cfg.grad_accum, 1)
        over["grad_accum"] = a
        shape = dataclasses.replace(
            shape, global_batch=a * (shape.global_batch // accum))
    return dataclasses.replace(cfg, **over), shape


def _combine(runs: Dict[tuple, Dict[str, Any]], repeats: int,
             accum: int) -> Dict[str, Any]:
    """Each number of the records at k ∈ {1, 2} repeats (and two counts of
    microbatches, a1 < a2) carried to ``k = repeats``, ``a = accum`` by the
    bilinear form the runs pin down: the layers of a stack are identical,
    as are the microbatches after the second (the first writes each
    gradient, later ones add into it), so a count is ``c0 + k·c1 + a·c2 +
    k·a·c3``; so is rank 0's peak."""
    a1, a2 = sorted({a for _, a in runs}) + [None] * (2 - len(
        {a for _, a in runs}))

    def at(path):
        def get(key):
            r = runs[key]
            for p in path:
                r = r.get(p, 0.0) if isinstance(r, dict) else 0.0
            return float(r)
        f11, f21 = get((1, a1)), get((2, a1))
        out = f11 + (repeats - 1) * (f21 - f11)
        if a2 is None:
            return out
        f12, f22 = get((1, a2)), get((2, a2))
        t = (accum - a1) / (a2 - a1)
        return out + t * ((f12 - f11)
                          + (repeats - 1) * (f22 - f21 - f12 + f11))

    base = runs[(1, a1)]
    out: Dict[str, Any] = {}
    for section in ("memory_analysis", "torch_flop_counter",
                    "hlo_corrected"):
        keys = set()
        for r in runs.values():
            keys |= set(r[section])
        out[section] = {k: at((section, k)) for k in sorted(keys)}
    mem = out["memory_analysis"]
    mem["temp_size_in_bytes"] = (mem["peak_memory_in_bytes"]
                                 - mem["argument_size_in_bytes"])
    out["timings"] = {k: sum(r["timings"][k] for r in runs.values())
                      for k in base["timings"]}
    for key in ("resharded_ops", "resharded_bytes"):
        out[key] = {}
        for r in runs.values():
            for k, v in r[key].items():
                out[key][k] = out[key].get(k, 0) + v
    out["points"] = {f"{k}x{a}": {
        "peak_memory_in_bytes": r["memory_analysis"]["peak_memory_in_bytes"],
        "flops": r["hlo_corrected"]["flops"]} for (k, a), r in runs.items()}
    return out


def measure(cfg: ModelConfig, shape: ShapeSpec, mesh, device, *,
            exact: bool = False) -> Dict[str, Any]:
    """One cell's records. A decode cell (one step a layer) and an
    ``exact`` one run at full depth. A train or prefill cell runs its layer
    stack at 1 and 2 repeats (a train cell that accumulates, at 2 and 3
    microbatches of its size too; 1 and 2 when it accumulates 2) and its
    counts are carried to the full
    depth and accumulation (:func:`_combine`): an eager run of every layer
    and microbatch of a 126-layer model would dispatch millions of fake
    ops. ``extrapolated`` in the record says from what."""
    unit = stack_unit(cfg)
    if exact or shape.kind == "decode" or unit is None:
        return measure_once(cfg, shape, mesh, device)
    repeats = unit[2]
    accum = max(cfg.grad_accum, 1) if shape.kind == "train" else 1
    micro = (1,) if accum == 1 else (1, 2) if accum == 2 else (2, 3)
    points = [(k, a) for a in micro for k in (1, 2)]
    runs = {}
    for k, a in points:
        ccfg, cshape = _cut(cfg, shape, k, a)
        runs[(k, a)] = measure_once(ccfg, cshape, mesh, device, full=cfg)
    out = _combine(runs, repeats, accum)
    out["extrapolated"] = {
        "repeats": [1, 2], "to_repeats": repeats,
        "layers_a_repeat": unit[1], "unstacked_layers": unit[0],
        "microbatches": list(micro), "to_microbatches": accum}
    return out


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str = OUT_DIR, force: bool = False,
             cfg_override: Optional[ModelConfig] = None,
             tag: str = "", device="cuda",
             shape_override: Optional[ShapeSpec] = None,
             mesh_shape: Optional[Sequence[int]] = None,
             exact: bool = False) -> Dict[str, Any]:
    """One cell's record (read from ``out_dir`` unless ``force``).
    ``shape_override`` runs another shape under the name ``shape_name``;
    ``mesh_shape`` another ``("data", "model")`` mesh (named
    ``mesh<d>x<m>``); ``exact`` runs every layer (:func:`measure`)."""
    name = (mesh_name(multi_pod) if mesh_shape is None
            else "mesh" + "x".join(map(str, mesh_shape)))
    cell = f"{arch}__{shape_name}__{name}{tag}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = cfg_override or get_config(arch)
    shape = shape_override or SHAPES[shape_name]
    if shape.kind in ("prefill", "decode") and cfg_override is None:
        # serving runs in bf16 weights (deploy dtype); training keeps fp32
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": name, "kind": shape.kind,
    }
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        record.update(status="skipped", reason=why)
        with open(path, "w") as f:
            json.dump(record, f, indent=2, default=_json_default)
        return record

    try:
        from repro_torch import resolve_device
        dev = resolve_device(device)
        if mesh_shape is None:
            mshape = (2, 16, 16) if multi_pod else (16, 16)
            names = ("pod", "data", "model") if multi_pod else ("data",
                                                                "model")
        else:
            mshape, names = tuple(mesh_shape), ("data", "model")
        mesh = make_mesh(mshape, names, dev.type)
        record.update(measure(cfg, shape, mesh, dev, exact=exact))
        corrected = record["hlo_corrected"]
        record["analytic"] = model_flops(cfg, shape)
        n_chips = mesh.size()
        record["analytic"]["ideal_bytes_per_chip"] = ideal_bytes_per_chip(
            cfg, shape, n_chips)

        # per-rank program: corrected numbers are per chip
        compute_s = corrected["flops"] / PEAK_FLOPS
        memory_s = corrected["bytes_accessed"] / HBM_BW
        collective_s = corrected["collective_bytes"] / LINK_BW
        dominant = max(
            (("compute", compute_s), ("memory", memory_s),
             ("collective", collective_s)), key=lambda kv: kv[1])[0]
        record["roofline"] = {
            "n_chips": n_chips,
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": dominant,
            "model_flops_ratio": (
                record["analytic"]["model_flops"]
                / max(corrected["flops"] * n_chips, 1.0)),
            "fits_hbm": (record["memory_analysis"]["peak_memory_in_bytes"]
                         < HBM_BYTES),
        }
        record["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"[:2000]
        record["traceback"] = traceback.format_exc()[-4000:]

    with open(path, "w") as f:
        json.dump(record, f, indent=2, default=_json_default)
    return record


def _line(rec: Dict[str, Any], seconds: float, multi_pod: bool) -> str:
    status = rec.get("status")
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = (f"dom={r['dominant']} comp={r['compute_s']:.3e}s "
                 f"mem={r['memory_s']:.3e}s coll={r['collective_s']:.3e}s "
                 f"peak={rec['memory_analysis']['peak_memory_in_bytes']/2**30:.2f}GiB")
    elif status == "error":
        extra = rec.get("error", "")[:160]
    elif status == "skipped":
        extra = rec.get("reason", "")[:80]
    return (f"[{seconds:7.1f}s] {rec['arch']:28s} {rec['shape']:12s} "
            f"{'2x16x16' if multi_pod else '16x16':8s} {status:8s} {extra}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--bcr", type=float, default=0.0,
                   help="BCR keep_frac: runs the ADMM pruning train phase")
    p.add_argument("--out-dir", default=OUT_DIR)
    p.add_argument("--device", default="cuda",
                   help="the fake tensors' device type (cuda: the card's)")
    args = p.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(arch, s, mp) for arch in archs for s in shapes for mp in meshes]
    tag = f"__bcr{args.bcr}" if args.bcr > 0 else ""

    if len(cells) == 1:
        arch, s, mp = cells[0]
        t0 = time.time()
        override = (dataclasses.replace(get_config(arch),
                                        bcr_keep_frac=args.bcr)
                    if args.bcr > 0 else None)
        rec = run_cell(arch, s, multi_pod=mp, out_dir=args.out_dir,
                       force=args.force, cfg_override=override, tag=tag,
                       device=args.device)
        print(_line(rec, time.time() - t0, mp), flush=True)
        return

    # a sweep: each cell in a process of its own (each its own fake group),
    # SWEEP_PROCESSES at a time, stopped at CELL_LIMIT_S
    from concurrent.futures import ThreadPoolExecutor, as_completed

    with ThreadPoolExecutor(SWEEP_PROCESSES) as pool:
        jobs = {pool.submit(_cell_in_child, args, arch, s, mp, tag): mp
                for arch, s, mp in cells}
        for job in as_completed(jobs):
            rec, seconds = job.result()
            print(_line(rec, seconds, jobs[job]), flush=True)


def _cell_in_child(args, arch: str, shape: str, multi_pod: bool,
                   tag: str):
    """``(record, seconds)`` of one cell run by this module's CLI in a
    child process; a child stopped at :data:`CELL_LIMIT_S`, or one that
    ended without its record, is recorded as an error."""
    path = os.path.join(args.out_dir, f"{arch}__{shape}__"
                        f"{mesh_name(multi_pod)}{tag}.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out-dir", args.out_dir, "--device",
           args.device, "--bcr", str(args.bcr)]
    cmd += ["--multi-pod"] if multi_pod else []
    cmd += ["--force"] if args.force else []
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, timeout=CELL_LIMIT_S, text=True,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE)
        if proc.returncode == 0:
            with open(path) as f:
                return json.load(f), time.time() - t0
        error = (f"ChildProcessError: the cell's process exited "
                 f"{proc.returncode}: {proc.stderr[-1500:]}")
    except subprocess.TimeoutExpired:
        error = (f"TimeoutError: the cell ran past {CELL_LIMIT_S:.0f} s "
                 f"(its process stopped)")
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name(multi_pod),
           "kind": SHAPES[shape].kind, "status": "error", "error": error}
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    return rec, time.time() - t0


if __name__ == "__main__":
    main()
