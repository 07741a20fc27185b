"""InferenceEngine: continuous-batching serving over (BCR-packed) params
on a block-paged or a capacity-dense KV pool — the reference engine's
single-device serving path.

Each ``step()``:

  1. admits waiting requests into free slots (under the page budget on a
     paged pool; strict FCFS: the first request the pool cannot cover
     requeues itself and everything behind it). All admissions of a step
     share ONE batched ``prefill`` (prompts right-padded to a power-of-two
     bucket, rows padded to a power-of-two tier) whose KV is seated into
     each slot's pages or rows; steady-state backfills are chunked
     (``backfill_chunk``);
  2. runs ONE ``decode_step`` over the whole ragged slot batch with
     per-slot lengths — over a paged pool with block tables sliced to the
     pow2-bucketed live width, so the paged attention kernel reads each
     slot's live pages only; over the capacity-dense pool
     (``page_size=0``, the reference's default) through the plain
     ``decode_attention`` over every slot's ``capacity`` rows;
  3. samples per slot (greedy / temperature / top-k), advances lengths and
     retires finished requests.

Free slots ride along as garbage rows: their length is 0 (and on a paged
pool their table row is zero, so their writes land in the null page) and
their output is dropped.

MoE families, as in the reference: routing couples tokens through the
expert capacity, so the engine threads a ``token_mask`` into every prefill
(real positions of real rows) and every decode step (``lens > 0``), and
garbage rows never claim capacity. Their cold prefill runs at exact length
(``pad_prefill`` is on for the dense and vlm families only), one dispatch
per prompt length, and the prefix cache is silently off.

Recurrent families, as in the reference: a recurrent layer's state (RWKV,
mamba) runs through every prompt position, so the ssm and hybrid families
prefill at exact length too, and their state cannot be adopted from a
shared prefix or rolled back (no prefix cache; ``spec_k > 0`` raises). An
ssm model has no attention K/V: it serves from the capacity-dense pool
whatever ``page_size`` says. A hybrid model's paged pool pages its
attention layers and keeps its mamba state slot-major.

Quantized serving: ``kv_dtype="int8"`` stores the pool as int8 codes with
per-row, per-kv-head fp32 scales; ``weight_dtype="int8"`` quantizes the
packed tiles to int8 codes with one fp32 scale per tile at engine build.

Prefix cache (``prefix_cache=True``, paged pools only): admission matches
each prompt against the pool's content-addressed index, adopts the shared
full-page prefix (refcount bump, no recompute), copies a shared partial
final page before the suffix writes into it (copy-on-write) and runs ONE
bucketed ``prefill_append`` for just the uncached suffixes, through the
paged attention kernel's prefill-append form. A step may run that dispatch
and one cold prefill.

Speculative decoding (``spec_k > 0``, paged pools only): every decode step
becomes a draft→verify→accept step. A drafter (``serving/speculative.py``:
a small second model on its own capacity-dense pool, or a replaying
oracle) proposes up to ``spec_k`` tokens a slot; ONE ``prefill_append``
dispatch (``all_logits=True``, the paged kernel's prefill-append form with
``spec_k + 1`` rows a slot and ragged suffix lengths) scores the pending
token and every draft; host-side acceptance commits the longest agreeing
prefix plus one token from the target's own row, and the pool truncates
back to the commit frontier (the pages past it were drawn this step and
never shared).

Request lifecycle, as in the reference: per-request deadlines (TIMEOUT,
waiting or mid-decode), ``cancel``, ``pause``/``resume``, bounded-queue
shedding (``max_waiting``), page-pressure preemption
(``preempt_after_stalls``, paged pools: the victim's tokens fold into its
prompt and it re-prefills), per-row NaN containment (a row whose sampled
logits are not finite retires as FAILED and emits nothing), ``recover()``
after a failed step, an injectable clock, a step watchdog and a seeded
fault injector (``serving/faults.py``). SLO admission (``slo_admission``)
rejects at submit a deadline the occupancy simulation of
``serving/admission.py`` proves unmakeable; per-tenant quotas
(``tenant_quotas``: rate, concurrency, KV pages) reject over-quota submits
with a computed ``retry_after_s`` and weight the scheduler's fair queue.
One reentrant lock serializes every public entry point, so other threads
may submit and cancel against a stepping engine.

Tensor parallelism (``mesh_model > 1``, ``serving/tp.py``): one process a
rank. This process is rank 0: it runs the scheduler, the pool's
bookkeeping, admission and sampling, and broadcasts each model call and
each device write of the pool to the other ranks before running its own
part; every projection is column-parallel and attention head-parallel over
an ``Hkv``-split pool, so greedy tokens equal one device's. It needs a
paged pool on a dense or vlm model whose head counts divide the mesh, and
composes with the prefix cache, ``spec_k`` (the drafter runs on rank 0,
unsharded) and int8 KV and weights. ``kv_bytes_read`` counts every rank's
KV reads, ``kv_bytes_read_device`` one rank's (equal at mesh 1).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import chunks_fit, prefill_bucket
from repro_torch.kernels.plan import plan_params, quantize_packed_params
from repro_torch.models.api import model_fns
from repro_torch.models.causal_lm import has_attention
from repro_torch.models.layers import (CHUNKED_ATTN_IMPLS, FLASH_ATTN_IMPLS,
                                      flash_chunks)
from repro_torch.serving.admission import (TenantQuota, TokenBucket,
                                           estimate_seat_steps,
                                           request_work_steps)
from repro_torch.serving.faults import StepWatchdog
from repro_torch.serving.kv_slots import PagedSlotPool, SlotPool
from repro_torch.serving.scheduler import (CANCELLED, FAILED, FINISHED,
                                           REJECTED, TIMEOUT, Request,
                                           Scheduler)
from repro_torch.serving.speculative import (DraftModel, accept_draft,
                                             accept_greedy)
from repro_torch.serving.tp import per_device_kv_bytes

PyTree = Any

# families whose cold prefill right-pads prompts to a shared bucket; the
# others prefill at exact length, grouped by prompt length
_PADDED_FAMILIES = ("dense", "vlm")


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  temps: torch.Tensor, topks: torch.Tensor,
                  use_topk: bool = True) -> torch.Tensor:
    """Per-slot sampling: temps==0 → greedy (first maximal index, as
    ``jnp.argmax``); topks>0 → top-k filtering. logits (B, V); temps (B,);
    topks (B,). Sampled rows take the Gumbel-max draw ``argmax(z + g)``,
    ``g = -log(-log(u))`` with ``u`` uniform from ``generator`` — what the
    reference's ``jax.random.categorical`` computes — so a NaN or ±inf row
    still yields a token and never aborts the batch (the engine then fails
    that row's request). Tokens match
    the reference only in distribution."""
    logits = logits.float()
    v = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    z = logits
    if use_topk:
        srt = torch.sort(logits, dim=-1, descending=True).values
        kth = torch.gather(srt, 1, torch.clamp(topks.long() - 1, 0,
                                               v - 1)[:, None])
        allow = (topks[:, None] <= 0) | (logits >= kth)
        z = torch.where(allow, logits, torch.full_like(logits, -float("inf")))
    z = z / torch.clamp(temps, min=1e-6)[:, None]
    u = torch.rand(z.shape, generator=generator, device=z.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    sampled = torch.argmax(z + gumbel, dim=-1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 8
    capacity: int = 128
    seed: int = 0
    max_admit_per_step: Optional[int] = None  # None → fill every free slot
    min_bucket: int = 8
    pad_prefill: Optional[bool] = None        # None → auto by model family
    # block-paged KV: page_size > 0 keeps attention K/V in a shared page
    # pool indexed by per-slot block tables (kv_pages None → full
    # provisioning; fewer pages oversubscribe the pool and admission
    # control requeues what the budget cannot cover); 0 → the
    # capacity-dense SlotPool (every slot owns `capacity` rows)
    page_size: int = 16
    kv_pages: Optional[int] = None
    # prefix sharing over the paged pool: admissions adopt cached full-page
    # prompt prefixes (refcounted, CoW on a shared partial final page) and
    # prefill only the uncached suffix; admitted prompts publish their full
    # pages into the pool's LRU-evicted prefix index. Paged pools only.
    prefix_cache: bool = False
    # chunked backfill: hold steady-state admissions until `backfill_chunk`
    # can be seated together (or `backfill_max_defer` decode steps pass, or
    # the engine is idle), then run ONE merged prefill for all of them
    backfill_chunk: int = 2
    backfill_max_defer: int = 2
    # GRIM's compile step at engine build (kernels/plan.plan_params): tune
    # every packed weight's CUDA launch for this engine's decode batch
    # (n_slots) and fuse shared-activation groups where the tuner votes
    # to; plans the packer already tuned and groups it fused are kept.
    # plan_fitness picks the tuner's backend: "analytic" (a model of the
    # kernel on an H100) or "wallclock" (the kernel timed on the card)
    plan_packed: bool = True
    plan_fitness: str = "analytic"
    # speculative decoding: spec_k > 0 makes every decode step a
    # draft→verify→accept step (paged pools only) — a drafter proposes up
    # to spec_k tokens a live slot and ONE prefill_append dispatch scores
    # them plus the pending token, committing 1..spec_k+1 tokens a step.
    # The drafter is draft_cfg (+ draft_params at engine build: a small
    # causal LM sharing the target's vocab) or an explicit `drafter`
    # object with serving/speculative.py's protocol. Requests then need
    # spec_k tokens of slot headroom (prompt + max_new_tokens + spec_k
    # must fit the capacity): the verify dispatch writes draft K/V past
    # the commit frontier before acceptance rolls it back.
    spec_k: int = 0
    draft_cfg: Optional[ModelConfig] = None
    # quantized serving: "int8" KV pages (codes + per-row scales) and/or
    # int8 packed tiles (codes + per-tile scales)
    kv_dtype: str = ""
    weight_dtype: str = ""
    # lifecycle: max_waiting bounds the waiting queue (beyond it submit()
    # sheds the lowest-tier waiting request with the earliest deadline as
    # REJECTED); preempt_after_stalls > 0 evicts the youngest running
    # request once the FCFS head has stalled on pages that many steps;
    # watchdog_threshold scales the EWMA slow-step detector (0 disables);
    # fault_injector takes a serving/faults.py FaultInjector
    max_waiting: Optional[int] = None
    preempt_after_stalls: int = 0
    watchdog_threshold: float = 3.0
    fault_injector: Any = None
    # SLO-aware admission (serving/admission.py): submit() event-simulates
    # slot turnover against the step-time estimate and rejects a
    # deadline-carrying request whose finish is provably past
    # deadline_s × slo_slack. slo_step_time pins the step-time estimate in
    # seconds (0 → the engine's own EWMA of measured steps). Every reject
    # and shed carries Request.retry_after_s from the same simulation.
    slo_admission: bool = False
    slo_slack: float = 1.0
    slo_step_time: float = 0.0
    # per-tenant isolation: tenant -> TenantQuota (rate/burst token
    # bucket, concurrent-request cap, KV page budget, WFQ weight);
    # default_tenant_quota covers tenants not listed (None → unlimited)
    tenant_quotas: Optional[Dict[str, TenantQuota]] = None
    default_tenant_quota: Optional[TenantQuota] = None
    # tensor-parallel serving (serving/tp.py): mesh_model > 1 shards every
    # projection column-parallel (output rows / BCR row blocks, re-
    # replicated by all-gathers so greedy tokens stay bit-identical to one
    # device) and attention head-parallel over an Hkv-split paged pool, one
    # process a rank. mesh_devices lists each rank's device, rank 0's (the
    # engine's) first: () → one card a rank (raising when fewer are
    # visible); ("cuda:0",) * N shares one card, ("cpu",) * N runs on the
    # CPU. Needs a paged pool on a pure-attention dense/vlm family with
    # head counts divisible by the mesh
    mesh_model: int = 1
    mesh_devices: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.mesh_model < 1:
            raise ValueError(f"mesh_model must be >= 1, got "
                             f"{self.mesh_model}")
        if self.mesh_devices and len(self.mesh_devices) != self.mesh_model:
            raise ValueError(f"{len(self.mesh_devices)} mesh_devices for "
                             f"mesh_model={self.mesh_model}")
        for name in ("kv_dtype", "weight_dtype"):
            if getattr(self, name) not in ("", "int8"):
                raise ValueError(f"unsupported {name} "
                                 f"{getattr(self, name)!r}")


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, params: PyTree,
                 ec: Optional[EngineConfig] = None, *, device="cuda",
                 draft_params: PyTree = None, drafter: Any = None,
                 clock: Optional[Callable[[], float]] = None,
                 group: Any = None):
        if cfg.family == "encdec":
            raise NotImplementedError(
                "InferenceEngine serves decoder-only families; encdec "
                "prefill needs encoder frames and a different cache tree")
        ec = ec or EngineConfig()
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine on "
                             f"{self.device}")
        if ec.kv_dtype:
            cfg = dataclasses.replace(cfg, kv_dtype=ec.kv_dtype)
        if ec.weight_dtype:
            # idempotent: packs quantized by pack_params stay as they are;
            # before planning, so the tuner prices the 1-byte tiles
            params = quantize_packed_params(params)
        if ec.plan_packed:
            params = plan_params(params, m=ec.n_slots,
                                 fitness=ec.plan_fitness)
        self.cfg = cfg
        self.ec = ec
        # tensor parallelism: shard the params over the group's ranks (each
        # rank receives its own shard) and broadcast every model call; the
        # model each rank runs sees its own head counts (tp.localize_cfg)
        self.tp = ec.mesh_model
        self.group = None
        self._owns_group = False
        if self.tp > 1:
            from repro_torch.serving import tp as tp_lib
            reason = tp_lib.shardable(cfg, self.tp, ec.page_size)
            if reason is not None:
                raise ValueError(f"mesh_model={self.tp}: {reason}")
            if group is None:
                group = tp_lib.make_model_group(self.tp,
                                                ec.mesh_devices or None)
                self._owns_group = True
            if group.tp != self.tp or group.devices[0] != self.device:
                raise ValueError(f"the model group ({group.tp} ranks, rank "
                                 f"0 on {group.devices[0]}) does not match "
                                 f"mesh_model={self.tp} on {self.device}")
            self.group = group
            local = tp_lib.localize_cfg(cfg, self.tp)
            params = group.load(params, local)
            self.fns = tp_lib.sharded_fns(group, model_fns(local))
        else:
            self.fns = model_fns(cfg)
        self.params = params
        self.pad_prefill = (cfg.family in _PADDED_FAMILIES
                            if ec.pad_prefill is None else ec.pad_prefill)
        if cfg.attn_impl in CHUNKED_ATTN_IMPLS and self.pad_prefill:
            bad = [b for b in self._buckets() if not self._chunks_fit(b)]
            if bad:
                raise ValueError(
                    f"prefill buckets {bad} do not split into the flash "
                    f"chunks q_chunk={cfg.q_chunk}, kv_chunk={cfg.kv_chunk}")
        # a model with no attention layer holds no K/V to page: its
        # recurrent state lives in the capacity-dense pool whatever
        # page_size says
        self.paged = ec.page_size > 0 and has_attention(cfg)
        if self.paged:
            pool_args = (self.fns.init_cache, ec.n_slots, ec.capacity)
            pool_kw = dict(page_size=ec.page_size, n_pages=ec.kv_pages,
                           device=self.device)
            if self.group is not None:
                self.pool: Any = tp_lib.ShardedPagedSlotPool(
                    self.group, *pool_args, **pool_kw)
            else:
                self.pool = PagedSlotPool(*pool_args, **pool_kw)
        else:
            self.pool = SlotPool(self.fns.init_cache, ec.n_slots,
                                 ec.capacity, device=self.device)
        self.sched = Scheduler(ec.n_slots)
        # prefix sharing and preemption read pages: paged pools only, as in
        # the reference (which ignores prefix_cache on an unpaged pool, and
        # for the families it prefills at exact length)
        self.prefix_cache = (bool(ec.prefix_cache) and self.paged
                             and cfg.family in _PADDED_FAMILIES)
        # speculative decoding: verification is a prefill_append over the
        # pages and rollback truncates them, so it needs the paged pool
        self.spec = ec.spec_k > 0
        if self.spec:
            if not self.paged or any(self.pool.slot_keys):
                raise ValueError(
                    "spec_k > 0 needs a block-paged pool (page_size > 0) "
                    "on a pure-attention family: verification runs through "
                    "prefill_append and rollback rewinds pages (recurrent "
                    "mixers cannot rewind state)")
            if drafter is None:
                if ec.draft_cfg is None or draft_params is None:
                    raise ValueError(
                        "spec_k > 0 needs a drafter: pass draft_cfg + "
                        "draft_params, or a drafter object")
                if ec.draft_cfg.vocab_size != cfg.vocab_size:
                    raise ValueError(
                        "drafter must share the target's token space")
                drafter = DraftModel(ec.draft_cfg, draft_params, ec.n_slots,
                                     ec.capacity, min_bucket=ec.min_bucket,
                                     device=self.device)
        self.drafter = drafter
        # acceptance draws (sampled requests) come from a numpy generator,
        # as in the reference, so one seed decides alike in both packages
        self._rng = np.random.default_rng(ec.seed)
        # one reentrant lock around every scheduler/pool mutation; reentrant
        # because step() itself cancels (fault injection)
        self._elock = threading.RLock()
        # deadlines, latency timestamps, quotas and the watchdog all read
        # this clock, so tests drive time deterministically (FakeClock)
        self._clock: Callable[[], float] = clock or time.perf_counter
        self.faults = ec.fault_injector
        self._step_idx = -1      # engine step counter (fault schedule index)
        self._stall_steps = 0    # consecutive fully page-stalled steps
        # the admission estimator's step time: an EWMA of measured steps
        # that survives reset_stats (the watchdog's is renewed there)
        self._step_time = 0.0
        self._rate_buckets: Dict[str, TokenBucket] = {}
        if ec.tenant_quotas:
            self.sched.weights = {t: q.weight
                                  for t, q in ec.tenant_quotas.items()}
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(ec.seed)
        self._defer_steps = 0
        # bytes one cache position costs to read across all attention
        # layers: K + V (+ their fp32 scales under int8 KV); position
        # leaves are (pages or slots, positions, ...) in both pools, and
        # recurrent state (no positions) does not count. Under a mesh the
        # pool here is rank 0's Hkv shard and every rank holds as much:
        # these are aggregate bytes, kv_bytes_read_device one rank's
        self._kv_row_bytes = self.tp * sum(
            layer[key][0, 0].numel() * layer[key].element_size()
            for layer, keys in zip(self.pool.cache, self.pool.position_keys)
            for key in keys)
        # per-slot decode-state rows (host-side mirrors of the ragged batch)
        self._tokens = np.zeros((ec.n_slots, 1), np.int32)
        self._temps = np.zeros((ec.n_slots,), np.float32)
        self._topks = np.zeros((ec.n_slots,), np.int32)
        self.stats: Dict[str, Any] = {}
        self.reset_stats()
        # every terminal transition passes through the scheduler's hook, so
        # per-tenant counters cannot drift from the finished list
        self.sched.on_terminal = self._account_terminal

    @property
    def clock(self) -> Callable[[], float]:
        """The clock deadlines, timestamps, quotas and the watchdog read
        (``time.perf_counter`` unless the engine was given one)."""
        return self._clock

    # -- request intake ----------------------------------------------------

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0,
               eos_id: Optional[int] = None, arrival_time: float = 0.0,
               deadline_s: float = 0.0, priority: int = 0,
               tenant: str = "") -> int:
        """Enqueue a request; returns its rid. A request the engine can
        NEVER seat (slot capacity / page pool too small) is retired at once
        as REJECTED — the rid still comes back. ``deadline_s`` > 0 arms a
        deadline on the engine clock, measured from this submit: past it
        the request retires as TIMEOUT, waiting or mid-decode.
        ``priority`` picks the QoS tier: higher tiers are admitted first
        (FCFS within a tier) and lower tiers are preferred as shedding and
        preemption victims. ``tenant`` names the quota and fair-queueing
        bucket: an over-quota submit is REJECTED with a computed
        ``retry_after_s``, and with ``slo_admission`` a deadline the
        occupancy simulation proves unmakeable is rejected here.
        Thread-safe."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        with self._elock:
            req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                          temperature=temperature, top_k=top_k,
                          eos_id=eos_id, arrival_time=arrival_time,
                          deadline_s=float(deadline_s),
                          priority=int(priority), tenant=str(tenant),
                          submit_time=self._clock())
            self._tenant_stats(req.tenant)["submitted"] += 1
            # speculative headroom: the verify dispatch writes up to spec_k
            # draft K/V rows past the commit frontier before rollback
            total = prompt.size + max_new_tokens + self._headroom()
            if total > self.ec.capacity:
                self.stats["rejected"] += 1
                return self.sched.reject(
                    req, f"prompt_len {prompt.size} + max_new_tokens "
                         f"{max_new_tokens}"
                         + (f" + spec_k {self.ec.spec_k}" if self.spec
                            else "")
                         + f" exceeds slot capacity {self.ec.capacity}")
            if self.paged:
                need = self.pool.pages_needed(total)
                if need > self.pool.n_pages - 1:
                    self.stats["rejected"] += 1
                    return self.sched.reject(
                        req, f"request needs {need} KV pages but the pool "
                             f"only has {self.pool.n_pages - 1} allocatable "
                             f"pages")
            reason = self._quota_check_locked(req)
            if reason is not None:
                self.stats["rejected"] += 1
                self.stats["quota_rejected"] += 1
                return self.sched.reject(req, reason)
            if self.ec.slo_admission and req.deadline_s > 0:
                reason = self._slo_check_locked(req)
                if reason is not None:
                    self.stats["rejected"] += 1
                    self.stats["slo_rejected"] += 1
                    req.retry_after_s = self._drain_estimate_locked()
                    return self.sched.reject(req, reason)
            rid = self.sched.submit(req)
            if (self.ec.max_waiting
                    and len(self.sched.waiting) > self.ec.max_waiting):
                # load shedding: the lowest-tier waiting request least
                # likely to make its deadline — earliest absolute deadline
                # within the tier (none sorts last), oldest rid on ties
                victim = min(
                    self.sched.waiting,
                    key=lambda r: (r.priority,
                                   (r.submit_time + r.deadline_s)
                                   if r.deadline_s > 0 else float("inf"),
                                   r.rid))
                victim.retry_after_s = self._drain_estimate_locked()
                self.sched.drop_waiting(victim, REJECTED,
                                        "shed: waiting queue full")
                self.stats["shed"] += 1
            return rid

    # -- SLO-aware admission and per-tenant quotas -------------------------

    def _quota(self, tenant: str) -> Optional[TenantQuota]:
        if self.ec.tenant_quotas and tenant in self.ec.tenant_quotas:
            return self.ec.tenant_quotas[tenant]
        return self.ec.default_tenant_quota

    def _tenant_stats(self, tenant: str) -> Dict[str, Any]:
        key = tenant or "default"
        ts = self.stats["tenants"].get(key)
        if ts is None:
            ts = self.stats["tenants"][key] = dict(
                submitted=0, finished=0, rejected=0, timeout=0,
                cancelled=0, failed=0, tokens=0, goodput_tokens=0)
        return ts

    def _account_terminal(self, req: Request) -> None:
        """The scheduler's ``on_terminal`` hook: per-tenant counters and the
        prompt tokens whose prefill was paid for a request that never
        delivered (``wasted_prefill_tokens``)."""
        ts = self._tenant_stats(req.tenant)
        key = req.status.lower()
        ts[key] = ts.get(key, 0) + 1
        ts["tokens"] += len(req.generated)
        if req.status == FINISHED:
            ts["goodput_tokens"] += len(req.generated)
        elif req.admit_time > 0 or req.status == FAILED:
            self.stats["wasted_prefill_tokens"] += req.prompt_len

    def _live_requests(self) -> List[Request]:
        return (list(self.sched.active.values()) + list(self.sched.waiting)
                + list(self.sched.paused.values()))

    def _quota_check_locked(self, req: Request) -> Optional[str]:
        """A rejection reason if the tenant is over quota (``req.
        retry_after_s`` then holds the computed backoff), else None."""
        quota = self._quota(req.tenant)
        if quota is None:
            return None
        live = [r for r in self._live_requests() if r.tenant == req.tenant]
        if quota.max_concurrent > 0 and len(live) >= quota.max_concurrent:
            req.retry_after_s = self._drain_estimate_locked()
            return (f"tenant {req.tenant or 'default'!r} at its concurrent-"
                    f"request quota ({quota.max_concurrent})")
        if quota.max_pages > 0 and self.paged:
            held = sum(self.pool.pages_needed(
                r.prompt_len - r.folded + r.max_new_tokens
                + self._headroom()) for r in live)
            need = self.pool.pages_needed(
                req.prompt_len + req.max_new_tokens + self._headroom())
            if held + need > quota.max_pages:
                req.retry_after_s = self._drain_estimate_locked()
                return (f"tenant {req.tenant or 'default'!r} over its KV "
                        f"page budget ({held} held + {need} needed > "
                        f"{quota.max_pages})")
        bucket = self._rate_buckets.get(req.tenant)
        if bucket is None:
            bucket = self._rate_buckets[req.tenant] = TokenBucket(
                quota.rate, quota.burst, clock=self._clock)
        if not bucket.try_take():
            req.retry_after_s = bucket.next_free_s()
            return (f"tenant {req.tenant or 'default'!r} rate-limited "
                    f"({quota.rate:g} req/s, burst {quota.burst})")
        return None

    def _admission_step_time(self) -> float:
        return (self.ec.slo_step_time if self.ec.slo_step_time > 0
                else self._step_time)

    def _seat_steps_locked(self, ahead: List[Request]) -> float:
        """Steps until a slot frees for a request behind ``ahead``, plus
        the backfill-defer allowance."""
        running = [request_work_steps(r.prompt_len, r.folded,
                                      r.max_new_tokens, len(r.generated)) - 1
                   for r in self.sched.active.values()]
        costs = [request_work_steps(w.prompt_len, w.folded,
                                    w.max_new_tokens, len(w.generated))
                 for w in ahead]
        seat = estimate_seat_steps(self.sched.free_slots(), running, costs)
        return seat + self.ec.backfill_max_defer

    def _drain_estimate_locked(self) -> float:
        """Seconds until a NEW request at the back of the whole queue could
        seat: the occupancy-derived Retry-After (0 while the step time is
        uncalibrated)."""
        st = self._admission_step_time()
        if st <= 0:
            return 0.0
        return self._seat_steps_locked(list(self.sched.waiting)) * st

    def _slo_check_locked(self, req: Request) -> Optional[str]:
        """A rejection reason when the occupancy simulation proves ``req``
        cannot finish inside ``deadline_s × slo_slack``, else None. An
        uncalibrated step time admits everything; a prefix-cache hit
        discounts the prefill term."""
        st = self._admission_step_time()
        if st <= 0:
            return None
        ahead = [w for w in self.sched.waiting
                 if w.priority >= req.priority]
        seat = self._seat_steps_locked(ahead)
        prefill = 1.0
        if self.prefix_cache:
            hit, _ = self.pool.match_prefix(req.prompt)
            if hit:
                prefill = max(0.25, (req.prompt_len - hit)
                              / max(1, req.prompt_len))
        est_ttft = (seat + prefill) * st
        est_finish = (seat + prefill + req.max_new_tokens) * st
        if est_finish > req.deadline_s * max(self.ec.slo_slack, 1e-6):
            return (f"slo: estimated finish {est_finish:.3f}s (ttft "
                    f"{est_ttft:.3f}s) exceeds deadline "
                    f"{req.deadline_s:g}s at current occupancy")
        return None

    def retry_after_estimate(self) -> float:
        """Occupancy-derived drain estimate in seconds for an arriving
        request (0 when uncalibrated). Thread-safe."""
        with self._elock:
            return self._drain_estimate_locked()

    def pause(self, rid: int) -> bool:
        """Park a live request: a running one folds its generated tokens
        into its prompt and releases its slot and pages; a waiting one
        leaves the queue. It keeps its rid and deadline, can still be
        cancelled or time out, and :meth:`resume` re-enqueues it. Returns
        True if the rid was live. Thread-safe."""
        with self._elock:
            for slot, req in list(self.sched.active.items()):
                if req.rid == rid:
                    self._fold(req)
                    self._release(slot)
                    self.sched.pause(slot)
                    self.stats["paused"] += 1
                    return True
            for req in list(self.sched.waiting):
                if req.rid == rid:
                    self.sched.pause_waiting(req)
                    self.stats["paused"] += 1
                    return True
            return False

    def resume(self, rid: int) -> bool:
        """Re-enqueue a paused request. Thread-safe."""
        with self._elock:
            if self.sched.resume(rid) is None:
                return False
            self.stats["resumed"] += 1
            return True

    def reap(self) -> int:
        """Expire deadlines without running a step (parked requests produce
        no steps). Returns how many expired."""
        with self._elock:
            return len(self._expire_deadlines())

    def cancel(self, rid: int) -> Optional[Request]:
        """Cancel a request by rid, waiting, running or paused: a running
        request's slot retires at once and its pages and prefix refcounts
        release. Returns the request (now CANCELLED), or None if the rid is
        not live, so a cancel racing completion is a no-op. Thread-safe."""
        with self._elock:
            for slot, req in list(self.sched.active.items()):
                if req.rid == rid:
                    self._release(slot)
                    self.stats["cancelled"] += 1
                    return self.sched.retire(slot, CANCELLED)
            for req in list(self.sched.waiting):
                if req.rid == rid:
                    self.stats["cancelled"] += 1
                    return self.sched.drop_waiting(req, CANCELLED)
            req = self.sched.drop_paused(rid, CANCELLED)
            if req is not None:
                self.stats["cancelled"] += 1
            return req

    # -- cross-thread hooks ------------------------------------------------

    def stats_snapshot(self) -> Dict[str, Any]:
        """A consistent copy of ``stats`` for a concurrent reader, taken
        under the engine lock; slot occupancy is summarized as its mean,
        per-tenant counters are copied, and the live queue depths and the
        drain estimate (``retry_after_est_s``) ride along."""
        with self._elock:
            snap: Dict[str, Any] = {}
            for k, v in self.stats.items():
                if k == "slot_occupancy":
                    snap["slot_occupancy_mean"] = (
                        float(np.mean(v)) if v else 0.0)
                elif isinstance(v, list):
                    snap[k] = list(v)
                elif isinstance(v, dict):
                    snap[k] = {kk: dict(vv) for kk, vv in v.items()}
                else:
                    snap[k] = v
            snap["active"] = len(self.sched.active)
            snap["waiting"] = len(self.sched.waiting)
            snap["paused_now"] = len(self.sched.paused)
            snap["retry_after_est_s"] = self._drain_estimate_locked()
            return snap

    def poll(self, cursor: int = 0, trim: bool = False
             ) -> Tuple[int, List[Tuple[int, List[int]]],
                        List[Tuple[int, List[int], str, str, float]]]:
        """One-lock progress snapshot: ``(new_cursor, live, fin)``, with
        ``live`` the ``(rid, generated)`` of every waiting, running or
        paused request and ``fin`` the ``(rid, generated, status, error,
        retry_after_s)`` of each terminal request past ``cursor``. Token
        lists are copies. ``trim=True`` drops the consumed finished entries
        (the returned cursor is then 0)."""
        with self._elock:
            fin = [(r.rid, list(r.generated), r.status, r.error,
                    r.retry_after_s)
                   for r in self.sched.finished[cursor:]]
            live = [(r.rid, list(r.generated))
                    for r in (list(self.sched.active.values())
                              + list(self.sched.waiting)
                              + list(self.sched.paused.values()))]
            if trim:
                del self.sched.finished[cursor:]
                return 0, live, fin
            return len(self.sched.finished), live, fin

    def shed_waiting(self, reason: str) -> List[Request]:
        """Drop every waiting and paused request as REJECTED (graceful
        drain: running requests finish). Returns them."""
        with self._elock:
            dropped: List[Request] = []
            for req in list(self.sched.waiting):
                dropped.append(self.sched.drop_waiting(req, REJECTED, reason))
                self.stats["shed"] += 1
            for rid in list(self.sched.paused):
                dropped.append(self.sched.drop_paused(rid, REJECTED, reason))
                self.stats["shed"] += 1
            return dropped

    def recover(self) -> int:
        """Bring the scheduler and pool back to a consistent state after
        ``step()`` raised, without rebuilding the engine: every running
        request is folded (its generated tokens join its prompt, so the
        re-prefill replays them), released and requeued at the front in
        reverse admission order (FCFS kept); the prefix index is reset and
        the stall/defer counters cleared. Returns the survivor count."""
        with self._elock:
            survivors = sorted(self.sched.active.items(),
                               key=lambda kv: (kv[1].admit_time, kv[1].rid),
                               reverse=True)
            for slot, req in survivors:
                self._fold(req)
                self._release(slot)
                self.sched.requeue(slot)
            if self.prefix_cache:
                self.pool.reset_prefix()
            self._stall_steps = 0
            self._defer_steps = 0
            self.stats["recoveries"] += 1
            return len(survivors)

    # -- internals ---------------------------------------------------------

    def _bucket(self, n: int) -> int:
        if not self.pad_prefill:
            return n
        return prefill_bucket(n, self.ec.min_bucket, self.ec.capacity,
                              flash_chunks(self.cfg))

    def _chunks_fit(self, s: int) -> bool:
        return chunks_fit(s, s, self.cfg.q_chunk, self.cfg.kv_chunk)

    def _buckets(self) -> List[int]:
        """Every prefill length :meth:`_bucket` can return."""
        out, n = [], 1
        while True:
            b = self._bucket(n)
            out.append(b)
            if b >= self.ec.capacity:
                return out
            n = b + 1

    def _row_tiers(self) -> List[int]:
        """Admission-batch row counts: powers of two up to ``n_slots`` (plus
        ``n_slots`` itself), as in the reference."""
        tiers, t = [], 1
        while t < self.ec.n_slots:
            tiers.append(t)
            t *= 2
        tiers.append(self.ec.n_slots)
        return tiers

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _sample(self, logits: torch.Tensor, temps: np.ndarray,
                topks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Sample (B, V) logits; returns host (tokens, finite-row flags) in
        one transfer. An all-greedy batch skips the sampler."""
        if temps.any():
            tok = sample_tokens(logits, self._gen, self._tensor(temps),
                                self._tensor(topks),
                                use_topk=bool(topks.any()))
        else:
            tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        ok = torch.isfinite(logits).all(dim=-1).to(torch.int32)
        both = torch.stack([tok, ok]).cpu().numpy()
        return both[0], both[1].astype(bool)

    def _finish_admission(self, group: List, tok: np.ndarray,
                          ok: np.ndarray) -> List[Request]:
        """Post-dispatch bookkeeping shared by both admission paths: record
        the prefill-sampled first token and the timing, and publish the
        full prompt pages into the prefix index. A row whose logits came
        back non-finite retires as FAILED here: no token is recorded and
        its prompt never enters the index. Returns the failed requests."""
        now = self._clock()
        failed: List[Request] = []
        alive: List = []
        for i, (req, slot) in enumerate(group):
            self._temps[slot] = req.temperature
            self._topks[slot] = req.top_k
            if not ok[i]:
                req.error = "non-finite logits at prefill"
                self._release(slot)
                failed.append(self.sched.retire(slot, FAILED))
                self.stats["failed"] += 1
                continue
            req.admit_time = now
            if req.first_token_time == 0.0:
                # kept across preemption re-admissions: TTFT measures the
                # first first-token, not the re-prefill's
                req.first_token_time = now
            req.generated.append(int(tok[i]))
            req.token_times.append(now)
            self._tokens[slot, 0] = int(tok[i])
            self.stats["tokens_generated"] += 1
            if self.prefix_cache:
                self.pool.register_prefix(slot, req.prompt)
            alive.append((req, slot))
        if self.spec and alive:
            # the drafter has no prefix cache: prefix-hit admissions
            # prefill their whole prompt on its side too
            self.drafter.admit(alive)
        return failed

    def _admit_group(self, group: List) -> List[Request]:
        """ONE prefill for a batch of admissions. Prompts are right-padded
        to the largest member's bucket and rows to the next tier; pad rows
        alias the group's first slot but carry zero table rows, so their
        KV lands in the null page. The token mask keeps pad positions and
        rows out of MoE expert capacity."""
        k = len(group)
        bucket = max(self._bucket(req.prompt_len) for req, _ in group)
        k_pad = next(t for t in self._row_tiers() if t >= k)
        toks = np.zeros((k_pad, bucket), np.int32)
        lens = np.ones((k_pad,), np.int32)
        temps = np.zeros((k_pad,), np.float32)
        topks = np.zeros((k_pad,), np.int32)
        slots = np.zeros((k_pad,), np.int32)
        mask = np.zeros((k_pad, bucket), bool)
        for i, (req, slot) in enumerate(group):
            p = req.prompt_len
            toks[i, :p] = req.prompt
            lens[i] = p
            mask[i, :p] = True
            temps[i] = req.temperature
            topks[i] = req.top_k
            slots[i] = slot
        slots[k:] = slots[0]
        logits, pcache = self.fns.prefill(
            self.params, {"tokens": self._tensor(toks),
                          "length": self._tensor(lens),
                          "token_mask": self._tensor(mask)})
        tok, ok = self._sample(logits[:, -1], temps, topks)
        self.pool.insert_rows(pcache, slots, lens[:k])
        self.stats["prefills"] += 1
        self.stats["prefill_rows"] += k
        return self._finish_admission(group, tok, ok)

    def _admit_group_append(self, group: List) -> List[Request]:
        """ONE prefill-append dispatch for a batch of prefix-hit
        admissions: only each request's uncached suffix is computed,
        attending to its adopted prefix pages through the block tables.
        Suffixes are right-padded to a power-of-two bucket and rows to the
        tier; pad rows carry all-zero tables, ``prefix_len`` 0 and suffix
        length 1, so their K/V lands in the null page. Before the dispatch
        every shared partial final page is copied (one batched copy on the
        same stream) and the suffix pages are allocated, so the tables are
        final."""
        k = len(group)
        bucket = max(self._bucket(req.prompt_len - req.prefix_hit)
                     for req, _ in group)
        k_pad = next(t for t in self._row_tiers() if t >= k)
        toks = np.zeros((k_pad, bucket), np.int32)
        plens = np.zeros((k_pad,), np.int32)
        slens = np.ones((k_pad,), np.int32)
        temps = np.zeros((k_pad,), np.float32)
        topks = np.zeros((k_pad,), np.int32)
        slots = np.zeros((k_pad,), np.int32)
        cow: List = []
        for i, (req, slot) in enumerate(group):
            hit, p = req.prefix_hit, req.prompt_len
            toks[i, :p - hit] = req.prompt[hit:]
            plens[i] = hit
            slens[i] = p - hit
            temps[i] = req.temperature
            topks[i] = req.top_k
            slots[i] = slot
            if hit % self.pool.page_size:
                # the suffix starts inside an adopted (shared) page
                pair = self.pool.ensure_writable(slot, hit)
                if pair is not None:
                    cow.append(pair)
            self.pool.ensure(slot, p)
        if cow:
            src, dst = zip(*cow)
            self.pool.copy_pages(np.asarray(src), np.asarray(dst))
        # pow2 table width covering the widest member's prompt pages
        need = max(self.pool.pages_needed(req.prompt_len)
                   for req, _ in group)
        w = 1
        while w < need:
            w *= 2
        w = min(w, self.pool.max_pages)
        bt = np.zeros((k_pad, w), np.int32)
        bt[:k] = self.pool.table[slots[:k], :w]
        logits, self.pool.cache = self.fns.prefill_append(
            self.params, {"tokens": self._tensor(toks),
                          "prefix_len": self._tensor(plens),
                          "length": self._tensor(slens),
                          "block_tables": self._tensor(bt)},
            self.pool.cache)
        tok, ok = self._sample(logits[:, -1], temps, topks)
        for req, slot in group:
            self.pool.lens[slot] = req.prompt_len
        self.stats["prefills"] += 1
        self.stats["prefill_rows"] += k
        self.stats["prefix_hit_tokens"] += int(sum(r.prefix_hit
                                                   for r, _ in group))
        return self._finish_admission(group, tok, ok)

    def _should_admit(self) -> bool:
        """Chunked-backfill hysteresis: admit at once when idle or when a
        full chunk can be seated; otherwise defer up to
        ``backfill_max_defer`` decode steps."""
        ready = min(self.sched.free_slots(), len(self.sched.waiting))
        if ready == 0:
            return False
        chunk = max(1, min(self.ec.backfill_chunk, self.ec.n_slots))
        if chunk <= 1 or not self.sched.active or ready >= chunk:
            return True
        if self._defer_steps >= self.ec.backfill_max_defer:
            return True
        self._defer_steps += 1
        self.stats["deferred_admissions"] += 1
        return False

    def step(self) -> List[Request]:
        """One engine iteration; returns every request that reached a
        terminal status this step (FINISHED, but also TIMEOUT, CANCELLED
        and FAILED: check ``Request.status``). Holds the engine lock for the
        whole iteration."""
        with self._elock:
            return self._step()

    def _step(self) -> List[Request]:
        self._step_idx += 1
        t_step = self._clock()
        finished: List[Request] = []
        faults = self.faults
        if faults is not None:
            faults.maybe_sleep(self._step_idx)
            if faults.fires(self._step_idx, "shard_skew"):
                # one rank running slow: the ranks move in lockstep (every
                # gather waits for all of them), so the whole step stalls
                # for the skewed rank's delay — an engine-level sleep is the
                # exact observable effect; `choose` records which rank
                shard = faults.choose(max(self.tp, 1))
                faults.record(self._step_idx, "shard_skew", shard)
                faults.sleep(faults.arg(self._step_idx, "shard_skew")
                             or 0.02)
            if faults.fires(self._step_idx, "cancel"):
                live = sorted([r.rid for r in self.sched.active.values()]
                              + [r.rid for r in self.sched.waiting])
                if live:
                    rid = live[faults.choose(len(live))]
                    faults.record(self._step_idx, "cancel", rid)
                    req = self.cancel(rid)
                    if req is not None:
                        finished.append(req)
        finished.extend(self._expire_deadlines())

        admitted = (self.sched.admit(self.ec.max_admit_per_step)
                    if self._should_admit() else [])
        stalled = False
        if admitted and self.paged:
            # page-budget admission control, strict FCFS: the first request
            # that does not fit requeues itself and everything behind it,
            # even when a later prefix hit would fit the leftover budget
            fit = len(admitted)
            if faults is not None and faults.fires(self._step_idx,
                                                   "page_alloc"):
                # injected allocator failure: the whole wave stalls
                faults.record(self._step_idx, "page_alloc")
                fit = 0
            else:
                for i, (req, slot) in enumerate(admitted):
                    # folded tokens are part of the prompt now, but only
                    # max_new_tokens - folded generations remain: the total
                    # is invariant across folds
                    total = (req.prompt_len - req.folded
                             + req.max_new_tokens + self._headroom())
                    if self.prefix_cache:
                        hit = self.pool.admit_prefix(slot, req.prompt, total)
                        if hit is None:
                            fit = i
                            break
                        req.prefix_hit = hit
                        self.stats["pages_shared"] += -(-hit
                                                        // self.pool.page_size)
                    elif not self.pool.reserve(slot, total):
                        fit = i
                        break
            for req, slot in reversed(admitted[fit:]):
                self.sched.requeue(slot)
                self.stats["page_stalls"] += 1
            stalled = fit == 0
            admitted = admitted[:fit]
        if stalled and self.ec.preempt_after_stalls > 0:
            # page-pressure preemption: once the FCFS head has stalled past
            # the budget, evict the youngest running request so the head
            # can seat next step
            self._stall_steps += 1
            if (self._stall_steps > self.ec.preempt_after_stalls
                    and self.sched.active):
                self._preempt_youngest()
                self._stall_steps = 0
        elif admitted or not self.sched.waiting:
            self._stall_steps = 0
        if admitted:
            self._defer_steps = 0
            hits = [(r, s) for r, s in admitted if r.prefix_hit > 0]
            cold = [(r, s) for r, s in admitted if r.prefix_hit == 0]
            if hits:
                finished.extend(self._admit_group_append(hits))
            if cold and self.pad_prefill:
                # padded families: ONE merged dispatch for the whole batch
                # of admissions, whatever their prompt lengths
                finished.extend(self._admit_group(cold))
            elif cold:
                # exact-length families (MoE): one dispatch per prompt
                # length, in order of first appearance
                groups: Dict[int, List] = {}
                for req, slot in cold:
                    groups.setdefault(req.prompt_len, []).append((req, slot))
                for group in groups.values():
                    finished.extend(self._admit_group(group))

        # requests whose first (prefill-sampled) token already completed them
        for slot, req in list(self.sched.active.items()):
            if req.is_finished():
                self._release(slot)
                finished.append(self.sched.retire(slot))
        if not self.sched.active:
            self._finish_step(t_step)
            return finished

        self.stats["slot_occupancy"].append(len(self.sched.active))
        if self.spec:
            finished.extend(self._spec_step())
            self._finish_step(t_step)
            return finished
        if self.paged:
            bt = self._prepare_paged_writes(
                {slot: int(self.pool.lens[slot]) + 1
                 for slot in self.sched.active}, extra=1)
        else:
            # capacity-dense decode reads every slot's capacity rows
            bt = None
            rows = self.ec.n_slots * self.ec.capacity
            self.stats["kv_bytes_read"] += rows * self._kv_row_bytes
            self.stats["kv_bytes_read_live"] += rows * self._kv_row_bytes
            self.stats["kv_bytes_read_device"] += per_device_kv_bytes(
                rows * self._kv_row_bytes, self.tp)
        # free slots are garbage rows: lens > 0 marks a live request, and
        # only live rows may claim MoE expert capacity
        logits, self.pool.cache = self.fns.decode_step(
            self.params, {"tokens": self._tensor(self._tokens),
                          "cache_len": self._tensor(self.pool.lens),
                          "block_tables": bt,
                          "token_mask": self._tensor(
                              self.pool.lens > 0)[:, None]},
            self.pool.cache)
        next_tok, ok = self._sample(logits[:, -1], self._temps, self._topks)
        if faults is not None and faults.fires(self._step_idx, "nan_logits"):
            slots_live = sorted(self.sched.active)
            victim = slots_live[faults.choose(len(slots_live))]
            faults.record(self._step_idx, "nan_logits", victim)
            ok[victim] = False
        now = self._clock()
        self.stats["decode_steps"] += 1
        for slot, req in list(self.sched.active.items()):
            if not ok[slot]:
                # containment: fail only the poisoned row; its token is
                # garbage, so nothing is emitted and the slot retires
                req.error = "non-finite logits at decode"
                self._release(slot)
                finished.append(self.sched.retire(slot, FAILED))
                self.stats["failed"] += 1
                continue
            tok = int(next_tok[slot])
            req.generated.append(tok)
            req.token_times.append(now)
            self.pool.advance(slot)
            self._tokens[slot, 0] = tok
            self.stats["tokens_generated"] += 1
            if req.is_finished():
                self._release(slot)
                finished.append(self.sched.retire(slot))
        self._finish_step(t_step)
        return finished

    def _finish_step(self, t_start: float) -> None:
        """End-of-step bookkeeping on every return path: mirror the paged
        pool's counters, feed the step's duration to the watchdog and to
        the admission estimator's step-time EWMA."""
        if self.paged:
            for key in ("evictions", "pages_allocated", "cow_copies"):
                self.stats[key] = self.pool.stats[key]
        dt = self._clock() - t_start
        if self._watchdog is not None:
            self._watchdog.record(dt)
            self.stats["watchdog_slow_steps"] = self._watchdog.slow_steps
            self.stats["step_time_ewma"] = self._watchdog.ewma
        self._step_time = (dt if self._step_time <= 0
                           else 0.8 * self._step_time + 0.2 * dt)

    def _headroom(self) -> int:
        return self.ec.spec_k if self.spec else 0

    def _release(self, slot: int) -> None:
        """Free a slot's pool rows or pages and, under speculation, the
        drafter's row: every retire, cancel, pause, preemption, recovery
        and failure path goes through here, so the slot's next tenant
        finds the drafter at length 0."""
        self.pool.release(slot)
        if self.spec:
            self.drafter.release(slot)

    def _prepare_paged_writes(self, write_lens: Dict[int, int],
                              extra: int) -> torch.Tensor:
        """Page bookkeeping before a paged dispatch: every page a slot's
        write frontier will touch is allocated (from its reservation), and
        with prefix sharing the page holding the first written position
        must be private — admission's CoW already guarantees that, so this
        is an invariant check that copies any straggler. Returns the device
        block tables at the pow2 width covering ``len + extra`` and counts
        the step's live KV read traffic."""
        cow: List = []
        for slot, wlen in write_lens.items():
            self.pool.ensure(slot, wlen)
            if self.prefix_cache:
                pair = self.pool.ensure_writable(slot,
                                                 int(self.pool.lens[slot]))
                if pair is not None:
                    cow.append(pair)
        if cow:
            src, dst = zip(*cow)
            self.pool.copy_pages(np.asarray(src), np.asarray(dst))
        bt = self.pool.device_tables(self.pool.table_width(extra=extra))
        step_bytes = (bt.shape[1] * self.ec.page_size * self.ec.n_slots
                      * self._kv_row_bytes)
        self.stats["kv_bytes_read"] += step_bytes
        # under a mesh each rank reads only its Hkv slice of every page
        self.stats["kv_bytes_read_device"] += per_device_kv_bytes(
            step_bytes, self.tp)
        self.stats["kv_bytes_read_live"] += (self.pool.live_page_rows()
                                             * self._kv_row_bytes)
        return bt

    def _verify(self, toks: np.ndarray, plens: np.ndarray,
                slens: np.ndarray, bt: torch.Tensor, greedy_only: bool
                ) -> Tuple[np.ndarray, np.ndarray]:
        """The verify dispatch: ONE ``prefill_append`` over the pages with
        every suffix row's logits (row j: the target's distribution for the
        token after suffix position j). The finite check covers each slot's
        real rows only (rows past ``slens`` are pads). All-greedy steps
        copy the ``(B, S)`` argmaxes to the host with the flags; sampled
        steps copy the fp32 logit rows, which acceptance needs."""
        logits, self.pool.cache = self.fns.prefill_append(
            self.params, {"tokens": self._tensor(toks),
                          "prefix_len": self._tensor(plens),
                          "length": self._tensor(slens),
                          "block_tables": bt, "all_logits": True},
            self.pool.cache)
        slen = self._tensor(slens)
        pad = (torch.arange(logits.shape[1], device=self.device)[None, :]
               >= slen[:, None])
        ok = (torch.isfinite(logits).all(dim=2) | pad).all(dim=1)
        if greedy_only:
            amax = torch.argmax(logits.float(), dim=-1).to(torch.int32)
            both = torch.cat([amax, ok.to(torch.int32)[:, None]],
                             dim=1).cpu().numpy()
            return both[:, :-1], both[:, -1].astype(bool)
        return (logits.float().cpu().numpy(),
                ok.cpu().numpy().astype(bool))

    def _spec_step(self) -> List[Request]:
        """One draft→verify→accept iteration over every live slot.

        The drafter proposes up to ``spec_k`` tokens a slot; ONE verify
        dispatch scores the pending token plus every draft against the
        paged prefix; acceptance keeps the longest agreeing draft prefix
        and emits one more token from the target's own row, so each step
        commits 1..spec_k+1 tokens with plain decode's output
        distribution. Rejected drafts roll back by truncating the pool to
        the committed frontier: their pages were drawn this step and never
        shared, so they return to the slot's reservation."""
        active = sorted(self.sched.active.items())
        tlens = self.pool.lens.copy()
        faults = self.faults
        try:
            if faults is not None and faults.fires(self._step_idx,
                                                   "drafter"):
                faults.record(self._step_idx, "drafter")
                raise RuntimeError("injected drafter failure")
            proposals = self.drafter.propose(active, tlens, self.ec.spec_k,
                                             self._rng)
        except Exception:
            # drafter containment: a failed propose degrades this round to
            # a zero-draft verify, exactly a plain decode step; a drafter
            # whose state desynced keeps failing here and the engine stays
            # on 1-token steps instead of crashing. Output is unchanged.
            self.stats["drafter_failures"] += 1
            proposals = {slot: ([], None) for slot, _ in active}
        s_max = self.ec.spec_k + 1
        toks = np.zeros((self.ec.n_slots, s_max), np.int32)
        plens = np.zeros((self.ec.n_slots,), np.int32)
        slens = np.zeros((self.ec.n_slots,), np.int32)
        for slot, req in active:
            seq = [int(self._tokens[slot, 0])] + list(proposals[slot][0])
            toks[slot, :len(seq)] = seq
            plens[slot] = tlens[slot]
            slens[slot] = len(seq)
        bt = self._prepare_paged_writes(
            {slot: int(tlens[slot]) + int(slens[slot])
             for slot, _ in active}, extra=s_max)
        greedy_only = all(req.temperature <= 0 for _, req in active)
        out, ok = self._verify(toks, plens, slens, bt, greedy_only)
        if faults is not None and faults.fires(self._step_idx, "nan_logits"):
            victim = active[faults.choose(len(active))][0]
            faults.record(self._step_idx, "nan_logits", victim)
            ok[victim] = False
        now = self._clock()
        self.stats["decode_steps"] += 1
        self.stats["spec_steps"] += 1

        finished: List[Request] = []
        for slot, req in active:
            if not ok[slot]:
                # containment: every token this verify scored for the slot
                # is suspect — emit nothing, fail the request, release its
                # pages (the draft rows past the frontier too)
                req.error = "non-finite logits at verify"
                self._release(slot)
                finished.append(self.sched.retire(slot, FAILED))
                self.stats["failed"] += 1
                continue
            props, qrows = proposals[slot]
            n = len(props)
            if greedy_only:
                a, follow = accept_greedy(out[slot], props)
            else:
                a, follow = accept_draft(out[slot, :n + 1], props, qrows,
                                         req.temperature, req.top_k,
                                         self._rng)
            committed = 0
            for tok in props[:a] + [follow]:
                req.generated.append(int(tok))
                req.token_times.append(now)
                self.stats["tokens_generated"] += 1
                committed += 1
                if req.is_finished():
                    break
            # acceptance counts the drafts actually emitted: a request
            # finishing mid-block discards the accepted tail
            a_committed = min(committed, a)
            self.stats["draft_proposed"] += n
            self.stats["draft_accepted"] += a_committed
            self.stats["accepted_hist"][a_committed] += 1
            self._tokens[slot, 0] = req.generated[-1]
            new_len = int(tlens[slot]) + committed
            self.pool.truncate(slot, new_len)
            self.drafter.rollback(slot, new_len)
            if req.is_finished():
                self._release(slot)
                finished.append(self.sched.retire(slot))
        return finished

    def _expire_deadlines(self) -> List[Request]:
        """Retire every live request whose deadline has passed (TIMEOUT)."""
        out: List[Request] = []
        now = self._clock()
        for req in list(self.sched.waiting):
            if req.deadline_s > 0 and now > req.submit_time + req.deadline_s:
                out.append(self.sched.drop_waiting(
                    req, TIMEOUT, "deadline expired while queued"))
                self.stats["timeouts"] += 1
                self.stats["timeouts_waiting"] += 1
        for slot, req in list(self.sched.active.items()):
            if req.deadline_s > 0 and now > req.submit_time + req.deadline_s:
                req.error = "deadline expired mid-decode"
                self._release(slot)
                out.append(self.sched.retire(slot, TIMEOUT))
                self.stats["timeouts"] += 1
                self.stats["timeouts_running"] += 1
        for rid, req in list(self.sched.paused.items()):
            if req.deadline_s > 0 and now > req.submit_time + req.deadline_s:
                out.append(self.sched.drop_paused(
                    rid, TIMEOUT, "deadline expired while paused"))
                self.stats["timeouts"] += 1
                self.stats["timeouts_running"] += 1
        return out

    @staticmethod
    def _fold(req: Request) -> None:
        """Fold a request's generated-so-far tokens into its prompt, so a
        later re-prefill replays them and samples exactly the next token.
        ``prompt_len - folded + max_new_tokens`` is invariant across folds,
        so a folded request always re-fits eventually."""
        new = req.generated[req.folded:]
        if new:
            req.prompt = np.concatenate(
                [req.prompt, np.asarray(new, np.int32)])
            req.folded = len(req.generated)

    def _preempt_youngest(self) -> Request:
        """Page-pressure eviction: fold the victim's tokens into its
        prompt, release its slot and pages, and requeue it behind the
        stalled FCFS head. The victim is the youngest running request of
        the lowest priority tier."""
        slot, req = max(self.sched.active.items(),
                        key=lambda kv: (-kv[1].priority, kv[1].admit_time,
                                        kv[1].rid))
        self._fold(req)
        self._release(slot)
        self.stats["preemptions"] += 1
        return self.sched.preempt(slot)

    def check_conservation(self) -> None:
        """Check that nothing leaked once the engine drained: every slot
        free, no live request; on a paged pool every non-null page idle and
        the pool's refcounts, index and reservations consistent, on a
        capacity-dense one every length 0; the drafter's lengths 0."""
        with self._elock:
            if self.sched.active or self.sched.waiting or self.sched.paused:
                raise AssertionError("check_conservation() needs a drained "
                                     "engine")
            if self.sched.free_slots() != self.ec.n_slots:
                raise AssertionError("leaked slots")
            if self.paged:
                self.pool.check_consistency()
                idle = self.pool.idle_pages()
                if idle != self.pool.n_pages - 1:
                    raise AssertionError(f"leaked "
                                         f"{self.pool.n_pages - 1 - idle} "
                                         f"KV pages")
            elif self.pool.lens.any():
                raise AssertionError("leaked slot lengths")
            drafter_pool = getattr(self.drafter, "pool", None)
            if self.spec and drafter_pool is not None \
                    and drafter_pool.lens.any():
                raise AssertionError("leaked drafter slot lengths")

    def close(self) -> None:
        """Release the other ranks' shards of a tensor-parallel engine and,
        when the engine started its own model group, stop its ranks. The
        engine serves no further step. Nothing to do at mesh 1."""
        group, self.group = self.group, None
        if group is None or group.closed:
            return
        if self._owns_group:
            group.close()
        else:
            group.send("unload")

    # -- convenience -------------------------------------------------------

    def reset_stats(self) -> None:
        with self._elock:
            self.stats.clear()
            self.stats.update(decode_steps=0, prefills=0, prefill_rows=0,
                              deferred_admissions=0, tokens_generated=0,
                              page_stalls=0, kv_bytes_read=0,
                              kv_bytes_read_live=0, kv_bytes_read_device=0,
                              slot_occupancy=[], prefix_hit_tokens=0,
                              pages_shared=0, cow_copies=0, evictions=0,
                              pages_allocated=0, spec_steps=0,
                              draft_proposed=0, draft_accepted=0,
                              accepted_hist=[0] * (self.ec.spec_k + 1),
                              preemptions=0, shed=0,
                              rejected=0, timeouts=0, cancelled=0, failed=0,
                              drafter_failures=0,
                              recoveries=0, watchdog_slow_steps=0,
                              step_time_ewma=0.0, slo_rejected=0,
                              quota_rejected=0, timeouts_waiting=0,
                              timeouts_running=0, wasted_prefill_tokens=0,
                              paused=0, resumed=0, tenants={})
            # a fresh watchdog per reset: earlier steps must not seed the
            # EWMA the next window is judged against
            self._watchdog = (
                StepWatchdog(threshold=self.ec.watchdog_threshold)
                if self.ec.watchdog_threshold > 0 else None)
            if self.paged:
                self.pool.reset_stats()

    def _pow2_widths(self) -> List[int]:
        """Every block-table width the pow2 bucketing can hand a paged
        dispatch (decode, verify and prefill-append bucket alike)."""
        widths, w = [], 1
        while True:
            widths.append(min(w, self.pool.max_pages))
            if w >= self.pool.max_pages:
                return widths
            w *= 2

    def _load_kernels(self) -> None:
        """Build (one ``nvcc`` per missing source, all started together) and
        load every kernel library this configuration launches: the BCR
        matmuls always, paged attention on a paged pool, flash under a
        flash ``attn_impl``."""
        from repro_torch.kernels import (bcr_spmm, build, flash_attention,
                                         paged_decode_attention)
        libs = {"bcr_spmm": bcr_spmm.library}
        if self.paged:
            libs["paged_attention"] = paged_decode_attention.library
        if self.cfg.attn_impl in FLASH_ATTN_IMPLS:
            libs["flash_attention"] = flash_attention.library
        build.build_all(sorted(libs))
        for library in libs.values():
            library()

    def warmup(self, prompt_lens: Sequence[int], gen: int = 2,
               suffix_lens: Optional[Sequence[int]] = None) -> None:
        """Make every kernel library and dispatch shape live before measured
        traffic, then wipe the bookkeeping, as the reference's ``warmup``
        compiles its programs ahead. On the card the libraries this
        configuration launches are built and loaded first; then throwaway
        requests run every (prefill bucket × admission row tier) — under the
        prefix cache the index is dropped after each, so every cold
        combination runs — and, with the prefix cache, a ``prefill_append``
        for every (suffix bucket × row tier × pow2 table width) over all-zero
        tables (``suffix_lens`` narrows the suffix buckets; default: the
        prompt buckets); on a paged pool the decode dispatch (or, under
        ``spec_k``, the verify dispatch) runs at every pow2 table width with
        both sample paths. All-zero tables route throwaway writes into the
        null page, and the sampled paths draw from a throwaway generator, so
        no later token changes. Each launching thread needs the engine's
        card as its current device; this one sets it for its own calls."""
        assert not self.sched.has_work(), "warmup() needs an idle engine"
        if self.device.type != "cuda":
            self._warmup(prompt_lens, gen, suffix_lens)
            return
        with torch.cuda.device(self.device):
            self._load_kernels()
            self._warmup(prompt_lens, gen, suffix_lens)
            torch.cuda.synchronize(self.device)

    def _warmup(self, prompt_lens: Sequence[int], gen: int,
                suffix_lens: Optional[Sequence[int]]) -> None:
        buckets = sorted({self._bucket(max(1, int(p))) for p in prompt_lens})
        lens = [min(b, self.ec.capacity - gen - self._headroom())
                for b in buckets]
        for n in lens:
            for tier in self._row_tiers():
                self.generate([np.zeros((n,), np.int32)] * tier,
                              max_new_tokens=gen)
                if self.prefix_cache:
                    # drop the throwaway prompts' index entries now: else
                    # every later generate hits and takes the append path,
                    # and the cold (bucket × tier) shapes never run
                    self.pool.reset_prefix()
        n = self.ec.n_slots
        gen_throwaway = torch.Generator(device=self.device)
        gen_throwaway.manual_seed(self.ec.seed)
        temps = self._tensor(np.ones((n,), np.float32))
        topks = self._tensor(np.ones((n,), np.int32))

        def sample_both(logits: torch.Tensor) -> None:
            for use_topk in (False, True):
                rows = logits.shape[0]
                sample_tokens(logits, gen_throwaway, temps[:rows],
                              topks[:rows], use_topk=use_topk)

        if self.prefix_cache:
            if suffix_lens is None:
                suffix_lens = buckets
            # a hit can shrink a prompt to any suffix and a group's bucket
            # is its widest member's: every pow2 bucket up to the largest
            top = max(self._bucket(max(1, int(s))) for s in suffix_lens)
            sbuckets, sb = [], self.ec.min_bucket
            while sb <= top:
                sbuckets.append(sb)
                sb *= 2
            for sb in sbuckets:
                for tier in self._row_tiers():
                    for w in self._pow2_widths():
                        logits, self.pool.cache = self.fns.prefill_append(
                            self.params,
                            {"tokens": self._tensor(
                                np.zeros((tier, sb), np.int32)),
                             "prefix_len": self._tensor(
                                 np.zeros((tier,), np.int32)),
                             "length": self._tensor(
                                 np.ones((tier,), np.int32)),
                             "block_tables": self._tensor(
                                 np.zeros((tier, w), np.int32))},
                            self.pool.cache)
                        self._sample(logits[:, -1], np.zeros((tier,),
                                                             np.float32),
                                     np.zeros((tier,), np.int32))
            self.pool.reset_prefix()
        if self.paged:
            lens0 = np.zeros((n,), np.int32)
            for w in self._pow2_widths():
                bt = self._tensor(np.zeros((n, w), np.int32))
                if self.spec:
                    # every speculative step is a verify dispatch
                    toks = np.zeros((n, self.ec.spec_k + 1), np.int32)
                    for greedy_only in (True, False):
                        self._verify(toks, lens0, lens0, bt, greedy_only)
                    continue
                logits, self.pool.cache = self.fns.decode_step(
                    self.params, {"tokens": self._tensor(lens0[:, None]),
                                  "cache_len": self._tensor(lens0),
                                  "block_tables": bt,
                                  "token_mask": self._tensor(
                                      lens0 > 0)[:, None]}, self.pool.cache)
                self._sample(logits[:, -1], np.zeros((n,), np.float32),
                             lens0)
                sample_both(logits[:, -1])
            if hasattr(self.drafter, "warmup"):
                self.drafter.warmup()
        self.sched.finished.clear()
        # warmup's steps paid first launches: worthless as the admission
        # estimator's calibration, so its EWMA starts from measured traffic
        self._step_time = 0.0
        self.reset_stats()

    def run(self) -> List[Request]:
        """Drain: step until queue and slots are empty; finished requests in
        completion order."""
        done: List[Request] = []
        while self.sched.has_work():
            done.extend(self.step())
        return done

    def generate(self, prompts: Sequence[Sequence[int]], *,
                 max_new_tokens: int = 16, temperature: float = 0.0,
                 top_k: int = 0, eos_id: Optional[int] = None
                 ) -> List[List[int]]:
        """Batch convenience: submit all prompts, drain, return generated
        token lists in submission order (empty for rejected requests)."""
        rids = [self.submit(p, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_k=top_k,
                            eos_id=eos_id) for p in prompts]
        by_rid = {r.rid: r for r in self.run()}
        return [by_rid[rid].generated if rid in by_rid else []
                for rid in rids]
