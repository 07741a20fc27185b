"""InferenceEngine: continuous-batching serving over (BCR-packed) params on a
block-paged KV pool — the subset of the reference engine that carries the
main serving path.

Each ``step()``:

  1. admits waiting requests into free slots under the page budget (strict
     FCFS: the first request the pool cannot cover requeues itself and
     everything behind it). All admissions of a step share ONE batched
     ``prefill`` (prompts right-padded to a power-of-two bucket, rows padded
     to a power-of-two tier) whose KV is seated into each slot's pages;
     steady-state backfills are chunked (``backfill_chunk``);
  2. runs ONE ``decode_step`` over the whole ragged slot batch with per-slot
     lengths and block tables sliced to the pow2-bucketed live width, so
     the paged attention kernel reads each slot's live pages only;
  3. samples per slot (greedy / temperature / top-k), advances lengths and
     retires finished requests.

Free slots ride along as garbage rows: their length is 0 and their table row
is zero, so their writes land in the null page and their output is dropped.

Quantized serving: ``kv_dtype="int8"`` stores the pool as int8 codes with
per-row, per-kv-head fp32 scales; ``weight_dtype="int8"`` quantizes the
packed tiles to int8 codes with one fp32 scale per tile at engine build.

Prefix cache (``prefix_cache=True``): admission matches each prompt against
the pool's content-addressed index, adopts the shared full-page prefix
(refcount bump, no recompute), copies a shared partial final page before
the suffix writes into it (copy-on-write) and runs ONE bucketed
``prefill_append`` for just the uncached suffixes, through the paged
attention kernel's prefill-append form. A step may run that dispatch and
one cold prefill.

Request lifecycle, as in the reference: per-request deadlines (TIMEOUT,
waiting or mid-decode), ``cancel``, ``pause``/``resume``, bounded-queue
shedding (``max_waiting``), page-pressure preemption
(``preempt_after_stalls``: the victim's tokens fold into its prompt and it
re-prefills), per-row NaN containment (a row whose sampled logits are not
finite retires as FAILED and emits nothing), ``recover()`` after a failed
step, an injectable clock, a step watchdog and a seeded fault injector
(``serving/faults.py``). One reentrant lock serializes every public entry
point, so other threads may submit and cancel against a stepping engine.

Not ported yet (each raises ``NotImplementedError`` when asked for):
speculative decoding, tensor parallelism and unpaged pools. SLO admission
and tenancy come in a later slice.
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
from repro_torch.kernels.flash_attention import chunks_fit
from repro_torch.kernels.plan import quantize_packed_params
from repro_torch.models.api import model_fns
from repro_torch.models.layers import FLASH_ATTN_IMPLS
from repro_torch.serving.faults import StepWatchdog
from repro_torch.serving.kv_slots import PagedSlotPool
from repro_torch.serving.scheduler import (CANCELLED, FAILED, REJECTED,
                                           TIMEOUT, Request, Scheduler)

PyTree = Any


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
    # block-paged KV (the only pool the port has so far): kv_pages None →
    # full provisioning; fewer pages oversubscribe the pool and admission
    # control requeues what the budget cannot cover
    page_size: int = 16
    kv_pages: Optional[int] = None
    # prefix sharing over the paged pool: admissions adopt cached full-page
    # prompt prefixes (refcounted, CoW on a shared partial final page) and
    # prefill only the uncached suffix; admitted prompts publish their full
    # pages into the pool's LRU-evicted prefix index
    prefix_cache: bool = False
    # chunked backfill: hold steady-state admissions until `backfill_chunk`
    # can be seated together (or `backfill_max_defer` decode steps pass, or
    # the engine is idle), then run ONE merged prefill for all of them
    backfill_chunk: int = 2
    backfill_max_defer: int = 2
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
    # reference options not ported yet: each raises NotImplementedError
    spec_k: int = 0
    mesh_model: int = 1

    def __post_init__(self):
        unported = [
            (self.page_size <= 0, "page_size=0 (unpaged pools)"),
            (self.spec_k > 0, "spec_k (speculative decoding)"),
            (self.mesh_model > 1, "mesh_model > 1 (tensor parallelism)"),
        ]
        for bad, what in unported:
            if bad:
                raise NotImplementedError(
                    f"{what} is not ported yet; it comes in a later slice of "
                    f"the port (see ROADMAP.md)")
        for name in ("kv_dtype", "weight_dtype"):
            if getattr(self, name) not in ("", "int8"):
                raise ValueError(f"unsupported {name} "
                                 f"{getattr(self, name)!r}")


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, params: PyTree,
                 ec: Optional[EngineConfig] = None, *, device="cuda",
                 clock: Optional[Callable[[], float]] = None):
        ec = ec or EngineConfig()
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine on "
                             f"{self.device}")
        if ec.kv_dtype:
            cfg = dataclasses.replace(cfg, kv_dtype=ec.kv_dtype)
        if ec.weight_dtype:
            # idempotent: packs quantized by pack_params stay as they are
            params = quantize_packed_params(params)
        self.cfg = cfg
        self.ec = ec
        self.params = params
        self.fns = model_fns(cfg)
        if cfg.attn_impl in FLASH_ATTN_IMPLS:
            bad = [b for b in self._buckets() if not self._chunks_fit(b)]
            if bad:
                raise ValueError(
                    f"prefill buckets {bad} do not split into the flash "
                    f"chunks q_chunk={cfg.q_chunk}, kv_chunk={cfg.kv_chunk}")
        self.pool = PagedSlotPool(self.fns.init_cache, ec.n_slots,
                                  ec.capacity, page_size=ec.page_size,
                                  n_pages=ec.kv_pages, device=self.device)
        self.sched = Scheduler(ec.n_slots)
        self.prefix_cache = bool(ec.prefix_cache)
        # one reentrant lock around every scheduler/pool mutation; reentrant
        # because step() itself cancels (fault injection)
        self._elock = threading.RLock()
        # deadlines, latency timestamps and the watchdog all read this
        # clock, so tests drive time deterministically (FakeClock)
        self._clock: Callable[[], float] = clock or time.perf_counter
        self.faults = ec.fault_injector
        self._step_idx = -1      # engine step counter (fault schedule index)
        self._stall_steps = 0    # consecutive fully page-stalled steps
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(ec.seed)
        self._defer_steps = 0
        # bytes one cache position costs to read across all layers: K + V
        # (+ their fp32 scales under int8 KV)
        self._kv_row_bytes = sum(
            leaf[0, 0].numel() * leaf.element_size()
            for layer in self.pool.cache for leaf in layer.values())
        # per-slot decode-state rows (host-side mirrors of the ragged batch)
        self._tokens = np.zeros((ec.n_slots, 1), np.int32)
        self._temps = np.zeros((ec.n_slots,), np.float32)
        self._topks = np.zeros((ec.n_slots,), np.int32)
        self.stats: Dict[str, Any] = {}
        self.reset_stats()

    # -- request intake ----------------------------------------------------

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0,
               eos_id: Optional[int] = None, arrival_time: float = 0.0,
               deadline_s: float = 0.0, priority: int = 0) -> int:
        """Enqueue a request; returns its rid. A request the engine can
        NEVER seat (slot capacity / page pool too small) is retired at once
        as REJECTED — the rid still comes back. ``deadline_s`` > 0 arms a
        deadline on the engine clock, measured from this submit: past it
        the request retires as TIMEOUT, waiting or mid-decode.
        ``priority`` picks the QoS tier: higher tiers are admitted first
        (FCFS within a tier) and lower tiers are preferred as shedding and
        preemption victims. Thread-safe."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        with self._elock:
            req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                          temperature=temperature, top_k=top_k,
                          eos_id=eos_id, arrival_time=arrival_time,
                          deadline_s=float(deadline_s),
                          priority=int(priority), submit_time=self._clock())
            total = prompt.size + max_new_tokens
            if total > self.ec.capacity:
                self.stats["rejected"] += 1
                return self.sched.reject(
                    req, f"prompt_len {prompt.size} + max_new_tokens "
                         f"{max_new_tokens} exceeds slot capacity "
                         f"{self.ec.capacity}")
            need = self.pool.pages_needed(total)
            if need > self.pool.n_pages - 1:
                self.stats["rejected"] += 1
                return self.sched.reject(
                    req, f"request needs {need} KV pages but the pool only "
                         f"has {self.pool.n_pages - 1} allocatable pages")
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
                self.sched.drop_waiting(victim, REJECTED,
                                        "shed: waiting queue full")
                self.stats["shed"] += 1
            return rid

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
                    self.pool.release(slot)
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
                    self.pool.release(slot)
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
        under the engine lock; slot occupancy is summarized as its mean and
        the live queue depths ride along."""
        with self._elock:
            snap: Dict[str, Any] = {}
            for k, v in self.stats.items():
                if k == "slot_occupancy":
                    snap["slot_occupancy_mean"] = (
                        float(np.mean(v)) if v else 0.0)
                elif isinstance(v, list):
                    snap[k] = list(v)
                else:
                    snap[k] = v
            snap["active"] = len(self.sched.active)
            snap["waiting"] = len(self.sched.waiting)
            snap["paused_now"] = len(self.sched.paused)
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
                self.pool.release(slot)
                self.sched.requeue(slot)
            if self.prefix_cache:
                self.pool.reset_prefix()
            self._stall_steps = 0
            self._defer_steps = 0
            self.stats["recoveries"] += 1
            return len(survivors)

    # -- internals ---------------------------------------------------------

    def _bucket(self, n: int) -> int:
        """Prefill length for an n-token prompt: the next power of two from
        ``min_bucket``, capped at the capacity — unless the fused flash
        prefill (``attn_impl="pallas"``) could not split the capped length
        into its chunks; the uncapped power of two is then kept (pad rows
        past the capacity land in the null page)."""
        b = self.ec.min_bucket
        while b < n:
            b *= 2
        cap = self.ec.capacity
        if b > cap and (self.cfg.attn_impl not in FLASH_ATTN_IMPLS
                        or self._chunks_fit(cap)):
            return cap
        return b

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
        for i, (req, slot) in enumerate(group):
            self._temps[slot] = req.temperature
            self._topks[slot] = req.top_k
            if not ok[i]:
                req.error = "non-finite logits at prefill"
                self.pool.release(slot)
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
        return failed

    def _admit_group(self, group: List) -> List[Request]:
        """ONE prefill for a batch of admissions. Prompts are right-padded
        to the largest member's bucket and rows to the next tier; pad rows
        alias the group's first slot but carry zero table rows, so their
        KV lands in the null page."""
        k = len(group)
        bucket = max(self._bucket(req.prompt_len) for req, _ in group)
        k_pad = next(t for t in self._row_tiers() if t >= k)
        toks = np.zeros((k_pad, bucket), np.int32)
        lens = np.ones((k_pad,), np.int32)
        temps = np.zeros((k_pad,), np.float32)
        topks = np.zeros((k_pad,), np.int32)
        slots = np.zeros((k_pad,), np.int32)
        for i, (req, slot) in enumerate(group):
            p = req.prompt_len
            toks[i, :p] = req.prompt
            lens[i] = p
            temps[i] = req.temperature
            topks[i] = req.top_k
            slots[i] = slot
        slots[k:] = slots[0]
        logits, pcache = self.fns.prefill(
            self.params, {"tokens": self._tensor(toks),
                          "length": self._tensor(lens)})
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
        if admitted:
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
                             + req.max_new_tokens)
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
            if cold:
                finished.extend(self._admit_group(cold))

        # requests whose first (prefill-sampled) token already completed them
        for slot, req in list(self.sched.active.items()):
            if req.is_finished():
                self.pool.release(slot)
                finished.append(self.sched.retire(slot))
        if not self.sched.active:
            self._finish_step(t_step)
            return finished

        self.stats["slot_occupancy"].append(len(self.sched.active))
        bt = self._prepare_paged_writes(
            {slot: int(self.pool.lens[slot]) + 1
             for slot in self.sched.active}, extra=1)
        logits, self.pool.cache = self.fns.decode_step(
            self.params, {"tokens": self._tensor(self._tokens),
                          "cache_len": self._tensor(self.pool.lens),
                          "block_tables": bt}, self.pool.cache)
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
                self.pool.release(slot)
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
                self.pool.release(slot)
                finished.append(self.sched.retire(slot))
        self._finish_step(t_step)
        return finished

    def _finish_step(self, t_start: float) -> None:
        """End-of-step bookkeeping on every return path: mirror the pool's
        counters and feed the step's duration to the watchdog."""
        for key in ("evictions", "pages_allocated", "cow_copies"):
            self.stats[key] = self.pool.stats[key]
        if self._watchdog is not None:
            self._watchdog.record(self._clock() - t_start)
            self.stats["watchdog_slow_steps"] = self._watchdog.slow_steps
            self.stats["step_time_ewma"] = self._watchdog.ewma

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
        self.stats["kv_bytes_read_live"] += (self.pool.live_page_rows()
                                             * self._kv_row_bytes)
        return self.pool.device_tables(self.pool.table_width(extra=extra))

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
                self.pool.release(slot)
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
        self.pool.release(slot)
        self.stats["preemptions"] += 1
        return self.sched.preempt(slot)

    def check_conservation(self) -> None:
        """Check that nothing leaked once the engine drained: every slot
        free, no live request, every non-null page idle and the pool's
        refcounts, index and reservations consistent."""
        with self._elock:
            if self.sched.active or self.sched.waiting or self.sched.paused:
                raise AssertionError("check_conservation() needs a drained "
                                     "engine")
            if self.sched.free_slots() != self.ec.n_slots:
                raise AssertionError("leaked slots")
            self.pool.check_consistency()
            idle = self.pool.idle_pages()
            if idle != self.pool.n_pages - 1:
                raise AssertionError(f"leaked {self.pool.n_pages - 1 - idle} "
                                     f"KV pages")

    # -- convenience -------------------------------------------------------

    def reset_stats(self) -> None:
        with self._elock:
            self.stats.clear()
            self.stats.update(decode_steps=0, prefills=0, prefill_rows=0,
                              deferred_admissions=0, tokens_generated=0,
                              page_stalls=0, kv_bytes_read_live=0,
                              slot_occupancy=[], prefix_hit_tokens=0,
                              pages_shared=0, cow_copies=0, evictions=0,
                              pages_allocated=0, preemptions=0, shed=0,
                              rejected=0, timeouts=0, cancelled=0, failed=0,
                              recoveries=0, watchdog_slow_steps=0,
                              step_time_ewma=0.0, timeouts_waiting=0,
                              timeouts_running=0, paused=0, resumed=0)
            # a fresh watchdog per reset: earlier steps must not seed the
            # EWMA the next window is judged against
            self._watchdog = (
                StepWatchdog(threshold=self.ec.watchdog_threshold)
                if self.ec.watchdog_threshold > 0 else None)
            self.pool.reset_stats()

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
