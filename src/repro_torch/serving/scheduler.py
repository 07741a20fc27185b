"""Priority-tiered FCFS request scheduler for the continuous-batching engine.

Pure host-side bookkeeping, numpy only: a copy of the reference package's
module, which the port cannot import. The engine drives it each step:

  submit() enqueues; admit() pops waiting requests into free slots (highest
  ``Request.priority`` tier first, weighted-fair across tenants then FCFS
  within a tier, bounded by ``max_admit`` so prefill work interleaves with
  decode instead of starving running requests); retire() frees a slot for
  reuse.

The waiting deque is kept in admission order at all times — submit()
inserts each request behind every waiting request of its own or a higher
tier, so admit() picks from the leftmost (highest) tier. With every
priority equal (the default 0) and a single tenant this degrades to
exactly the old strict-FCFS queue; with several tenants waiting in the
same tier, admit() picks the tenant with the least weighted service so
far (see :meth:`Scheduler._next_admission`) — weighted fair queueing, so
one tenant's burst cannot starve another's steady trickle.

Every request carries a ``status`` that walks a small state machine::

    QUEUED -> RUNNING -> FINISHED | TIMEOUT | CANCELLED | FAILED
       |         |
       |         +-> PREEMPTED -> (waiting again) -> RUNNING -> ...
       |         +-> PAUSED    -> (resume)        -> QUEUED  -> ...
       +-> TIMEOUT | CANCELLED | REJECTED          (dropped while waiting)

``REJECTED`` is assigned at submit time (oversized request, load shed,
tenant quota, or a provably unmakeable SLO); ``PREEMPTED`` is the
observable waiting-after-eviction state and clears back to RUNNING on
re-admission. ``PAUSED`` is the slow-client backpressure parking state:
the request holds no slot and is NOT in the waiting queue (``resume``
re-enqueues it); it can still be cancelled or time out. Exactly one
terminal status per request; each request enters ``finished`` exactly
once, when it reaches one — the optional ``on_terminal`` hook fires at
that moment (the engine uses it for per-tenant accounting).
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# Lifecycle statuses (plain strings so they serialize/log cleanly).
QUEUED = "QUEUED"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
TIMEOUT = "TIMEOUT"
CANCELLED = "CANCELLED"
REJECTED = "REJECTED"
PREEMPTED = "PREEMPTED"
PAUSED = "PAUSED"
FAILED = "FAILED"

#: Statuses a request can end in. PREEMPTED is transient (the request is
#: back in the waiting queue and will run again), so it is not terminal.
TERMINAL = frozenset({FINISHED, TIMEOUT, CANCELLED, REJECTED, FAILED})


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request plus its serving-lifetime bookkeeping.

    ``eq=False``: requests compare by identity. The generated ``__eq__``
    would compare the ``prompt`` arrays elementwise (ambiguous truth
    value) the moment ``drop_waiting``'s ``deque.remove`` probes past a
    non-victim entry — identity is also the semantically right notion
    here (two requests are never "the same" just because their fields
    match)."""

    prompt: np.ndarray                  # (P,) int32 token ids
    max_new_tokens: int = 16
    temperature: float = 0.0            # 0 → greedy
    top_k: int = 0                      # 0 → no top-k filtering
    eos_id: Optional[int] = None
    arrival_time: float = 0.0           # driver clock, for latency metrics
    deadline_s: float = 0.0             # 0 → no deadline; else seconds from submit
    # QoS tier: higher admitted first; FCFS within a tier. Load shedding
    # and page-pressure preemption both prefer the lowest tier as victim.
    priority: int = 0
    # tenant id for quota accounting and weighted fair queueing; "" is the
    # anonymous default tenant (single-tenant deployments never set it)
    tenant: str = ""

    # filled in by the scheduler/engine
    rid: int = -1
    slot: int = -1
    status: str = QUEUED
    generated: List[int] = dataclasses.field(default_factory=list)
    submit_time: float = 0.0            # engine clock at submit (deadline base)
    admit_time: float = 0.0
    first_token_time: float = 0.0
    token_times: List[float] = dataclasses.field(default_factory=list)
    # prompt tokens served from the shared prefix cache at admission
    # (0 = cold / sharing off); reset on requeue so a later admission
    # re-matches against the index as it stands then
    prefix_hit: int = 0
    # preemption bookkeeping: how many times evicted, and how many generated
    # tokens have been folded into ``prompt`` so re-prefill replays them.
    # Generated token i lives at absolute position (prompt_len - folded) + i.
    preemptions: int = 0
    folded: int = 0
    error: str = ""                     # reason for FAILED/REJECTED/TIMEOUT
    # computed drain-time hint (seconds) set when the engine rejects or
    # sheds the request — the HTTP layer turns it into ``Retry-After``.
    # 0 means "no estimate" (e.g. a request that can never fit).
    retry_after_s: float = 0.0
    # weighted service charged to the tenant at admission (refunded when
    # the admission unwinds via requeue/preempt)
    service_charge: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def is_finished(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return (self.eos_id is not None and len(self.generated) > 0
                and self.generated[-1] == self.eos_id)


class Scheduler:
    """FCFS queue over a fixed pool of decode slots."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.waiting: deque[Request] = deque()
        self.active: Dict[int, Request] = {}          # slot -> request
        self.paused: Dict[int, Request] = {}          # rid -> parked request
        self._free: deque[int] = deque(range(n_slots))
        self._ids = itertools.count()
        self.finished: List[Request] = []
        # weighted fair queueing across tenants within a priority tier:
        # cumulative weighted service per tenant (cost / weight, charged at
        # admission) — admit() picks the waiting tenant with the least.
        self.service: Dict[str, float] = {}
        self.weights: Dict[str, float] = {}           # tenant -> WFQ weight
        # fires once per request, the moment it turns terminal (appended to
        # ``finished``) — the engine hooks per-tenant accounting here so no
        # retire/reject/drop call site can be missed.
        self.on_terminal: Optional[Callable[[Request], None]] = None

    def _note_terminal(self, req: Request) -> None:
        self.finished.append(req)
        if self.on_terminal is not None:
            self.on_terminal(req)

    def _insert_waiting(self, req: Request) -> None:
        """Priority-ordered insert: behind every waiting request of the
        same or a higher tier (within-tier FCFS), ahead of strictly lower
        tiers. All-equal priorities → plain append, the old FCFS queue."""
        for i, w in enumerate(self.waiting):
            if w.priority < req.priority:
                self.waiting.insert(i, req)
                return
        self.waiting.append(req)

    def submit(self, req: Request) -> int:
        req.rid = next(self._ids)
        req.status = QUEUED
        self._insert_waiting(req)
        return req.rid

    def reject(self, req: Request, reason: str) -> int:
        """Assign a rid and retire the request immediately as REJECTED."""
        req.rid = next(self._ids)
        req.status = REJECTED
        req.error = reason
        self._note_terminal(req)
        return req.rid

    # -- weighted fair queueing across tenants -------------------------------

    def _weight(self, tenant: str) -> float:
        return max(self.weights.get(tenant, 1.0), 1e-6)

    def _service(self, tenant: str) -> float:
        if tenant not in self.service:
            # a newly seen tenant joins at the current minimum: it gets no
            # retroactive credit for the time it sent nothing, so it cannot
            # burst ahead of tenants that have been paying service all along
            self.service[tenant] = min(self.service.values(), default=0.0)
        return self.service[tenant]

    def _next_admission(self) -> Request:
        """The next request to seat: within the leftmost (highest) waiting
        tier, the first request of the tenant with the least weighted
        service so far (ties break on rid → FCFS). Single-tenant tiers
        short-circuit to the head — exactly the old strict-FCFS order."""
        top = self.waiting[0].priority
        firsts: Dict[str, Request] = {}
        for w in self.waiting:
            if w.priority != top:
                break               # deque is priority-ordered: tier ends
            if w.tenant not in firsts:
                firsts[w.tenant] = w
        if len(firsts) == 1:
            return self.waiting[0]
        return min(firsts.values(),
                   key=lambda r: (self._service(r.tenant), r.rid))

    def admit(self, max_admit: Optional[int] = None) -> List[Tuple[Request, int]]:
        """Seat waiting requests into free slots (highest tier first,
        weighted-fair across tenants then FCFS within a tier); returns
        (request, slot) pairs for the engine to prefill. Each admission
        charges the tenant's service counter with the request's work
        (prompt + generation budget, scaled by 1/weight) — the counter is
        refunded if the admission unwinds via requeue/preempt."""
        out: List[Tuple[Request, int]] = []
        while self.waiting and self._free:
            if max_admit is not None and len(out) >= max_admit:
                break
            req = self._next_admission()
            if req is self.waiting[0]:
                self.waiting.popleft()
            else:
                self.waiting.remove(req)
            slot = self._free.popleft()
            req.slot = slot
            req.status = RUNNING
            self.active[slot] = req
            cost = float(req.prompt_len - req.folded + req.max_new_tokens)
            req.service_charge = cost / self._weight(req.tenant)
            self.service[req.tenant] = (self._service(req.tenant)
                                        + req.service_charge)
            out.append((req, slot))
        return out

    def _refund_service(self, req: Request) -> None:
        if req.service_charge:
            self.service[req.tenant] = (self._service(req.tenant)
                                        - req.service_charge)
            req.service_charge = 0.0

    def requeue(self, slot: int) -> Request:
        """Undo an admission (e.g. the KV page pool could not cover the
        request): the request returns to the FRONT of the waiting queue and
        the slot frees. Callers unwinding several admissions must requeue
        them in reverse admission order to preserve FCFS."""
        req = self.active.pop(slot)
        req.slot = -1
        req.status = QUEUED
        req.prefix_hit = 0
        self._refund_service(req)
        self._free.append(slot)
        self.waiting.appendleft(req)
        return req

    def preempt(self, slot: int) -> Request:
        """Evict a RUNNING request back into the waiting queue under page
        pressure. Unlike :meth:`requeue` (which unwinds a same-step admission
        to the queue front), the victim re-enters *behind* the stalled head —
        the head stalled because the victim's pages were needed, so putting
        the victim first would just re-stall it — but ahead of later arrivals
        of its own tier so it is not starved. Strictly higher-tier waiters
        past the head keep their place ahead of the victim."""
        req = self.active.pop(slot)
        req.slot = -1
        req.status = PREEMPTED
        req.prefix_hit = 0
        req.preemptions += 1
        self._refund_service(req)
        self._free.append(slot)
        # behind the head (position 1) is absolute — even a lower-tier head
        # stays put, it stalled precisely because it needs the victim's
        # pages; past it, skip higher-tier waiters to keep the deque's
        # priority order. deque.insert clamps to append when index > len.
        idx = 1
        while idx < len(self.waiting) and self.waiting[idx].priority > req.priority:
            idx += 1
        self.waiting.insert(idx, req)
        return req

    def retire(self, slot: int, status: str = FINISHED) -> Request:
        req = self.active.pop(slot)
        req.status = status
        self._free.append(slot)
        self._note_terminal(req)
        return req

    def drop_waiting(self, req: Request, status: str, reason: str = "") -> Request:
        """Remove a request from the waiting queue with a terminal status
        (load shed, timeout, or cancellation before it ever ran)."""
        self.waiting.remove(req)
        req.status = status
        if reason:
            req.error = reason
        self._note_terminal(req)
        return req

    # -- slow-client parking (PAUSED) ----------------------------------------

    def pause(self, slot: int) -> Request:
        """Park a RUNNING request out of the slot pool (slow-client
        backpressure). Unlike :meth:`preempt` the request does NOT rejoin
        the waiting queue — it sits in ``paused`` holding no slot and no
        pages until :meth:`resume` re-enqueues it (or it is cancelled /
        times out / is dropped at drain). The engine folds generated
        tokens into the prompt first, so re-admission replays them."""
        req = self.active.pop(slot)
        req.slot = -1
        req.status = PAUSED
        req.prefix_hit = 0
        self._refund_service(req)
        self._free.append(slot)
        self.paused[req.rid] = req
        return req

    def pause_waiting(self, req: Request) -> Request:
        """Park a QUEUED request (its client stalled before it ever ran)."""
        self.waiting.remove(req)
        req.status = PAUSED
        self.paused[req.rid] = req
        return req

    def resume(self, rid: int) -> Optional[Request]:
        """Re-enqueue a paused request at its priority tier (behind its
        tier's current waiters — it lost its place while parked)."""
        req = self.paused.pop(rid, None)
        if req is None:
            return None
        req.status = QUEUED
        self._insert_waiting(req)
        return req

    def drop_paused(self, rid: int, status: str, reason: str = ""
                    ) -> Optional[Request]:
        """Terminate a paused request (cancel, deadline expiry, drain)."""
        req = self.paused.pop(rid, None)
        if req is None:
            return None
        req.status = status
        if reason:
            req.error = reason
        self._note_terminal(req)
        return req

    def free_slots(self) -> int:
        return len(self._free)

    def has_work(self) -> bool:
        """Runnable work only: PAUSED requests are parked by design and do
        not keep the engine's drain loop spinning."""
        return bool(self.waiting or self.active)
