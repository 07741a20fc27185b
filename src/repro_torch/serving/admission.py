"""SLO-aware admission control and per-tenant quota primitives.

Pure host-side arithmetic, a copy of the reference package's module (the
port imports nothing of it): the same inputs give the same estimates,
rejections and ``Retry-After`` values in both packages. Three pieces:

:func:`estimate_seat_steps`
    Event-simulates slot turnover with a min-heap of per-slot free times
    (all quantities in *decode-step* units): a request entering behind the
    current queue seats when the earliest slot frees after every request
    ahead of it has been seated and drained. The engine multiplies the
    result by its measured step-time EWMA to get wall-clock estimates —
    time-to-first-token, time-to-finish, and the drain time that backs
    every computed ``Retry-After`` header.

:class:`TenantQuota`
    Per-tenant limits: a sustained request rate with burst depth (token
    bucket), a cap on concurrent live requests, a KV page budget, and the
    weighted-fair-queueing weight the scheduler uses to pick the next
    admission within a priority tier.

:class:`TokenBucket`
    The classic leaky counter behind ``TenantQuota.rate``. The clock is
    injected so tests drive it deterministically (``FakeClock``), and
    :meth:`TokenBucket.next_free_s` is the computed ``Retry-After`` for a
    rate-limited reject.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Iterable, Optional


def estimate_seat_steps(free_slots: int,
                        running_steps: Iterable[float],
                        ahead_steps: Iterable[float]) -> float:
    """Steps until a slot frees for a request at the back of the queue.

    ``free_slots`` slots are available now (free time 0); each running
    request holds its slot for ``running_steps[i]`` more steps; every
    queued request ahead of the probe seats into the earliest-freeing slot
    and holds it for its own ``ahead_steps[j]`` work. Returns the free
    time of the slot the probe itself would seat into. Exact for the
    engine's one-token-per-step decode model; prefill and backfill-defer
    costs are folded into the per-request work terms by the caller.
    """
    frees = [0.0] * int(free_slots) + sorted(float(s) for s in running_steps)
    if not frees:
        return 0.0
    heapq.heapify(frees)
    for w in ahead_steps:
        t = heapq.heappop(frees)
        heapq.heappush(frees, t + float(w))
    return heapq.heappop(frees)


def request_work_steps(prompt_len: int, folded: int, max_new_tokens: int,
                       generated: int) -> float:
    """Decode-step cost of (re)running a request to completion: one
    prefill dispatch plus its remaining generation budget. ``folded``
    preemption tokens are replayed by the prefill, not re-generated."""
    del prompt_len, folded  # one bucketed dispatch regardless of length
    return 1.0 + max(1, max_new_tokens - generated)


@dataclasses.dataclass
class TenantQuota:
    """Per-tenant admission limits. Zero means "unlimited" for every
    field; ``weight`` only shapes WFQ admission order, never rejects."""

    rate: float = 0.0          # sustained admits/s (token bucket; 0 = off)
    burst: int = 1             # bucket depth: admits allowed back-to-back
    max_concurrent: int = 0    # live (waiting+running+paused) requests
    max_pages: int = 0         # worst-case KV pages reserved across live
    weight: float = 1.0        # WFQ share within a priority tier


class TokenBucket:
    """Token bucket over an injected clock.

    ``try_take`` consumes one token if available (always True when
    ``rate <= 0``); ``next_free_s`` is how long until the next token
    accrues — the natural ``Retry-After`` for a rate-limited reject.
    """

    def __init__(self, rate: float, burst: int = 1,
                 clock: Optional[Callable[[], float]] = None):
        import time
        self.rate = float(rate)
        self.burst = max(1, int(burst))
        self._clock = clock or time.monotonic
        self.tokens = float(self.burst)
        self._last = self._clock()

    def _refill(self) -> None:
        now = self._clock()
        self.tokens = min(float(self.burst),
                          self.tokens + (now - self._last) * self.rate)
        self._last = now

    def try_take(self) -> bool:
        if self.rate <= 0:
            return True
        self._refill()
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def next_free_s(self) -> float:
        if self.rate <= 0:
            return 0.0
        self._refill()
        if self.tokens >= 1.0:
            return 0.0
        return (1.0 - self.tokens) / self.rate
