"""Deterministic fault injection and step watchdog for the serving engine.

Numpy only: a copy of the reference package's module, which the port cannot
import. The seeded schedule and :meth:`FaultInjector.choose` draw exactly
what the reference draws for the same seed. The :class:`FaultInjector` is a
*schedule*, not a random process — it is built once (either explicitly via
:meth:`FaultInjector.at` or from seeded rates via
:meth:`FaultInjector.random_schedule`) and then queried by the engine each
step. Queries are pure and idempotent: the engine may ask ``fires(step, kind)``
any number of times per step and always gets the same answer, so fault
delivery does not depend on engine-internal call ordering.

Step indices count *engine* steps, i.e. every :meth:`InferenceEngine.step`
call. Tests that want faults at precise points attach the injector to a
fresh engine.

The port's engine acts on ``page_alloc``, ``nan_logits``, ``slow_step``,
``cancel``, ``shard_skew`` (at any mesh size; at mesh 1 the one rank is the
straggler) and, under speculative decoding, ``drafter``; the HTTP layer
(``serving/server.py``'s ``EngineHost``) acts on ``crash_step`` and
``slow_client``, which the engine ignores.

Fault kinds
-----------
``page_alloc``
    The paged-KV reservation loop behaves as if the pool were exhausted this
    step: no new admissions, waiting requests stay queued (exercises the
    stall/preemption path).
``nan_logits``
    One live row's finite-logits flag is flipped host-side after dispatch,
    simulating a poisoned kernel output; the engine must fail only that
    request.
``drafter``
    The speculative drafter raises during ``propose``; the engine must degrade
    the round to a 1-token verify step.
``slow_step``
    The injected ``sleep`` callable is invoked with the scheduled duration at
    the top of the step (exercises the watchdog).
``cancel``
    A uniformly chosen live request (waiting or running) is cancelled via
    :meth:`InferenceEngine.cancel`.
``crash_step``
    Consumed by the HTTP layer, not the engine: the supervised step loop in
    ``serving/server.py`` raises before dispatching that step, exercising
    the supervisor's recover→restart path. Indexed by the *host* loop's
    step-attempt counter (which counts exactly the engine steps it drives).
``slow_client``
    Also consumed by the HTTP layer: the pump picks one open stream
    (``choose``) and withholds token delivery to it for ``arg`` wall-clock
    seconds (default 0.25), simulating a stalled SSE reader — the
    per-stream queue depth grows until the slow-client backpressure policy
    (pause or disconnect-as-cancel) engages. Indexed by the host loop's
    step counter, like ``crash_step``.
``shard_skew``
    One tensor-parallel shard runs artificially slow this step. SPMD
    programs are lockstep (every all-gather is a barrier), so the whole
    engine step stalls for the skewed shard's delay — the engine sleeps
    ``arg`` seconds (via the injected ``sleep``) and records which shard
    index (``choose`` over the mesh) was the straggler. Exercises the
    watchdog and latency accounting under a mesh; tokens/pool state must
    be unaffected (a slow shard is not a wrong shard).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np

KINDS = ("page_alloc", "nan_logits", "drafter", "slow_step", "cancel",
         "crash_step", "slow_client", "shard_skew")


@dataclass
class FaultInjector:
    """Deterministic per-step fault schedule for the serving engine.

    Parameters
    ----------
    seed:
        Seeds both :meth:`random_schedule` and :meth:`choose` (victim
        selection for ``nan_logits`` / ``cancel``).
    sleep:
        Callable invoked by :meth:`maybe_sleep` for ``slow_step`` faults.
        Tests inject :meth:`FakeClock.sleep` to keep chaos runs fast.
    """

    seed: int = 0
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self) -> None:
        self.rng = np.random.default_rng(self.seed)
        # step -> list of (kind, arg) scheduled at that step.
        self._at: Dict[int, List[Tuple[str, float]]] = {}
        # (step, kind, detail) log of every fault the engine acted on.
        self.fired: List[Tuple[int, str, float]] = []

    # -- schedule construction ------------------------------------------------

    def at(self, step: int, kind: str, arg: float = 0.0) -> "FaultInjector":
        """Schedule ``kind`` at engine step ``step``. Returns self (chainable)."""
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; expected one of {KINDS}")
        self._at.setdefault(int(step), []).append((kind, float(arg)))
        return self

    def random_schedule(
        self,
        n_steps: int,
        rates: Dict[str, float],
        slow_s: float = 0.05,
    ) -> "FaultInjector":
        """Populate ``n_steps`` of schedule from per-step Bernoulli ``rates``.

        ``rates`` maps fault kind -> probability of firing at each step.
        ``slow_s`` is the sleep duration attached to ``slow_step`` faults.
        """
        for kind, rate in rates.items():
            if kind not in KINDS:
                raise ValueError(f"unknown fault kind {kind!r}; expected one of {KINDS}")
            hits = np.nonzero(self.rng.random(n_steps) < rate)[0]
            for step in hits:
                self.at(int(step), kind,
                        slow_s if kind in ("slow_step", "shard_skew")
                        else 0.0)
        return self

    # -- queries (pure / idempotent) ------------------------------------------

    def fires(self, step: int, kind: str) -> bool:
        """True if ``kind`` is scheduled at ``step``. Safe to call repeatedly."""
        return any(k == kind for k, _ in self._at.get(step, ()))

    def arg(self, step: int, kind: str) -> float:
        """The argument attached to the first ``kind`` entry at ``step``."""
        for k, a in self._at.get(step, ()):
            if k == kind:
                return a
        return 0.0

    def choose(self, n: int) -> int:
        """Pick a victim index in ``[0, n)``. Deterministic given seed+call order."""
        return int(self.rng.integers(n))

    # -- effects --------------------------------------------------------------

    def maybe_sleep(self, step: int) -> None:
        """Invoke the injected sleep if a ``slow_step`` fault fires at ``step``."""
        if self.fires(step, "slow_step"):
            dur = self.arg(step, "slow_step")
            self.record(step, "slow_step", dur)
            self.sleep(dur)

    def record(self, step: int, kind: str, detail: float = 0.0) -> None:
        """Log a fault the engine actually acted on (for test assertions)."""
        self.fired.append((int(step), kind, float(detail)))


@dataclass
class StepWatchdog:
    """EWMA-based slow-step detector, in the style of ``StragglerDetector``.

    Flags a step as slow when its duration exceeds ``threshold`` times the
    running EWMA of previous steps (after ``min_steps`` observations). The
    check runs *before* the EWMA absorbs the new sample, so a single huge
    outlier is flagged rather than averaged away.
    """

    alpha: float = 0.2
    threshold: float = 3.0
    min_steps: int = 5
    ewma: float = 0.0
    n: int = 0
    slow_steps: int = 0
    last_flagged: bool = False

    def record(self, step_time_s: float) -> bool:
        """Observe one step duration; returns True if it was flagged slow."""
        flagged = self.n >= self.min_steps and step_time_s > self.threshold * self.ewma
        if flagged:
            self.slow_steps += 1
        self.last_flagged = flagged
        if self.n == 0:
            self.ewma = step_time_s
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time_s
        self.n += 1
        return flagged


@dataclass
class FakeClock:
    """Deterministic clock for tests: ``clock()`` reads, ``sleep/advance`` move it."""

    now: float = 0.0

    def __call__(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.now += s

    def advance(self, s: float) -> None:
        self.now += s
