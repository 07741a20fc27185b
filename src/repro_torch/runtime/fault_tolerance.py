"""Fault tolerance and elastic scaling (the reference's
``runtime/fault_tolerance.py``): heartbeat tracking finds dead hosts,
step-time EWMAs find stragglers, and the elastic planner picks the largest
valid (pod, data, model) mesh from the surviving chips, to restore the
latest checkpoint onto.

All of it is deterministic host logic with an injectable clock, so the CPU
tests drive the whole failure → replan path without hardware.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class HeartbeatMonitor:
    """Last heartbeat per host; a host silent for more than ``timeout_s``
    is dead."""

    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self._last: Dict[int, float] = {}

    def beat(self, host: int, t: Optional[float] = None) -> None:
        self._last[host] = self.clock() if t is None else t

    def dead_hosts(self, t: Optional[float] = None) -> List[int]:
        now = self.clock() if t is None else t
        return sorted(h for h, last in self._last.items()
                      if now - last > self.timeout_s)

    def alive_hosts(self, t: Optional[float] = None) -> List[int]:
        now = self.clock() if t is None else t
        return sorted(h for h, last in self._last.items()
                      if now - last <= self.timeout_s)


@dataclasses.dataclass
class StragglerDetector:
    """Per-host step-time EWMA; flags hosts persistently slower than the
    fleet median by ``threshold``×."""

    alpha: float = 0.2
    threshold: float = 1.5
    min_steps: int = 5

    def __post_init__(self):
        self._ewma: Dict[int, float] = {}
        self._n: Dict[int, int] = {}

    def record(self, host: int, step_time_s: float) -> None:
        prev = self._ewma.get(host)
        self._ewma[host] = (step_time_s if prev is None
                            else self.alpha * step_time_s
                            + (1 - self.alpha) * prev)
        self._n[host] = self._n.get(host, 0) + 1

    def stragglers(self) -> List[int]:
        ready = {h: v for h, v in self._ewma.items()
                 if self._n[h] >= self.min_steps}
        if len(ready) < 2:
            return []
        med = sorted(ready.values())[len(ready) // 2]
        return sorted(h for h, v in ready.items() if v > self.threshold * med)


def plan_elastic_mesh(
    n_chips: int, *, prefer_model: int = 16, min_model: int = 4,
    chips_per_pod: int = 256,
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The largest valid mesh over ``n_chips`` surviving chips: the model
    axis stays at ``prefer_model`` (a property of the model; shrunk by
    halves only as a last resort), the rest goes to data, and a pod axis
    comes back when at least two full pods survive."""
    if n_chips < min_model:
        raise ValueError(f"not enough chips: {n_chips}")
    model = prefer_model
    while model > min_model and n_chips % model:
        model //= 2
    while n_chips % model:
        model //= 2
    rest = n_chips // model
    pods = max(1, n_chips // chips_per_pod)
    if pods >= 2 and rest % pods == 0:
        return (pods, rest // pods, model), ("pod", "data", "model")
    return (rest, model), ("data", "model")


@dataclasses.dataclass
class ElasticPlanner:
    """Failure event → (new mesh, restore step) decision."""

    monitor: HeartbeatMonitor
    chips_per_host: int = 4

    def replan(self, latest_ckpt_step: Optional[int]
               ) -> Tuple[Tuple[int, ...], Tuple[str, ...], Optional[int]]:
        alive = self.monitor.alive_hosts()
        shape, axes = plan_elastic_mesh(len(alive) * self.chips_per_host)
        return shape, axes, latest_ckpt_step
