"""Straggler detection for the train loop (the reference's
``runtime/fault_tolerance.py``, ``StragglerDetector`` only; the heartbeat
monitor and the elastic planner come with tensor parallelism)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List


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
