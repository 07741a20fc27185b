"""Continuous-batching serving stack of the port: the paged engine with its
prefix cache and request lifecycle, and the fault-injection harness."""

from repro_torch.serving.engine import (  # noqa: F401
    EngineConfig, InferenceEngine, sample_tokens,
)
from repro_torch.serving.faults import (  # noqa: F401
    FakeClock, FaultInjector, StepWatchdog,
)
from repro_torch.serving.kv_slots import PagedSlotPool  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    CANCELLED, FAILED, FINISHED, REJECTED, TERMINAL, TIMEOUT, Request,
    Scheduler,
)
