"""Continuous-batching serving stack of the port (paged engine subset)."""

from repro_torch.serving.engine import (  # noqa: F401
    EngineConfig, InferenceEngine, sample_tokens,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    CANCELLED, FAILED, FINISHED, REJECTED, TIMEOUT, Request, Scheduler,
)
