"""Continuous-batching serving stack of the port: the engine over a paged
or a capacity-dense pool, with its prefix cache, speculative decoding,
request lifecycle, SLO admission and tenancy, the fault-injection harness,
and the asyncio HTTP front end with its blocking clients."""

from repro_torch.serving.admission import (  # noqa: F401
    TenantQuota, TokenBucket, estimate_seat_steps, request_work_steps,
)
from repro_torch.serving.engine import (  # noqa: F401
    EngineConfig, InferenceEngine, sample_tokens,
)
from repro_torch.serving.faults import (  # noqa: F401
    FakeClock, FaultInjector, StepWatchdog,
)
from repro_torch.serving.kv_slots import (  # noqa: F401
    PagedSlotPool, SlotPool, seat_prefill,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    CANCELLED, FAILED, FINISHED, REJECTED, TERMINAL, TIMEOUT, Request,
    Scheduler,
)
from repro_torch.serving.speculative import (  # noqa: F401
    DraftModel, OracleDraft, accept_draft, accept_greedy,
)
from repro_torch.serving.server import (  # noqa: F401
    STATUS_HTTP, EngineHost, HttpSession, InferenceServer, ServerConfig,
    ServerHandle, StreamResult, http_request, start_in_thread,
    stream_completion,
)
