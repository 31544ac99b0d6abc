"""Serving (counterpart of ``repro.serving``): the request-lifecycle
engine, its scheduler, sampling and events."""
from repro_torch.serving.engine import ServingEngine  # noqa: F401
from repro_torch.serving.events import (  # noqa: F401
    FINISH_CACHE_CAPACITY,
    FINISH_EOS,
    FINISH_LENGTH,
    FINISH_STOP,
    FINISHED,
    TOKEN,
    Event,
)
from repro_torch.serving.sampling import (  # noqa: F401
    GREEDY,
    GreedySampler,
    Sampler,
    SamplingParams,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    Completion,
    Request,
    Scheduler,
)
