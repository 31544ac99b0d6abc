"""Serving (counterpart of ``repro.serving``): the request-lifecycle
engine, its scheduler, sampling and events, and the frozen mesh step
builders (``decode_step``)."""
from repro_torch.serving.decode_step import (  # noqa: F401
    PrefillStepBundle,
    ServeStepBundle,
    attention_spec,
    build_mesh_decode_step,
    build_prefill_step,
    build_serve_step,
    decode_workload,
    effective_kv_heads,
    mesh_launch_plan,
    mesh_plan,
    mesh_split_decision,
    serve_param_rules,
)
from repro_torch.serving.engine import (  # noqa: F401
    DecodeEngine,
    ServingEngine,
)
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
    CategoricalSampler,
    GreedySampler,
    Sampler,
    SamplingParams,
    get_sampler,
    register_sampler,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    Completion,
    Request,
    Scheduler,
)
