"""``repro_torch.obs`` — host-side observability (Spec -> Resolver -> Artifact).

Counterpart of ``repro.obs``, with the same exports:

- :class:`ObsConfig`       — the spec: trace/metrics enables + dump
  paths + the injectable monotonic clock.  ``resolve()`` is the one
  constructor (returns :data:`NULL_OBSERVER` when disabled).
- :class:`Observer`        — the resolver output the serving engines
  call into: per-request lifecycle hooks (submit -> queue-wait ->
  admit -> first token -> per-step decode/verify -> finish), per-launch
  spans stamped with LaunchPlan provenance, structured warnings, and
  occupancy gauges.  :meth:`Observer.shard_view` merges per-shard
  labels onto one clock.
- :class:`Tracer` / :class:`TraceArtifact` — Chrome trace-event JSON
  (Perfetto-loadable), schema-gated by :func:`validate_trace`.
- :class:`MetricsRegistry` — counters / gauges / fixed-bucket
  histograms with a JSON snapshot and Prometheus text exposition;
  the snapshot's ``plan_cache`` section absorbs ``PlanCacheStats``
  (``to_json`` shape preserved).

Everything here is strictly host-side: nothing runs on the card, and
the disabled path allocates nothing per step.
"""
from repro_torch.obs.config import ObsConfig, resolve_obs  # noqa: F401
from repro_torch.obs.io import (  # noqa: F401
    atomic_write_json,
    atomic_write_text,
)
from repro_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    Family,
    MetricsRegistry,
)
from repro_torch.obs.observer import (  # noqa: F401
    NULL_OBSERVER,
    NullObserver,
    Observer,
    plan_provenance,
)
from repro_torch.obs.trace import (  # noqa: F401
    TraceArtifact,
    Tracer,
    validate_trace,
)
