"""ObsConfig: the spec half of the spec -> resolver -> artifact package.

Counterpart of ``repro.obs.config``, unchanged.

``ObsConfig.resolve()`` is the one constructor every consumer goes
through: it returns the shared :data:`~repro_torch.obs.NULL_OBSERVER`
singleton when nothing is enabled (the zero-cost path — engines branch
on ``observer.enabled`` and never allocate), or an
:class:`~repro_torch.obs.Observer` wiring a :class:`~repro_torch.obs.Tracer`
(``trace`` / ``trace_path``) and/or a
:class:`~repro_torch.obs.MetricsRegistry` (``metrics`` / ``metrics_path``)
onto the injectable monotonic ``clock`` (tests pass a fake clock for
deterministic traces; ``None`` = ``time.monotonic``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Union

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.observer import NULL_OBSERVER, NullObserver, Observer
from repro_torch.obs.trace import Tracer


@dataclass(frozen=True)
class ObsConfig:
    # when set, the owning engine's drain() writes the Chrome
    # trace-event JSON artifact here (load it at https://ui.perfetto.dev)
    trace_path: Optional[str] = None
    # when set, drain() writes the metrics artifact here; a ".prom" /
    # ".txt" suffix selects Prometheus text exposition, else JSON
    metrics_path: Optional[str] = None
    # record in memory without a dump path (benchmarks/tests read the
    # artifact / snapshot off the observer directly)
    trace: bool = False
    metrics: bool = False
    # injectable monotonic clock (seconds); None = time.monotonic
    clock: Optional[Callable[[], float]] = None
    # trace process_name for pid 0 (shard views name their own pids)
    process_name: str = "serve"

    @property
    def enabled(self) -> bool:
        return bool(self.trace_path or self.metrics_path
                    or self.trace or self.metrics)

    @property
    def trace_on(self) -> bool:
        return bool(self.trace or self.trace_path)

    @property
    def metrics_on(self) -> bool:
        return bool(self.metrics or self.metrics_path)

    def resolve(self) -> Union[Observer, NullObserver]:
        if not self.enabled:
            return NULL_OBSERVER
        return Observer(
            tracer=Tracer() if self.trace_on else None,
            metrics=MetricsRegistry() if self.metrics_on else None,
            clock=self.clock, process_name=self.process_name)


def resolve_obs(scfg: Any) -> Union[Observer, NullObserver]:
    """Resolve an engine's observer from its ``ServeConfig`` paths
    (the engine-owned construction site; an explicitly injected
    observer — e.g. a shard view — always wins upstream)."""
    return ObsConfig(trace_path=scfg.trace_path,
                     metrics_path=scfg.metrics_path).resolve()
