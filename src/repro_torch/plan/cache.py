"""PlanCache: capacity-bounded plan residency with built-in stats.

Counterpart of ``repro.plan.cache``.  Eviction is LRU by insertion or
touch; a re-visited evicted key builds again and counts as a fresh miss.
"""
from __future__ import annotations

from collections import OrderedDict, namedtuple
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Hashable, List, Optional, Set

# functools.lru_cache's cache_info() shape
CacheInfo = namedtuple("CacheInfo", ("hits", "misses", "maxsize",
                                     "currsize"))


@dataclass
class PlanCacheStats:
    """Observability for the metadata-enabled path.

    ``misses`` is the number of entries ever built.  ``trace`` keeps the
    most recent ``TRACE_CAP`` launches; ``seen_buckets`` is the
    persistent set of every key launched, so ``distinct_buckets`` stays
    exact.  ``fallback_*`` attribute launches of the internal-heuristic
    path (``use_scheduler_metadata=False``): per launch, the resident
    length it covered and the padded length the policy saw.
    """
    TRACE_CAP = 4096

    hits: int = 0
    misses: int = 0
    launches: Dict[Hashable, int] = field(default_factory=dict)
    trace: List[Hashable] = field(default_factory=list)
    seen_buckets: Set[Hashable] = field(default_factory=set)
    fallback_launches: int = 0
    fallback_trace: List[tuple] = field(default_factory=list)

    @property
    def total_launches(self) -> int:
        return self.hits + self.misses

    @property
    def distinct_buckets(self) -> int:
        return len(self.seen_buckets)

    def _trim(self, trace: List[Any]) -> None:
        if len(trace) > 2 * self.TRACE_CAP:
            del trace[:-self.TRACE_CAP]

    def record_launch(self, key: Hashable) -> None:
        self.launches[key] = self.launches.get(key, 0) + 1
        self.seen_buckets.add(key)
        self.trace.append(key)
        self._trim(self.trace)

    def record_fallback(self, resident_max: int, traced_len: int) -> None:
        self.fallback_launches += 1
        self.fallback_trace.append((int(resident_max), int(traced_len)))
        self._trim(self.fallback_trace)


class PlanCache:
    """LRU cache of plans (or plan-derived values such as bound steps).
    ``capacity`` of 0/None = unbounded."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity or None
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.stats = PlanCacheStats()

    def get_or_build(self, key: Hashable, build: Callable[[], Any]) -> Any:
        if key in self._entries:
            self._entries.move_to_end(key)
            self.stats.hits += 1
            value = self._entries[key]
        else:
            self.stats.misses += 1
            value = build()
            self._entries[key] = value
            if self.capacity and len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        self.stats.record_launch(key)
        return value

    def cache_info(self) -> CacheInfo:
        """lru_cache-style counters (observability)."""
        return CacheInfo(self.stats.hits, self.stats.misses,
                         self.capacity, len(self._entries))

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self):
        return self._entries.keys()

    def items(self):
        return self._entries.items()
