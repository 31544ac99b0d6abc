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
    length it covered and the padded length the policy saw.  ``spec_*``
    count speculative decoding: one ``spec_steps`` per drafting slot of
    a verify launch, the draft tokens proposed and accepted, every token
    those slots emitted (accepted drafts plus correction or bonus rows),
    and the requests that gave up after ``SpecConfig.max_rejects``.
    ``measured_*`` count the ``measured`` policy's SplitTable lookups and
    those the table's grid did not cover (decided by its fallback
    policy), with each fallback's family key and L_K;
    ``table_registry_fallbacks`` counts engines whose table registry
    held no table matching the live device.  The serving engine routes
    the table's counts here (``SplitTable.attach_stats``).
    """
    TRACE_CAP = 4096

    hits: int = 0
    misses: int = 0
    launches: Dict[Hashable, int] = field(default_factory=dict)
    trace: List[Hashable] = field(default_factory=list)
    seen_buckets: Set[Hashable] = field(default_factory=set)
    fallback_launches: int = 0
    fallback_trace: List[tuple] = field(default_factory=list)
    measured_lookups: int = 0
    measured_fallbacks: int = 0
    # (batch, Hq, Hkv, head_dim, impl, dtype_bytes, kv_dtype, L_K) per
    # fallback
    measured_fallback_trace: List[tuple] = field(default_factory=list)
    spec_steps: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_emitted: int = 0
    spec_disabled: int = 0
    table_registry_fallbacks: int = 0

    @property
    def total_launches(self) -> int:
        return self.hits + self.misses

    @property
    def spec_acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens that verified (0.0 when no
        drafts were proposed)."""
        return (self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0)

    @property
    def spec_tokens_per_step(self) -> float:
        """Tokens emitted per verify step (0.0 when none ran)."""
        return (self.spec_emitted / self.spec_steps
                if self.spec_steps else 0.0)

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

    def record_measured(self, key: tuple, fallback: bool) -> None:
        """One ``measured`` lookup; ``fallback=True``: the table's grid
        did not cover ``key`` (family + L_K) and the fallback decided."""
        self.measured_lookups += 1
        if fallback:
            self.measured_fallbacks += 1
            self.measured_fallback_trace.append(tuple(key))
            self._trim(self.measured_fallback_trace)

    def record_spec_step(self, proposed: int, accepted: int,
                         emitted: int) -> None:
        """One speculative verify launch's drafting slot: ``proposed``
        draft tokens went in, ``accepted`` survived, ``emitted`` tokens
        came out."""
        self.spec_steps += 1
        self.spec_proposed += int(proposed)
        self.spec_accepted += int(accepted)
        self.spec_emitted += int(emitted)

    def record_spec_disabled(self) -> None:
        """One request gave up on speculation (``max_rejects``
        consecutive zero-accept verify steps)."""
        self.spec_disabled += 1

    def to_json(self) -> Dict[str, Any]:
        """JSON-safe snapshot of every counter (tuple keys flattened to
        ``"a/b"`` strings), as the reference's."""
        def k2s(k: Hashable) -> str:
            return "/".join(map(str, k)) if isinstance(k, tuple) else str(k)

        return {
            "hits": self.hits,
            "misses": self.misses,
            "total_launches": self.total_launches,
            "distinct_buckets": self.distinct_buckets,
            "launches": {k2s(k): v for k, v in self.launches.items()},
            "seen_buckets": sorted(k2s(k) for k in self.seen_buckets),
            "fallback_launches": self.fallback_launches,
            "fallback_trace": [list(t) for t in self.fallback_trace],
            "measured_lookups": self.measured_lookups,
            "measured_fallbacks": self.measured_fallbacks,
            "measured_fallback_trace": [
                list(t) for t in self.measured_fallback_trace],
            "spec_steps": self.spec_steps,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_emitted": self.spec_emitted,
            "spec_disabled": self.spec_disabled,
            "spec_acceptance_rate": round(self.spec_acceptance_rate, 4),
            "spec_tokens_per_step": round(self.spec_tokens_per_step, 4),
            "table_registry_fallbacks": self.table_registry_fallbacks,
        }

    def reset(self) -> None:
        self.hits = 0
        self.misses = 0
        self.launches.clear()
        self.trace.clear()
        self.seen_buckets.clear()
        self.fallback_launches = 0
        self.fallback_trace.clear()
        self.measured_lookups = 0
        self.measured_fallbacks = 0
        self.measured_fallback_trace.clear()
        self.spec_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.spec_disabled = 0
        self.table_registry_fallbacks = 0


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

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def keys(self):
        return self._entries.keys()

    def values(self):
        return self._entries.values()

    def items(self):
        return self._entries.items()


# keys of PlanCacheStats.to_json() that merge by summation (everything
# the per-shard engines count independently)
_MERGE_SUM_KEYS = (
    "hits", "misses", "total_launches", "fallback_launches",
    "measured_lookups", "measured_fallbacks", "spec_steps",
    "spec_proposed", "spec_accepted", "spec_emitted", "spec_disabled",
    "table_registry_fallbacks",
)


def merge_stats_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-shard :meth:`PlanCacheStats.to_json` snapshots into one
    (the ``repro_torch.shard`` engine's stats dump carries both the
    per-shard sections and this merge).  Counters sum; launches sum per
    key; ``seen_buckets`` is the union (``distinct_buckets`` its size);
    traces concatenate in shard order, trimmed to ``TRACE_CAP``; the
    speculation rates are recomputed from the summed counters.  Other
    keys a caller added to a snapshot (``policy``, ``shard``, ...) are
    ignored."""
    out: Dict[str, Any] = {k: 0 for k in _MERGE_SUM_KEYS}
    launches: Dict[str, int] = {}
    seen: Set[str] = set()
    fallback_trace: List[list] = []
    measured_fallback_trace: List[list] = []
    for s in snaps:
        for k in _MERGE_SUM_KEYS:
            out[k] += int(s.get(k, 0))
        for k, v in s.get("launches", {}).items():
            launches[k] = launches.get(k, 0) + int(v)
        seen.update(s.get("seen_buckets", ()))
        fallback_trace.extend(s.get("fallback_trace", ()))
        measured_fallback_trace.extend(s.get("measured_fallback_trace", ()))
    cap = PlanCacheStats.TRACE_CAP
    out["launches"] = launches
    out["seen_buckets"] = sorted(seen)
    out["distinct_buckets"] = len(seen)
    out["fallback_trace"] = fallback_trace[-cap:]
    out["measured_fallback_trace"] = measured_fallback_trace[-cap:]
    out["spec_acceptance_rate"] = round(
        out["spec_accepted"] / out["spec_proposed"]
        if out["spec_proposed"] else 0.0, 4)
    out["spec_tokens_per_step"] = round(
        out["spec_emitted"] / out["spec_steps"]
        if out["spec_steps"] else 0.0, 4)
    out["shards"] = len(snaps)
    return out
