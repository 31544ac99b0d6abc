"""ShardedServingEngine: the mesh-native request-lifecycle engine.

Counterpart of ``repro.shard.engine``.  It consumes a resolved
:class:`~repro_torch.shard.ShardPlan`: one
:class:`~repro_torch.serving.ServingEngine` per dp shard, each bound to
its ``(1, sp)`` sub-grid, with its own scheduler, cache manager and page
budget, and the topology's shared per-shard
:class:`~repro_torch.plan.PlanCache`.  One controller drives every shard
in this process.  The surface is the single engine's, submit / step /
stream / drain, with a routing layer in front:

- **submit** routes each request to the least-loaded shard
  (:func:`pick_shard`: ties break on the lowest shard index), so a
  request admits against its shard's free slots and page budget, never
  the aggregate.
- **step** runs one step on every shard with work and maps the shards'
  event handles back to the global ones.
- **drain** runs every shard to completion, merges completions by
  ``request_id``, and with ``ServeConfig.stats_path`` writes one stats
  dump: every shard's :meth:`~repro_torch.plan.PlanCacheStats.to_json`
  snapshot and the :func:`~repro_torch.plan.merge_stats_snapshots`
  aggregate.

A sampler draws from the request's seed and the absolute token position,
never the slot or the engine, so a shard's streams are those of a
single-device engine fed the same requests.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ServeConfig
from repro_torch.models.registry import Model
from repro_torch.obs import atomic_write_json, resolve_obs
from repro_torch.plan import merge_stats_snapshots
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.events import Event
from repro_torch.serving.sampling import Sampler
from repro_torch.serving.scheduler import Completion, Request
from repro_torch.shard.resolver import ShardPlan, ShardResolver
from repro_torch.shard.spec import ShardSpec


def pick_shard(loads: Sequence[int]) -> int:
    """Least-loaded shard, lowest index on ties: deterministic, so a
    request stream maps to the same shards on every run."""
    return min(range(len(loads)), key=lambda d: (loads[d], d))


class ShardedServingEngine:
    """dp x sp mesh-native serving over per-shard ServingEngines."""

    def __init__(self, model: Model, scfg: ServeConfig, *,
                 spec: Optional[ShardSpec] = None,
                 plan: Optional[ShardPlan] = None,
                 max_len: int = 256,
                 policy: Optional[str] = None,
                 sampler: Optional[Sampler] = None,
                 prefill_mode: Optional[str] = None,
                 tune_table: Optional[Any] = None,
                 tune_impl: Optional[str] = None,
                 devices: Optional[Sequence[Any]] = None,
                 obs: Optional[Any] = None):
        """``devices`` (None: the visible CUDA devices, each once) is the
        grid's device list; it may repeat a device, as
        ``[torch.device("cpu")] * n`` does in the tests and ``[cuda:0] *
        n`` on one card.  The other arguments are
        :class:`~repro_torch.serving.ServingEngine`'s, given to every
        shard."""
        if plan is not None:
            spec = plan.spec
        elif spec is None:
            if scfg.shard is None:
                raise ValueError(
                    "no topology: pass spec=/plan= or set "
                    "ServeConfig.shard (e.g. shard='4,2')")
            spec = ShardSpec.parse(scfg.shard)
        layout = scfg.cache_layout
        if plan is None:
            plan = ShardResolver(spec).resolve(
                max_len=max_len, cache_layout=layout,
                page_size=scfg.cache_page_size, devices=devices)
        self.spec = spec
        self.plan = plan
        self.model = model
        self.cfg = model.cfg
        self.scfg = scfg
        self.max_len = max_len
        self._stats_path = scfg.stats_path
        self._trace_path = scfg.trace_path
        self._metrics_path = scfg.metrics_path
        # one observer for the topology: each shard gets a view sharing
        # its clock, tracer and metrics, so every shard's spans land on
        # one timeline and the metric families merge
        if obs is not None:
            self._obs = obs
            self._owns_obs = False
        else:
            self._obs = resolve_obs(scfg)
            self._owns_obs = self._obs.enabled

        # the shards' ServeConfig: the shard budget replaces the
        # engine-wide one; stats_path, shard, trace_path and metrics_path
        # belong to this layer
        core_cfg = dataclasses.replace(
            scfg, stats_path=None, shard=None,
            trace_path=None, metrics_path=None,
            cache_page_budget=(spec.page_budget_per_shard
                               if spec.page_budget_per_shard is not None
                               else scfg.cache_page_budget))
        # engine identity for the shared per-topology PlanCache: every
        # knob a plan or a bound step depends on.  A bound step takes
        # the engine it runs for as its first argument
        # (ServingEngine._build), so two engines of one identity share
        # its entries and each runs them on its own storage.
        ident = (self.cfg.name, policy or scfg.split_policy, max_len,
                 spec.slots_per_shard, layout,
                 scfg.kv_quant or scfg.kv_cache_dtype,
                 scfg.prefill_bucket, scfg.seqlen_bucket,
                 scfg.num_splits_override, prefill_mode, spec.params,
                 type(sampler).__name__ if sampler is not None else None,
                 tune_table.version if tune_table is not None
                 else scfg.tune_table_path, tune_impl)
        self.cores: List[ServingEngine] = []
        for d in range(spec.dp):
            self.cores.append(ServingEngine(
                model, core_cfg,
                max_len=max_len, batch_slots=spec.slots_per_shard,
                policy=policy, sampler=sampler,
                prefill_mode=prefill_mode,
                tune_table=tune_table, tune_impl=tune_impl,
                mesh=plan.submeshes[d],
                plan_cache=plan.plan_cache(
                    d, ident, scfg.plan_cache_capacity),
                shard_id=d, param_policy=spec.params,
                obs=(self._obs.shard_view(d) if self._obs.enabled
                     else None)))

        # routing state: global handle <-> (shard, shard-local handle)
        self._routes: Dict[int, Tuple[int, int]] = {}
        self._back: Dict[Tuple[int, int], int] = {}
        self._routed: List[List[int]] = [[] for _ in range(spec.dp)]
        self._next_handle = 0

    # --- capacity / identity -------------------------------------------------

    @property
    def B(self) -> int:
        """Aggregate decode slots (dp x slots_per_shard)."""
        return self.spec.total_slots

    @property
    def prefill_mode(self) -> str:
        return self.cores[0].prefill_mode

    @property
    def tune_table(self) -> Optional[Any]:
        return self.cores[0].tune_table

    # single-engine surface (launcher prints, quick inspection): shard 0
    # stands in for "the" scheduler and stats; per-shard truth is
    # shard_stats() / describe()
    @property
    def sched(self) -> Any:
        return self.cores[0].sched

    @property
    def stats(self) -> Any:
        return self.cores[0].stats

    def cache_stats(self) -> Dict[str, Any]:
        return self.cores[0].cache_stats()

    def planned_prefill_buckets(self) -> List[int]:
        buckets = set()
        for core in self.cores:
            buckets.update(core.planned_prefill_buckets())
        return sorted(buckets)

    def routed(self, d: int) -> List[int]:
        """The request_ids routed to shard ``d``, in submit order (what a
        single-device oracle of the shard is fed)."""
        return list(self._routed[d])

    # --- state ---------------------------------------------------------------

    def load(self, params) -> None:
        """Bind ``params`` in every shard: each core keeps them on its
        lead device, a copy only where that device is not theirs."""
        for core in self.cores:
            core.load(params)

    # --- request lifecycle ---------------------------------------------------

    def _load_of(self, d: int) -> int:
        core = self.cores[d]
        return len(core.sched.pending) + len(core.sched.live())

    def validate(self, req: Request) -> None:
        self.cores[0].validate(req)

    def submit(self, req: Request) -> int:
        """Route to the least-loaded shard and enqueue there.  The
        returned handle is global; admission happens on a later
        :meth:`step`, against THAT shard's slots and page budget."""
        d = pick_shard([self._load_of(i) for i in range(self.spec.dp)])
        ch = self.cores[d].submit(req)
        g = self._next_handle
        self._next_handle += 1
        self._routes[g] = (d, ch)
        self._back[(d, ch)] = g
        self._routed[d].append(req.request_id)
        return g

    def has_work(self) -> bool:
        return any(core.has_work() for core in self.cores)

    def _remap(self, d: int, evs: List[Event]) -> List[Event]:
        return [dataclasses.replace(ev, handle=self._back[(d, ev.handle)])
                for ev in evs]

    def step(self) -> List[Event]:
        """One scheduling step on every shard with work; events carry
        GLOBAL handles."""
        events: List[Event] = []
        for d, core in enumerate(self.cores):
            if core.has_work():
                events.extend(self._remap(d, core.step()))
        return events

    def stream(self, handle: int) -> Iterator[Event]:
        """Iterate one global handle's events (pumps only its shard)."""
        if handle not in self._routes:
            raise ValueError(f"handle {handle} is unknown or drained")
        d, ch = self._routes[handle]
        for ev in self.cores[d].stream(ch):
            yield dataclasses.replace(ev, handle=handle)

    def drain(self) -> List[Completion]:
        """Run every shard to completion; completions merge sorted by
        ``request_id``.  With ``ServeConfig.stats_path`` set, the merged
        per-shard + aggregate stats dump is written here (the per-core
        configs carry ``stats_path=None`` on purpose)."""
        done: List[Completion] = []
        for core in self.cores:
            done.extend(core.drain())
        done.sort(key=lambda c: c.request_id)
        if self._stats_path:
            self.dump_stats(self._stats_path)
        if self._owns_obs:
            self.dump_obs()
        return done

    # --- observability -------------------------------------------------------

    def shard_stats(self) -> List[Dict[str, Any]]:
        """Per-shard PlanCacheStats snapshots, annotated with shard
        identity (index, devices, policy, table)."""
        out = []
        for d, core in enumerate(self.cores):
            snap = core.stats.to_json()
            snap["shard"] = d
            snap["devices"] = [str(x) for x in
                               self.plan.shard_devices(d)]
            snap["policy"] = core.policy
            if core.tune_table is not None:
                snap["table_version"] = core.tune_table.version
            out.append(snap)
        return out

    def aggregate_stats(self) -> Dict[str, Any]:
        """The cross-shard counter sum (merge_stats_snapshots)."""
        return merge_stats_snapshots(
            [core.stats.to_json() for core in self.cores])

    def _stats_snapshot(self) -> Dict[str, Any]:
        """The topology's stats dump: per-shard PlanCacheStats sections
        and the :func:`merge_stats_snapshots` aggregate."""
        return {
            "topology": self.spec.describe(),
            "fingerprint": self.plan.fingerprint,
            "shards": self.shard_stats(),
            "aggregate": self.aggregate_stats(),
        }

    def dump_stats(self, path: str) -> None:
        """One stats file for the whole topology, written atomically
        (temp file, then ``os.replace``): per-shard sections and the
        aggregate."""
        atomic_write_json(path, self._stats_snapshot())

    def dump_obs(self) -> None:
        """Write the topology's trace / metrics artifacts (no-op when
        neither path is set or the observer was injected)."""
        if self._obs.enabled and (self._trace_path or self._metrics_path):
            self._obs.dump(self._trace_path, self._metrics_path,
                           plan_stats=self._stats_snapshot())

    def describe(self) -> List[Dict[str, Any]]:
        """Per-shard admission and residency summary (the serving CLI
        prints one row a shard after drain)."""
        rows = []
        for d, core in enumerate(self.cores):
            row: Dict[str, Any] = {
                "shard": d,
                "devices": [str(x) for x in self.plan.shard_devices(d)],
                "slots": core.B,
                "live": len(core.sched.live()),
                "pending": len(core.sched.pending),
                "routed": len(self._routed[d]),
                "launches": core.stats.total_launches,
            }
            cs = core.cache_stats()
            if core.cache.is_paged:
                row["total_pages"] = cs["total_pages"]
                row["free_pages"] = cs["free_pages"]
            rows.append(row)
        return rows

    def planned_splits(self) -> Dict[int, int]:
        """bucket -> frozen num_splits over every shard's resident decode
        plans (the shards of a topology make the same decision a
        bucket)."""
        out: Dict[int, int] = {}
        for core in self.cores:
            out.update(core.planned_splits())
        return out

    def check_conservation(self) -> None:
        """Page conservation on every shard's cache manager (its
        messages carry the ``shard{d}`` label)."""
        for core in self.cores:
            if core.cache.is_paged:
                core.cache.check_conservation()
