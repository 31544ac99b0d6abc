"""Observer: the engine-facing observability facade.

Counterpart of ``repro.obs.observer``.  One Observer per serving
engine, resolved from :class:`~repro_torch.obs.config.ObsConfig`.  It
owns the injectable monotonic clock (one epoch + a shared
non-decreasing clamp, so every shard view's timestamps merge onto ONE
timeline), the :class:`~repro_torch.obs.Tracer` (when tracing is on)
and the :class:`~repro_torch.obs.MetricsRegistry` (when metrics are
on), and exposes the narrow ``on_*`` hook surface the
:class:`~repro_torch.serving.ServingEngine` calls at its admission /
launch / finish sites.

Strictly host-side and zero-cost when disabled: the engine guards every
call with ``if self._obs.enabled:``, and the disabled singleton is
:data:`NULL_OBSERVER` (``enabled = False``, every hook a no-op): no
per-step allocation, no clock read, ``policy_eval_count`` stays 0 and
greedy streams stay bit-identical with tracing on
(``tests/test_torch_obs.py``).  A launch span closes at the host copy
that already waits for the launch; nothing here synchronizes the card.

:meth:`Observer.shard_view` is kept as the reference has it (views share
the tracer, registry and clock, bind ``pid = shard`` on trace tracks and
``shard=d`` labels on every metric series), for the multi-device
serving the port does not have yet.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.obs.io import atomic_write_json, atomic_write_text
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer


def plan_provenance(key: Any, plan: Any) -> Dict[str, Any]:
    """JSON-safe LaunchPlan provenance for a launch span's ``args``.

    The four acceptance-critical keys — ``num_splits``, ``mesh_splits``,
    ``kv_dtype``, ``table_version`` — are ALWAYS present (null when the
    launch rode the internal-heuristic fallback and had no plan).  A
    plan made for a mesh (``Planner.mesh_plan``, a sequence-sharded
    shard's) stamps its ``mesh_splits``, and its ``seq_shard_axis`` where
    it runs sequence-sharded (``seq_shard_mesh`` set), as the
    reference's; a plan made without a mesh leaves both null.  No
    ``impl`` is stamped (the kernel follows the tensor's device)."""
    d: Dict[str, Any] = {
        "key": ("/".join(map(str, key)) if isinstance(key, tuple)
                else "fallback" if key is None else str(key)),
        "num_splits": None, "mesh_splits": None, "seq_shard_axis": None,
        "kv_dtype": None, "tuned": None, "table_version": None,
    }
    if plan is not None:
        d.update(num_splits=plan.num_splits, tuned=plan.tuned,
                 table_version=plan.table_version, policy=plan.policy,
                 bucket=plan.bucket)
        if plan.seq_shard_axis is not None:
            d.update(mesh_splits=plan.mesh_splits,
                     seq_shard_axis=(plan.seq_shard_axis
                                     if plan.seq_shard_mesh is not None
                                     else None))
        w = plan.workload
        if w is not None:
            d["kv_dtype"] = w.kv_dtype_name
            d["dtype_bytes"] = w.dtype_bytes
    return d


class _Rec:
    """Per-in-flight-request host record (popped at finish)."""
    __slots__ = ("t_submit", "t_admit0", "t_first", "request_id",
                 "prompt_len", "kind", "ntokens")

    def __init__(self, t_submit: int, request_id: int,
                 prompt_len: int) -> None:
        self.t_submit = t_submit
        self.t_admit0: Optional[int] = None
        self.t_first: Optional[int] = None
        self.request_id = request_id
        self.prompt_len = prompt_len
        self.kind: Optional[str] = None
        self.ntokens = 0


class NullObserver:
    """The disabled observer: every hook a no-op, ``enabled = False``
    (engines branch on the flag, so the hot path never even calls in)."""

    enabled = False

    def shard_view(self, pid: int, name: str = "") -> "NullObserver":
        return self

    def now_us(self) -> int:
        return 0

    def on_submit(self, *a: Any, **k: Any) -> None: ...
    def on_admit_start(self, *a: Any, **k: Any) -> None: ...
    def on_admit_end(self, *a: Any, **k: Any) -> None: ...
    def on_launch(self, *a: Any, **k: Any) -> None: ...
    def on_token(self, *a: Any, **k: Any) -> None: ...
    def on_finish(self, *a: Any, **k: Any) -> None: ...
    def on_warning(self, *a: Any, **k: Any) -> None: ...
    def sample_occupancy(self, *a: Any, **k: Any) -> None: ...

    def metrics_snapshot(self, plan_stats: Any = None) -> Dict[str, Any]:
        return {}

    def prometheus(self, plan_stats: Any = None) -> str:
        return ""

    def dump(self, *a: Any, **k: Any) -> None: ...


NULL_OBSERVER = NullObserver()


class Observer:
    """Enabled observer (see module docstring for the contract)."""

    enabled = True

    def __init__(self, *, tracer: Optional[Tracer],
                 metrics: Optional[MetricsRegistry],
                 clock: Optional[Callable[[], float]] = None,
                 process_name: str = "serve", pid: int = 0,
                 labels: Optional[Dict[str, str]] = None,
                 parent: Optional["Observer"] = None) -> None:
        self.tracer = tracer
        self.metrics = metrics
        self.pid = pid
        self.process_name = process_name
        self.labels = dict(labels or {})
        if parent is None:
            self._clock = clock if clock is not None else time.monotonic
            self._epoch = self._clock()
            self._last = [0]            # shared monotonic clamp (views)
        else:
            self._clock = parent._clock
            self._epoch = parent._epoch
            self._last = parent._last
        self._recs: Dict[int, _Rec] = {}
        if tracer is not None:
            # a shard view renames the pid its parent pre-registered
            # under the generic engine name (force=True)
            tracer.ensure_process(pid, process_name,
                                  force=parent is not None)
            tracer.ensure_thread(pid, 0, "launches")
        if metrics is not None:
            self._bind_metrics(metrics)

    def _bind_metrics(self, m: MetricsRegistry) -> None:
        lb = self.labels
        self._m_submitted = m.counter(
            "requests_submitted_total", "requests accepted by submit()"
        ).labels(**lb)
        self._m_finished = m.counter(
            "requests_finished_total",
            "finished requests by finish_reason")
        self._m_tokens = m.counter(
            "tokens_total", "generated tokens emitted").labels(**lb)
        self._m_prefix_rows = m.counter(
            "prefix_shared_rows_total",
            "prompt rows adopted from shared prefix pages").labels(**lb)
        self._m_prefix_bytes = m.counter(
            "prefix_shared_bytes_total",
            "KV bytes those adopted rows did not recompute").labels(**lb)
        self._m_warnings = m.counter(
            "engine_warnings_total",
            "structured engine warnings by code (each occurrence; the "
            "python warnings.warn compat shim still fires once)")
        self._m_ttft = m.histogram(
            "ttft_ms", "time to first token (submit -> first TOKEN), ms"
        ).labels(**lb)
        self._m_tpot = m.histogram(
            "tpot_ms", "time per output token after the first, ms"
        ).labels(**lb)
        self._m_queue_wait = m.histogram(
            "queue_wait_ms", "submit -> admission start, ms").labels(**lb)
        self._m_launch = m.histogram(
            "launch_ms", "wall-clock per launch by kind, ms")
        self._m_launches = m.counter(
            "launches_total", "launches by kind")
        self._m_slots_live = m.gauge(
            "slots_live", "occupied decode slots (last step)").labels(**lb)
        self._m_slots_total = m.gauge(
            "slots_total", "decode slot capacity").labels(**lb)
        self._m_queue_depth = m.gauge(
            "queue_depth", "pending not-yet-admitted requests"
        ).labels(**lb)
        self._m_pages_free = m.gauge(
            "pages_free", "free KV pages (paged layout)").labels(**lb)
        self._m_pages_total = m.gauge(
            "pages_total", "KV page-pool capacity (paged layout)"
        ).labels(**lb)

    # --- clock --------------------------------------------------------------

    def now_us(self) -> int:
        """Microseconds since the (shared) epoch, clamped non-decreasing
        across every view of this observer — one merged timeline."""
        us = int((self._clock() - self._epoch) * 1e6)
        if us < self._last[0]:
            us = self._last[0]
        else:
            self._last[0] = us
        return us

    def shard_view(self, pid: int, name: str = "") -> "Observer":
        """A per-shard view: same tracer / registry / clock, trace
        tracks under ``pid`` and every metric labeled ``shard=pid``."""
        labels = dict(self.labels)
        labels["shard"] = str(pid)
        return Observer(tracer=self.tracer, metrics=self.metrics,
                        process_name=name or f"shard{pid}", pid=pid,
                        labels=labels, parent=self)

    # --- request lifecycle hooks --------------------------------------------

    def on_submit(self, handle: int, request_id: int,
                  prompt_len: int) -> None:
        ts = self.now_us()
        self._recs[handle] = _Rec(ts, request_id, prompt_len)
        if self.tracer is not None:
            self.tracer.ensure_thread(self.pid, handle + 1,
                                      f"req{request_id}")
        if self.metrics is not None:
            self._m_submitted.inc()

    def on_admit_start(self, handle: int) -> None:
        r = self._recs.get(handle)
        if r is None:
            return
        ts = self.now_us()
        r.t_admit0 = ts
        if self.tracer is not None:
            self.tracer.complete(self.pid, handle + 1, "queue_wait",
                                 "request", r.t_submit, ts - r.t_submit)
        if self.metrics is not None:
            self._m_queue_wait.observe((ts - r.t_submit) / 1e3)

    def on_admit_end(self, handle: int, kind: str, shared_rows: int = 0,
                     shared_bytes: int = 0) -> None:
        r = self._recs.get(handle)
        if r is None:
            return
        ts = self.now_us()
        r.kind = kind
        t0 = r.t_admit0 if r.t_admit0 is not None else ts
        if self.tracer is not None:
            args: Dict[str, Any] = {"prefill": kind}
            if shared_rows:
                args["shared_rows"] = int(shared_rows)
            self.tracer.complete(self.pid, handle + 1, "admit",
                                 "request", t0, ts - t0, args)
        if self.metrics is not None and shared_rows:
            self._m_prefix_rows.inc(int(shared_rows))
            self._m_prefix_bytes.inc(int(shared_bytes))

    def on_launch(self, kind: str, key: Any, plan: Any, t0: int,
                  handles: Sequence[int] = ()) -> None:
        """Close one launch span ``[t0, now)`` on the pid's "launches"
        track, stamped with the plan's provenance; ``handles`` mirror
        the span onto each rider's request track (decode/verify rows)."""
        t1 = self.now_us()
        if self.tracer is not None:
            self.tracer.complete(self.pid, 0, kind, "launch", t0, t1 - t0,
                                 plan_provenance(key, plan))
            for h in handles:
                if h in self._recs:
                    self.tracer.complete(self.pid, h + 1, kind, "step",
                                         t0, t1 - t0)
        if self.metrics is not None:
            self._m_launches.inc(1, kind=kind, **self.labels)
            self._m_launch.observe((t1 - t0) / 1e3, kind=kind,
                                   **self.labels)

    def on_token(self, handle: int, index: int) -> None:
        r = self._recs.get(handle)
        if r is None:
            return
        r.ntokens = index + 1
        if index == 0 and r.t_first is None:
            ts = self.now_us()
            r.t_first = ts
            if self.tracer is not None:
                self.tracer.instant(self.pid, handle + 1, "first_token",
                                    "request", ts)
            if self.metrics is not None:
                self._m_ttft.observe((ts - r.t_submit) / 1e3)
        if self.metrics is not None:
            self._m_tokens.inc()

    def on_finish(self, handle: int, reason: str) -> None:
        r = self._recs.pop(handle, None)
        if r is None:
            return
        ts = self.now_us()
        if self.tracer is not None:
            self.tracer.complete(
                self.pid, handle + 1, "request", "request",
                r.t_submit, ts - r.t_submit,
                {"request_id": r.request_id, "prompt_len": r.prompt_len,
                 "prefill": r.kind, "finish_reason": reason,
                 "tokens": r.ntokens})
        if self.metrics is not None:
            self._m_finished.inc(1, reason=reason, **self.labels)
            if r.t_first is not None and r.ntokens > 1:
                self._m_tpot.observe(
                    (ts - r.t_first) / 1e3 / (r.ntokens - 1))

    def on_warning(self, code: str, message: str) -> None:
        """One structured warning occurrence (counted per event — the
        once-per-engine python ``warnings.warn`` compat shim is the
        engine's job, not ours)."""
        if self.tracer is not None:
            self.tracer.instant(self.pid, 0, f"warning:{code}", "warning",
                                self.now_us(),
                                {"message": str(message)[:300]})
        if self.metrics is not None:
            self._m_warnings.inc(1, code=code, **self.labels)

    def sample_occupancy(self, live: int, slots: int, queue_depth: int,
                         free_pages: Optional[int] = None,
                         total_pages: Optional[int] = None) -> None:
        if self.metrics is None:
            return
        self._m_slots_live.set(live)
        self._m_slots_total.set(slots)
        self._m_queue_depth.set(queue_depth)
        if free_pages is not None:
            self._m_pages_free.set(free_pages)
        if total_pages is not None:
            self._m_pages_total.set(total_pages)

    # --- export -------------------------------------------------------------

    def metrics_snapshot(self, plan_stats: Any = None) -> Dict[str, Any]:
        """The JSON metrics artifact: every registry family (series +
        aggregate) plus, when given, the PlanCacheStats section —
        ``PlanCacheStats.to_json()`` verbatim (shape preserved) for a
        single engine, ``{"shards": [...], "aggregate": merge}`` for a
        sharded one."""
        snap: Dict[str, Any] = {
            "metrics": self.metrics.snapshot()
            if self.metrics is not None else {},
        }
        if plan_stats is not None:
            snap["plan_cache"] = plan_stats
        return snap

    def prometheus(self, plan_stats: Any = None) -> str:
        """Prometheus text exposition: the registry families plus the
        absorbed PlanCacheStats scalar counters
        (``repro_plan_cache_<name>``, per-shard labeled + aggregate
        under a sharded topology)."""
        text = (self.metrics.prometheus()
                if self.metrics is not None else "")
        lines: List[str] = []

        def scalars(snap: Dict[str, Any], label: str = "") -> None:
            for k in sorted(snap):
                v = snap[k]
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                lines.append(f"repro_plan_cache_{k}{label} {v:g}")

        if isinstance(plan_stats, dict):
            if "shards" in plan_stats \
                    and isinstance(plan_stats["shards"], list):
                for s in plan_stats["shards"]:
                    d = s.get("shard", 0)
                    scalars(s, '{shard="%s"}' % d)
                scalars(plan_stats.get("aggregate", {}))
            else:
                scalars(plan_stats)
        return text + ("\n".join(lines) + "\n" if lines else "")

    def dump(self, trace_path: Optional[str] = None,
             metrics_path: Optional[str] = None,
             plan_stats: Any = None) -> None:
        """Write the artifacts (atomic).  ``metrics_path`` ending in
        ``.prom``/``.txt`` selects the Prometheus text exposition;
        anything else gets the JSON snapshot."""
        if trace_path and self.tracer is not None:
            self.tracer.artifact().save(trace_path)
        if metrics_path and self.metrics is not None:
            if str(metrics_path).endswith((".prom", ".txt")):
                atomic_write_text(metrics_path,
                                  self.prometheus(plan_stats))
            else:
                atomic_write_json(metrics_path,
                                  self.metrics_snapshot(plan_stats))
