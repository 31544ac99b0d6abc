"""Tracer -> TraceArtifact: Chrome trace-event JSON, Perfetto-loadable.

Counterpart of ``repro.obs.trace``, unchanged: the module is
host-side Python with no device code.

The :class:`Tracer` is a pure host-side event sink — timestamps are
computed by the :class:`~repro_torch.obs.observer.Observer` (which owns the
injectable monotonic clock) and passed in as already-monotonic
microsecond ints.  Events use the Chrome trace-event JSON format
(https://ui.perfetto.dev loads the artifact directly):

- ``ph="X"`` complete spans (``ts`` + ``dur`` in microseconds);
- ``ph="i"`` thread-scoped instant events (first token, warnings);
- ``ph="M"`` process/thread-name metadata, emitted once per track.

Track layout: ``pid`` is the shard index (process_name ``shard{d}``
under a sharded topology, the engine name otherwise); ``tid 0`` is the
"launches" track carrying per-launch spans stamped with LaunchPlan
provenance; ``tid = handle + 1`` is one track per request carrying its
lifecycle spans (queue_wait / admit / per-step decode/verify rows under
the enclosing "request" span).

:func:`validate_trace` is the schema gate the obs smoke and the trace
tests assert through: key/type checks per event plus per-track nesting
consistency — on any one (pid, tid) track, X spans must form a proper
forest (contained or disjoint, never partially overlapping) with
non-negative durations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.obs.io import atomic_write_json

_PH = ("X", "i", "M")
_META_NAMES = ("process_name", "thread_name")


class Tracer:
    """Append-only Chrome trace-event sink (host side, no clock)."""

    def __init__(self) -> None:
        self._events: List[Dict[str, Any]] = []
        self._procs: Dict[int, Dict[str, Any]] = {}
        self._threads: Dict[tuple, str] = {}

    def __len__(self) -> int:
        return len(self._events)

    # --- metadata (once per track) ------------------------------------------

    def ensure_process(self, pid: int, name: str,
                       force: bool = False) -> None:
        """Register a pid's process name once; ``force`` renames an
        already-registered pid in place (a shard view claiming the pid
        its parent registered under the generic engine name)."""
        ev = self._procs.get(pid)
        if ev is not None:
            if force and ev["args"]["name"] != name:
                ev["args"]["name"] = name
            return
        ev = {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
              "ts": 0, "args": {"name": name}}
        self._procs[pid] = ev
        self._events.append(ev)

    def ensure_thread(self, pid: int, tid: int, name: str) -> None:
        if (pid, tid) in self._threads:
            return
        self._threads[(pid, tid)] = name
        self._events.append({"name": "thread_name", "ph": "M",
                             "pid": pid, "tid": tid, "ts": 0,
                             "args": {"name": name}})

    # --- events -------------------------------------------------------------

    def complete(self, pid: int, tid: int, name: str, cat: str,
                 ts: int, dur: int,
                 args: Optional[Dict[str, Any]] = None) -> None:
        ev: Dict[str, Any] = {"name": name, "cat": cat, "ph": "X",
                              "pid": pid, "tid": tid,
                              "ts": int(ts), "dur": max(0, int(dur))}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def instant(self, pid: int, tid: int, name: str, cat: str, ts: int,
                args: Optional[Dict[str, Any]] = None) -> None:
        ev: Dict[str, Any] = {"name": name, "cat": cat, "ph": "i",
                              "pid": pid, "tid": tid, "ts": int(ts),
                              "s": "t"}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def artifact(self) -> "TraceArtifact":
        """Snapshot the events recorded so far (list is copied — the
        tracer keeps recording; a later artifact supersedes)."""
        return TraceArtifact(events=list(self._events))


@dataclass
class TraceArtifact:
    """The exported trace: ``{"traceEvents": [...]}`` + helpers."""

    events: List[Dict[str, Any]] = field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def save(self, path: Any) -> None:
        atomic_write_json(path, self.to_json())

    @classmethod
    def load(cls, path: Any) -> "TraceArtifact":
        import json
        from pathlib import Path
        obj = json.loads(Path(path).read_text())
        return cls(events=obj["traceEvents"])

    def validate(self) -> None:
        validate_trace(self.to_json())

    # --- query helpers (tests / smoke assertions) ---------------------------

    def spans(self, name: Optional[str] = None,
              cat: Optional[str] = None) -> List[Dict[str, Any]]:
        return [e for e in self.events if e["ph"] == "X"
                and (name is None or e["name"] == name)
                and (cat is None or e.get("cat") == cat)]

    def instants(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [e for e in self.events if e["ph"] == "i"
                and (name is None or e["name"] == name)]


def validate_trace(obj: Any) -> None:
    """Raise ``ValueError`` unless ``obj`` is schema-valid Chrome trace
    JSON with nesting-consistent, non-negative-duration spans."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be a dict with a traceEvents list")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    tracks: Dict[tuple, List[Dict[str, Any]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        for k, t in (("name", str), ("ph", str), ("pid", int),
                     ("tid", int), ("ts", int)):
            if not isinstance(ev.get(k), t) or isinstance(ev.get(k), bool):
                raise ValueError(f"event {i}: missing/invalid {k!r}")
        if ev["ph"] not in _PH:
            raise ValueError(f"event {i}: unknown ph {ev['ph']!r}")
        if ev["ts"] < 0:
            raise ValueError(f"event {i}: negative ts")
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), int) or ev["dur"] < 0:
                raise ValueError(f"event {i}: X span needs dur >= 0")
            tracks.setdefault((ev["pid"], ev["tid"]), []).append(ev)
        elif ev["ph"] == "M":
            if ev["name"] not in _META_NAMES:
                raise ValueError(
                    f"event {i}: metadata name {ev['name']!r} not in "
                    f"{_META_NAMES}")
            if not isinstance(ev.get("args", {}).get("name"), str):
                raise ValueError(f"event {i}: metadata needs args.name")
    # nesting consistency per track: sorted by (ts, -dur), every span is
    # either contained in the open ancestor or starts at/after its end
    for (pid, tid), spans in tracks.items():
        spans.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Dict[str, Any]] = []
        for ev in spans:
            t0, t1 = ev["ts"], ev["ts"] + ev["dur"]
            while stack and t0 >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            if stack and t1 > stack[-1]["ts"] + stack[-1]["dur"]:
                top = stack[-1]
                raise ValueError(
                    f"track (pid={pid}, tid={tid}): span "
                    f"{ev['name']!r} [{t0}, {t1}) partially overlaps "
                    f"{top['name']!r} [{top['ts']}, "
                    f"{top['ts'] + top['dur']})")
            stack.append(ev)
