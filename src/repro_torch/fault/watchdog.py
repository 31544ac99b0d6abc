"""Heartbeats, hang watchdog, and straggler detection.

Counterpart of ``repro.fault.watchdog``, a copy: these run on the host
only, and every clock is injectable, so the tests drive them with a
fake one.

On a real multi-host pod each worker runs a :class:`Heartbeat` (updated
every step) and the coordinator a :class:`Watchdog` thread; here the same
objects run in-process and the tests drive them with synthetic clocks.

:class:`StragglerDetector` implements the standard robust rule: a worker
is a straggler when its step time exceeds ``median x threshold`` over a
sliding window.  At pod scale the mitigation is eviction + elastic
restart (``fault/elastic.py``); the detector is deliberately decoupled
from the mitigation so either half can be swapped.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional


class Heartbeat:
    """Monotonic per-worker liveness signal."""

    def __init__(self, worker_id: str, clock: Callable[[], float] = time.monotonic):
        self.worker_id = worker_id
        self._clock = clock
        self._last = clock()
        self._lock = threading.Lock()

    def beat(self) -> None:
        with self._lock:
            self._last = self._clock()

    def age(self) -> float:
        with self._lock:
            return self._clock() - self._last


class Watchdog:
    """Fires ``on_dead(worker_id)`` when a heartbeat goes stale."""

    def __init__(self, timeout_s: float,
                 on_dead: Callable[[str], None],
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.on_dead = on_dead
        self._clock = clock
        self._beats: Dict[str, Heartbeat] = {}
        self._dead: set = set()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def register(self, hb: Heartbeat) -> None:
        self._beats[hb.worker_id] = hb

    def check_once(self) -> List[str]:
        """One scan; returns newly-dead worker ids (test-friendly)."""
        newly = []
        for wid, hb in self._beats.items():
            if wid in self._dead:
                continue
            if hb.age() > self.timeout_s:
                self._dead.add(wid)
                newly.append(wid)
                self.on_dead(wid)
        return newly

    def start(self, interval_s: float = 1.0) -> None:
        def loop():
            while not self._stop.wait(interval_s):
                self.check_once()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join()


@dataclass
class StragglerDetector:
    """Flag workers whose step time exceeds median x threshold."""
    window: int = 32
    threshold: float = 2.0
    min_samples: int = 8
    _times: Dict[str, Deque[float]] = field(
        default_factory=lambda: defaultdict(deque))

    def record(self, worker_id: str, step_time_s: float) -> None:
        q = self._times[worker_id]
        q.append(step_time_s)
        if len(q) > self.window:
            q.popleft()

    def _medians(self) -> Dict[str, float]:
        out = {}
        for wid, q in self._times.items():
            if len(q) >= self.min_samples:
                s = sorted(q)
                out[wid] = s[len(s) // 2]
        return out

    def stragglers(self) -> List[str]:
        med = self._medians()
        if len(med) < 2:
            return []
        global_median = sorted(med.values())[len(med) // 2]
        return [wid for wid, m in med.items()
                if m > self.threshold * global_median]
