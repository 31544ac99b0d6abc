"""MetricsRegistry: labeled counters / gauges / fixed-bucket histograms.

Counterpart of ``repro.obs.metrics``, unchanged: the module is
host-side Python with no device code.

Pure host-side, dependency-free instruments with two export surfaces:

- :meth:`MetricsRegistry.snapshot` — a JSON-safe dict, one entry per
  metric family: ``{"kind", "help", "series": {label_key: value},
  "aggregate": merged}``.  The ``aggregate`` entry merges every label
  series (counters/gauges sum; histograms merge counts, sums and
  retained samples), so a sharded engine's per-``shard=d`` series and
  their cross-shard merge ship in one snapshot.
- :meth:`MetricsRegistry.prometheus` — Prometheus text exposition
  (``# HELP`` / ``# TYPE`` + one line per series; histograms render the
  standard cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count``
  triplet), every name prefixed ``repro_``.

Histograms keep fixed buckets (Prometheus-style upper bounds) PLUS the
raw samples (bounded at ``SAMPLE_CAP``), so snapshot percentiles are
exact — the serving A/B's TTFT/TPOT ``mean``/``p50``/``p90`` columns
read them verbatim instead of re-timing around ``step()``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

# default latency buckets (milliseconds): sub-ms to 10s
DEFAULT_BUCKETS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0, 2500.0, 5000.0, 10000.0)
# raw samples retained per histogram series for exact percentiles; a
# run long enough to overflow this reports percentiles over the first
# SAMPLE_CAP observations (count/sum/buckets stay exact)
SAMPLE_CAP = 65536

NAMESPACE = "repro"


def _label_key(labels: Dict[str, str]) -> str:
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


def _percentile(samples: List[float], q: float) -> float:
    """numpy-style linear-interpolation percentile, ``q`` in [0, 1]."""
    if not samples:
        return 0.0
    s = sorted(samples)
    k = (len(s) - 1) * q
    f, c = math.floor(k), math.ceil(k)
    if f == c:
        return float(s[int(k)])
    return float(s[f] + (s[c] - s[f]) * (k - f))


class _Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1) -> None:
        self.value += n


class _Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class _Histogram:
    __slots__ = ("buckets", "counts", "count", "sum", "samples")

    def __init__(self, buckets: Tuple[float, ...]) -> None:
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)   # +1: the +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.samples: List[float] = []

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        i = 0
        for i, le in enumerate(self.buckets):
            if x <= le:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        if len(self.samples) < SAMPLE_CAP:
            self.samples.append(x)

    def snapshot(self) -> Dict[str, Any]:
        cum, acc = {}, 0
        for le, n in zip(self.buckets, self.counts):
            acc += n
            cum[f"{le:g}"] = acc
        cum["+Inf"] = self.count
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "mean": round(self.sum / self.count, 6) if self.count else 0.0,
            "min": round(min(self.samples), 6) if self.samples else 0.0,
            "max": round(max(self.samples), 6) if self.samples else 0.0,
            "p50": round(_percentile(self.samples, 0.50), 6),
            "p90": round(_percentile(self.samples, 0.90), 6),
            "p99": round(_percentile(self.samples, 0.99), 6),
            "buckets": cum,
        }


class Family:
    """One named metric family: children per label combination."""

    def __init__(self, kind: str, name: str, help: str,
                 buckets: Optional[Tuple[float, ...]] = None) -> None:
        self.kind = kind
        self.name = name
        self.help = help
        self.buckets = buckets
        self._children: Dict[str, Any] = {}
        self._child_labels: Dict[str, Dict[str, str]] = {}

    def labels(self, **labels: Any) -> Any:
        lv = {k: str(v) for k, v in labels.items()}
        key = _label_key(lv)
        child = self._children.get(key)
        if child is None:
            if self.kind == "counter":
                child = _Counter()
            elif self.kind == "gauge":
                child = _Gauge()
            else:
                child = _Histogram(self.buckets or DEFAULT_BUCKETS)
            self._children[key] = child
            self._child_labels[key] = lv
        return child

    # no-label convenience (single-engine fast path)
    def inc(self, n: float = 1, **labels: Any) -> None:
        self.labels(**labels).inc(n)

    def set(self, v: float, **labels: Any) -> None:
        self.labels(**labels).set(v)

    def observe(self, x: float, **labels: Any) -> None:
        self.labels(**labels).observe(x)

    # --- export -------------------------------------------------------------

    def _aggregate(self) -> Any:
        if self.kind in ("counter", "gauge"):
            return round(sum(c.value for c in self._children.values()), 6)
        merged = _Histogram(self.buckets or DEFAULT_BUCKETS)
        for c in self._children.values():
            merged.count += c.count
            merged.sum += c.sum
            for i, n in enumerate(c.counts):
                merged.counts[i] += n
            room = SAMPLE_CAP - len(merged.samples)
            merged.samples.extend(c.samples[:room])
        return merged.snapshot()

    def snapshot(self) -> Dict[str, Any]:
        series = {}
        for key, c in self._children.items():
            series[key] = (c.snapshot() if self.kind == "histogram"
                           else round(c.value, 6))
        return {"kind": self.kind, "help": self.help, "series": series,
                "aggregate": self._aggregate()}

    def prometheus(self) -> List[str]:
        full = f"{NAMESPACE}_{self.name}"
        lines = [f"# HELP {full} {self.help}",
                 f"# TYPE {full} {self.kind}"]

        def fmt(labels: Dict[str, str], extra: str = "") -> str:
            parts = [f'{k}="{v}"' for k, v in sorted(labels.items())]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        for key, c in self._children.items():
            lv = self._child_labels[key]
            if self.kind in ("counter", "gauge"):
                lines.append(f"{full}{fmt(lv)} {c.value:g}")
            else:
                acc = 0
                for le, n in zip(c.buckets, c.counts):
                    acc += n
                    extra = 'le="%g"' % le
                    lines.append(f"{full}_bucket{fmt(lv, extra)} {acc}")
                inf = 'le="+Inf"'
                lines.append(f"{full}_bucket{fmt(lv, inf)} {c.count}")
                lines.append(f"{full}_sum{fmt(lv)} {c.sum:g}")
                lines.append(f"{full}_count{fmt(lv)} {c.count}")
        return lines


class MetricsRegistry:
    """Named metric families, memoized by name (a second registration
    with the same name returns the existing family — shard views of one
    Observer share families and differ only in their bound labels)."""

    def __init__(self) -> None:
        self._families: "Dict[str, Family]" = {}

    def _get(self, kind: str, name: str, help: str,
             buckets: Optional[Tuple[float, ...]] = None) -> Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"not {kind}")
            return fam
        fam = Family(kind, name, help, buckets)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "") -> Family:
        return self._get("counter", name, help)

    def gauge(self, name: str, help: str = "") -> Family:
        return self._get("gauge", name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Family:
        return self._get("histogram", name, help, tuple(buckets))

    def snapshot(self) -> Dict[str, Any]:
        return {name: fam.snapshot()
                for name, fam in sorted(self._families.items())}

    def prometheus(self) -> str:
        lines: List[str] = []
        for _, fam in sorted(self._families.items()):
            lines.extend(fam.prometheus())
        return "\n".join(lines) + "\n" if lines else ""
