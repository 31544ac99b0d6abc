"""SplitTable: the frozen, persisted output of a calibration run.

Counterpart of ``repro.tune.table``, at the same schema (2) and JSON
layout, so a table written by either package loads in the other.  A
table is a versioned JSON file (schema, fingerprint of where the numbers
came from, and per cell the argmin split with the whole candidate
latency curve) that :class:`~repro_torch.plan.Planner` reads as the
``measured`` policy backend.

Lookup
------
A decode workload resolves in two stages:

1. **family**: an exact match on (batch, H_Q, H_KV, head_dim, impl,
   dtype_bytes, kv_dtype).  An uncovered family falls back to the table's
   analytic policy (``paper``), and the fallback is counted.
2. **nearest L_K bucket** in that family, ties toward the smaller
   bucket, its split clamped to the live workload's block count.

Families
--------
The reference names a family by its kernel implementation (``xla``,
``pallas``, ``naive``), ``None`` meaning ``xla``.  The port has one
implementation per device, so its own tables use one label,
:data:`PORT_IMPL` (``"cuda"``), and ``impl=None`` means that label
here.  A lookup of a reference table's cells passes ``impl="xla"``.

Registry
--------
:func:`select_table` takes a file or a directory of tables; in a
directory the table whose fingerprint matches the live device wins: its
``backend`` (``"cuda"`` or ``"cpu"``, the torch device type) and its
``device`` (``torch.cuda.get_device_name``, or ``"cpu"``).  The port's
H100 tables live in ``experiments/tune/h100/``, beside (not in) the
reference's ``experiments/tune/``, whose own registry globs only its
top level.
"""
from __future__ import annotations

import copy
import hashlib
import json
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.split_policy import (
    DEFAULT_NUM_CORES,
    KV_BLOCK,
    DecodeWorkload,
    choose_num_splits,
)

SCHEMA_VERSION = 2

# repo-root experiments/tune/: the reference's tables; the port's H100
# tables sit in its h100/ subdirectory
TABLE_DIR = Path(__file__).resolve().parents[3] / "experiments" / "tune"
REFERENCE_TABLE_PATH = TABLE_DIR / "reference_reduced.json"
H100_TABLE_DIR = TABLE_DIR / "h100"

# the family label of the port's own tables (and of impl=None)
PORT_IMPL = "cuda"

# (batch, num_heads_q, num_heads_kv, head_dim, impl, dtype_bytes, kv_dtype)
FamilyKey = Tuple[int, int, int, int, str, int, str]

_ENTRY_FIELDS = ("batch", "num_heads_q", "num_heads_kv", "head_dim",
                 "impl", "dtype_bytes", "kv_dtype", "lk_bucket",
                 "best_split", "source", "latencies_us")

# sources that came from timing (the reference labels its bf16 cells
# "measured" and its quantized ones "wallclock"; the port labels every
# timed cell "wallclock"), as against "modeled"
MEASURED_SOURCES = ("measured", "wallclock")


def _norm_impl(impl: Optional[str]) -> str:
    return impl or PORT_IMPL


def family_key(w: DecodeWorkload, impl: Optional[str] = None) -> FamilyKey:
    return (w.batch, w.num_heads_q, w.num_heads_kv, w.head_dim,
            _norm_impl(impl), w.dtype_bytes, w.kv_dtype_name)


def _entry_family(e: Dict[str, Any]) -> FamilyKey:
    return (e["batch"], e["num_heads_q"], e["num_heads_kv"],
            e["head_dim"], e["impl"], e["dtype_bytes"], e["kv_dtype"])


class SplitTable:
    """Calibrated per-shape split decisions, with load / save / merge /
    validate.  ``version`` is ``{schema}.{sha256(entries)[:12]}``, so two
    tables agree on it iff they agree on every decision and latency."""

    def __init__(self, entries: List[Dict[str, Any]],
                 fingerprint: Dict[str, Any],
                 spec: Optional[Dict[str, Any]] = None,
                 schema: int = SCHEMA_VERSION):
        if schema != SCHEMA_VERSION:
            raise ValueError(
                f"SplitTable schema mismatch: file has {schema}, this "
                f"code reads {SCHEMA_VERSION}; regenerate the table "
                "with `python -m repro_torch.launch.tune`")
        self.entries = entries
        self.fingerprint = dict(fingerprint)
        self.spec = dict(spec) if spec else None
        self.schema = schema
        # the table's own counters, and an attached PlanCacheStats (the
        # serving engine attaches its plan cache's)
        self.lookups = 0
        self.fallbacks = 0
        self.fallback_trace: List[tuple] = []
        self._stats = None
        self._version: Optional[str] = None
        self._families: Dict[FamilyKey, Dict[int, Dict[str, Any]]] = {}
        for e in entries:
            self._families.setdefault(
                _entry_family(e), {})[e["lk_bucket"]] = e

    @property
    def version(self) -> str:
        # computed once: entries are not edited after construction
        # (merge returns a new table, to_json deep-copies)
        if self._version is None:
            canon = json.dumps(self.entries, sort_keys=True,
                               separators=(",", ":"))
            digest = hashlib.sha256(canon.encode()).hexdigest()[:12]
            self._version = f"{self.schema}.{digest}"
        return self._version

    def __len__(self) -> int:
        return len(self.entries)

    # --- lookup (the measured policy's decision) ----------------------------

    def covers(self, w: DecodeWorkload, impl: Optional[str] = None) -> bool:
        return family_key(w, impl) in self._families

    def choose(self, w: DecodeWorkload, impl: Optional[str] = None,
               num_cores: Optional[int] = None) -> Tuple[int, bool]:
        """(num_splits, tuned) for one workload: ``tuned=True`` when a
        cell of the exact family decided (nearest L_K bucket, clamped
        feasible), ``False`` when the fallback policy did (counted)."""
        fam = family_key(w, impl)
        buckets = self._families.get(fam)
        self.lookups += 1
        if self._stats is not None:
            self._stats.record_measured(fam + (w.seqlen_k,),
                                        fallback=buckets is None)
        if buckets is None:
            self.fallbacks += 1
            self.fallback_trace.append(fam + (w.seqlen_k,))
            if len(self.fallback_trace) > 8192:
                del self.fallback_trace[:-4096]
            cores = num_cores if num_cores is not None else \
                self.fingerprint.get("num_cores", DEFAULT_NUM_CORES)
            return choose_num_splits(w, policy=self.fallback_policy,
                                     num_cores=cores), False
        # ties toward the smaller bucket: under-splitting is the
        # conservative error
        lk = max(1, w.seqlen_k)
        nearest = min(buckets, key=lambda b: (abs(b - lk), b))
        s = buckets[nearest]["best_split"]
        return max(1, min(int(s), w.num_n_blocks)), True

    @property
    def fallback_policy(self) -> str:
        return self.fingerprint.get("fallback", "paper")

    def attach_stats(self, stats) -> None:
        """Count lookups and fallbacks in a PlanCacheStats too."""
        self._stats = stats

    # --- persistence --------------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        """A deep copy: editing it leaves the live table alone."""
        d: Dict[str, Any] = {
            "schema": self.schema,
            "version": self.version,
            "fingerprint": copy.deepcopy(self.fingerprint),
            "entries": copy.deepcopy(self.entries),
        }
        if self.spec is not None:
            d["spec"] = copy.deepcopy(self.spec)
        return d

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1,
                                   sort_keys=True) + "\n")
        return path

    @classmethod
    def load(cls, path) -> "SplitTable":
        path = Path(path)
        d = json.loads(path.read_text())
        table = cls(d["entries"], d.get("fingerprint", {}),
                    spec=d.get("spec"), schema=d.get("schema", -1))
        stored = d.get("version")
        if stored is not None and stored != table.version:
            raise ValueError(
                f"SplitTable version mismatch in {path}: header says "
                f"{stored}, entries hash to {table.version}; the file "
                "was edited or truncated, recalibrate it")
        return table

    def merge(self, other: "SplitTable") -> "SplitTable":
        """A new table: this one's cells overridden or extended by
        ``other``'s.  Fingerprints that differ are both kept."""
        if other.schema != self.schema:
            raise ValueError(
                f"cannot merge SplitTables across schemas "
                f"({self.schema} vs {other.schema})")
        merged: Dict[tuple, Dict[str, Any]] = {}
        for e in self.entries + other.entries:   # later wins
            merged[_entry_family(e) + (e["lk_bucket"],)] = e
        fp = dict(self.fingerprint)
        if other.fingerprint != self.fingerprint:
            fp["merged_from"] = [self.fingerprint, other.fingerprint]
        return SplitTable([merged[k] for k in sorted(merged)], fp,
                          spec=self.spec, schema=self.schema)

    def validate(self) -> None:
        """Raise ValueError on a broken table: missing fields, off-grid
        L_K, infeasible or unmeasured best splits, a best split that is
        not its curve's argmin, duplicate cells.  Warn on ``sources ==
        "mixed"`` (some cells timed, some modeled)."""
        if not self.entries:
            raise ValueError("empty SplitTable")
        seen = set()
        for e in self.entries:
            missing = [f for f in _ENTRY_FIELDS if f not in e]
            if missing:
                raise ValueError(f"entry missing fields {missing}: {e}")
            if e["lk_bucket"] % KV_BLOCK:
                raise ValueError(
                    f"lk_bucket {e['lk_bucket']} is not a multiple of "
                    f"KV_BLOCK ({KV_BLOCK})")
            nblk = -(-e["lk_bucket"] // KV_BLOCK)
            if not 1 <= e["best_split"] <= nblk:
                raise ValueError(
                    f"best_split {e['best_split']} infeasible for "
                    f"lk_bucket {e['lk_bucket']} ({nblk} blocks)")
            if str(e["best_split"]) not in e["latencies_us"]:
                raise ValueError(
                    f"best_split {e['best_split']} has no measured "
                    f"latency in {sorted(e['latencies_us'])}")
            best = e["latencies_us"][str(e["best_split"])]
            if any(t < best for t in e["latencies_us"].values()):
                raise ValueError(
                    f"best_split {e['best_split']} is not the argmin of "
                    f"its latency curve: {e['latencies_us']}")
            key = _entry_family(e) + (e["lk_bucket"],)
            if key in seen:
                raise ValueError(f"duplicate cell {key}")
            seen.add(key)
        if self.fingerprint.get("sources") == "mixed":
            modeled = [e for e in self.entries
                       if e["source"] not in MEASURED_SOURCES]
            families = sorted({(e["kv_dtype"], e["impl"]) for e in modeled})
            warnings.warn(
                f"SplitTable has mixed sources: {len(modeled)}/"
                f"{len(self.entries)} cells are modeled (families by "
                f"(kv_dtype, impl): {families}) while the rest are timed; "
                "rerun `python -m repro_torch.launch.tune --mode "
                "wallclock`, or merge() a recalibration of those cells",
                UserWarning, stacklevel=2)

    def describe(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "cells": len(self.entries),
            "families": len(self._families),
            "fingerprint": self.fingerprint,
            "lookups": self.lookups,
            "fallbacks": self.fallbacks,
        }


def live_fingerprint(device) -> Tuple[str, str]:
    """(backend, device name) of a torch device, as tables record them."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return "cuda", torch.cuda.get_device_name(dev)
    return dev.type, dev.type


def select_table(path, device) -> Tuple[SplitTable, bool]:
    """Resolve ``tune_table_path`` into one table: a file, or a registry
    directory whose ``*.json`` tables are all loaded and scored against
    the fingerprint of the torch device ``device`` (backend and device
    name match first, backend alone next).  With no match the first
    table by file name serves, with a warning, and the flag returned is
    False (the serving engine counts it in
    ``PlanCacheStats.table_registry_fallbacks``).

    Returns ``(table, matched)``."""
    p = Path(path)
    if not p.is_dir():
        return SplitTable.load(p), True
    candidates = sorted(p.glob("*.json"))
    if not candidates:
        raise ValueError(f"tune-table registry {p} holds no *.json tables")
    tables = [(c, SplitTable.load(c)) for c in candidates]
    backend, kind = live_fingerprint(device)

    def score(t: SplitTable) -> int:
        fp = t.fingerprint
        s = 0
        if fp.get("backend") == backend:
            s += 2
            if fp.get("device") == kind:
                s += 1
        return s

    best_path, best = max(tables, key=lambda ct: score(ct[1]))
    matched = score(best) > 0
    if not matched:
        fps = {c.name: t.fingerprint.get("backend") for c, t in tables}
        warnings.warn(
            f"no table in registry {p} matches the live device "
            f"(backend={backend!r}, device={kind!r}; registry backends: "
            f"{fps}); falling back to {best_path.name}, whose decisions "
            "were taken on other hardware", RuntimeWarning, stacklevel=2)
    return best, matched
