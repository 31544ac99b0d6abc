"""Calibrator: resolves a TuneSpec into a SplitTable by measuring.

Counterpart of ``repro.tune.calibrator``.  Per grid cell and candidate
split count it times the op a measured plan later serves,
``ops.decode_attention`` (the decode kernel) or, for an ``int8`` /
``fp8`` cell, ``ops.decode_attention_quant`` (the quantized cache's
decode kernel), with the split frozen by ``Planner(num_splits_override=
s)``; it keeps the median of the repeats after discarding the warm-up
ones, and records the whole latency curve with its argmin.

Modes
-----
``wallclock``  real timing.  On the card: seeded device inputs, and each
               timed repeat writes a 64 MB buffer (evicting the 50 MB
               L2), spins the stream, then times ``launches`` calls back
               to back between two CUDA events, each call on its own copy
               of the cache (so every call reads it from memory, as a
               serving step does).  A call's time is the repeat's over
               ``launches``.  The spin must outlast the host's enqueueing
               of the repeat, or the card would wait on the host inside
               the window: a repeat whose enqueueing took more than 0.8 of
               the spin is discarded and the spin doubled (``redone``
               counts them).  On a CPU device the same loop times the
               plain PyTorch path with a monotonic clock.
``modeled``    the occupancy cost model (``core/occupancy.py``) at ``hw``
               (``H100_SXM`` unless given; ``TPU_V5E`` reproduces the
               reference's committed table) stands in for the clock.
``auto``       ``modeled`` on a CPU device, ``wallclock`` on the card.

A ``TuneSpec.budget_s`` cap degrades as the reference's does: past it
the remaining cells are modeled, and every entry records its ``source``.
A wallclock spec with a head dim the kernels do not take raises; a CUDA
failure raises.  Neither falls back to the model or the plain path.
"""
from __future__ import annotations

import statistics
import subprocess
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.occupancy import H100_SXM, modeled_latency_us
from repro_torch.core.split_policy import DecodeWorkload
from repro_torch.plan import AttentionSpec, Planner
from repro_torch.tune.spec import TuneSpec
from repro_torch.tune.table import MEASURED_SOURCES, SplitTable, \
    live_fingerprint

MODES = ("auto", "wallclock", "modeled")

# device cycles the stream spins before a timed repeat at first (about
# 1 ms); doubled whenever the host's enqueueing outlasts it
SPIN_CYCLES = 2_000_000
MAX_SPIN_CYCLES = 256_000_000
FLUSH_BYTES = 64 << 20


def card_line(device) -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    for a CUDA device (None elsewhere, or without nvidia-smi)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return lines[index].strip() if out.returncode == 0 \
        and index < len(lines) else None


class Calibrator:
    """Resolve ``spec`` into a :class:`SplitTable` (measure, decide).
    ``device=None`` is the card; ``hw`` is the modeled machine;
    ``launches`` calls are timed back to back in each wallclock repeat."""

    def __init__(self, spec: TuneSpec, *, mode: str = "auto",
                 seed: int = 0, hw=None, device=None, launches: int = 8):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; known: {MODES}")
        if launches < 1:
            raise ValueError("launches must be >= 1")
        self.spec = spec
        self.seed = seed
        self.hw = H100_SXM if hw is None else hw
        self.launches = launches
        if mode == "modeled":
            self.device = torch.device("cpu" if device is None else device)
        else:
            from repro_torch.models.registry import resolve_device
            self.device = resolve_device(device)
            if mode == "auto":
                mode = "modeled" if self.device.type == "cpu" \
                    else "wallclock"
        self.mode = mode
        if mode == "wallclock":
            from repro_torch.kernels.flash_decode import HEAD_DIMS
            bad = sorted({hd for _, _, hd in spec.head_shapes
                          if hd not in HEAD_DIMS})
            if bad:
                raise ValueError(
                    f"wallclock calibration times the decode kernels, "
                    f"which take head_dim in {HEAD_DIMS}; the spec holds "
                    f"head_dim {bad}")
        self._flush = None
        self.spin_cycles = SPIN_CYCLES
        self._ms_per_cycle: Optional[float] = None
        self.redone = 0             # repeats discarded as host-bound

    # --- timing -------------------------------------------------------------

    def _inputs(self, w: DecodeWorkload, cell: int):
        """Seeded inputs of one cell: q, ``launches`` copies of the cache
        (quantized through the family's Quantizer for int8 / fp8), and
        kv_len = the bucket."""
        from repro_torch.quant import QUANT_DTYPES, Quantizer
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(
            self.seed * 1_000_003 + cell)
        name = w.kv_dtype_name
        quant = name in QUANT_DTYPES
        dt = torch.float32 if w.dtype_bytes == 4 else torch.bfloat16
        shape = (self.launches, w.batch, w.seqlen_k, w.num_heads_kv,
                 w.head_dim)
        q = torch.randn((w.batch, w.num_heads_q, w.head_dim),
                        generator=gen, device=dev).to(dt)
        k = torch.randn(shape, generator=gen, device=dev).to(dt)
        v = torch.randn(shape, generator=gen, device=dev).to(dt)
        kv_len = torch.full((w.batch,), w.seqlen_k, dtype=torch.int32,
                            device=dev)
        if quant:
            return q, Quantizer.from_kv_dtype(name).quantized_kv(k, v), \
                kv_len
        return q, (k, v), kv_len

    def _time_wallclock(self, w: DecodeWorkload, s: int, args) -> float:
        """Median-of-repeats us of one call at split ``s``."""
        from repro_torch.kernels import ops
        plan = Planner(num_splits_override=s).plan(
            AttentionSpec.from_workload(w), bucket=w.seqlen_k)
        q, cache, kv_len = args
        copies = [tuple(x[i] for x in cache) for i in range(self.launches)]
        if len(cache) == 4:
            def call(i):
                ops.decode_attention_quant(q, copies[i], kv_len, plan=plan)
        else:
            def call(i):
                ops.decode_attention(q, *copies[i], kv_len, plan=plan)
        return self._median_us(call)

    def _median_us(self, call) -> float:
        """Median over the timed repeats of one repeat's time over
        ``launches``, in us; ``call(i)`` runs the i-th call of a repeat."""
        for _ in range(self.spec.warmup):
            for i in range(self.launches):
                call(i)
        if self.device.type != "cuda":
            spans = []
            for _ in range(self.spec.repeats):
                t0 = time.monotonic()
                for i in range(self.launches):
                    call(i)
                spans.append(time.monotonic() - t0)
            return statistics.median(spans) * 1e6 / self.launches
        if self._flush is None:
            self._flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                      device=self.device)
            self._ms_per_cycle = self._spin_rate()
        spans = []
        while len(spans) < self.spec.repeats:
            self._flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            torch.cuda._sleep(self.spin_cycles)
            start.record()
            for i in range(self.launches):
                call(i)
            end.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            if host_ms > 0.8 * self.spin_cycles * self._ms_per_cycle:
                # the card may have reached the window before the host
                # had enqueued it: discard, spin longer
                self.redone += 1
                self.spin_cycles *= 2
                if self.spin_cycles > MAX_SPIN_CYCLES:
                    raise RuntimeError(
                        f"the host took {host_ms:.1f} ms to enqueue "
                        f"{self.launches} calls; cannot time them")
                continue
            if host_ms < 0.2 * self.spin_cycles * self._ms_per_cycle \
                    and self.spin_cycles > SPIN_CYCLES:
                self.spin_cycles //= 2
            spans.append((start, end))
        torch.cuda.synchronize(self.device)
        ms = [a.elapsed_time(b) for a, b in spans]
        return statistics.median(ms) * 1e3 / self.launches

    def _spin_rate(self) -> float:
        """ms a spin cycle takes on this card (the least of three)."""
        rates = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda._sleep(SPIN_CYCLES)
            end.record()
            end.synchronize()
            rates.append(start.elapsed_time(end) / SPIN_CYCLES)
        return min(rates)

    def time_splits(self, w: DecodeWorkload, splits,
                    cell: int = 0) -> Dict[int, float]:
        """Wallclock us of the decode op at each of ``splits`` on cell
        ``cell``'s seeded inputs, timed as :meth:`calibrate` times them
        (for split counts outside the candidate set, such as ``paper``'s
        S=3 over 4 blocks)."""
        args = self._inputs(w, cell)
        return {s: self._time_wallclock(w, s, args) for s in splits}

    def floor_us(self) -> float:
        """The timing method's floor: the median us of one call when each
        call is a one-element ``fill_`` (the card only)."""
        one = torch.zeros(1, device=self.device)
        return self._median_us(lambda i: one.fill_(1.0))

    def _time_modeled(self, w: DecodeWorkload, s: int) -> float:
        return modeled_latency_us(w, s, num_cores=self.spec.num_cores,
                                  hw=self.hw)

    # --- resolution ---------------------------------------------------------

    def calibrate(self) -> SplitTable:
        spec = self.spec
        if self.mode == "wallclock" and self.device.type == "cuda":
            # build both decode kernels first: no nvcc runs while timing
            from repro_torch.kernels import build
            build.build(("flash_decode", "flash_decode_quant"))
        entries: List[Dict[str, Any]] = []
        t_start = time.perf_counter()
        budget_spent = False
        for cell, (w, impl) in enumerate(spec.workloads()):
            if (spec.budget_s is not None and not budget_spent
                    and time.perf_counter() - t_start > spec.budget_s):
                budget_spent = True
            wallclock = self.mode == "wallclock" and not budget_spent
            args = self._inputs(w, cell) if wallclock else None
            lat: Dict[str, float] = {}
            for s in spec.candidate_splits(w):
                t = (self._time_wallclock(w, s, args) if wallclock
                     else self._time_modeled(w, s))
                # rounded so the JSON round-trips (and hashes) stably
                lat[str(s)] = round(float(t), 4)
            del args
            # argmin, ties toward the smallest split
            best = min(sorted(lat, key=int), key=lambda k: lat[k])
            entries.append({
                "batch": w.batch, "num_heads_q": w.num_heads_q,
                "num_heads_kv": w.num_heads_kv, "head_dim": w.head_dim,
                "impl": impl, "dtype_bytes": w.dtype_bytes,
                "kv_dtype": w.kv_dtype_name,
                "lk_bucket": w.seqlen_k,
                "best_split": int(best),
                "source": "wallclock" if wallclock else "modeled",
                "latencies_us": lat,
            })
        table = SplitTable(entries, self._fingerprint(entries),
                           spec=spec.describe())
        table.validate()
        return table

    def _fingerprint(self, entries: List[Dict[str, Any]]) -> Dict[str, Any]:
        n_timed = sum(e["source"] in MEASURED_SOURCES for e in entries)
        if self.mode == "modeled":
            sources = "modeled"
        elif n_timed == len(entries):
            sources = "measured"
        else:             # wallclock degraded mid-run (budget cap)
            sources = "mixed"
        backend, device = live_fingerprint(self.device)
        fp = {
            "mode": self.mode,
            "sources": sources,
            "backend": backend,
            "device": device,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "num_cores": self.spec.num_cores,
            "seed": self.seed,
            "fallback": "paper",
        }
        if self.mode == "modeled" or sources == "mixed":
            fp["hw"] = self.hw.name
        if self.mode == "wallclock":
            fp["launches"] = self.launches
            if self.device.type == "cuda":
                fp["spin_cycles"] = self.spin_cycles
                fp["redone"] = self.redone
            card = card_line(self.device)
            if card is not None:
                fp["card"] = card
        return fp
