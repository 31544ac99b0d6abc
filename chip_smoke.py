#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Run from the repository root, on a machine with the card and nvcc:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phase kernels # build + kernel parity only
    python3 chip_smoke.py --phase digests # build + main path's parity
    python3 chip_smoke.py --phase admission  # build + admission steps
    python3 chip_smoke.py --phase times   # build + decode and prefill times
    python3 chip_smoke.py --phase table1  # build + the paper's Table 1
    python3 chip_smoke.py --phase shapes  # build + the configs' shapes

Phases, each fatal on failure:

1. Environment and build: the card's name and power limit, CUDA version,
   SM count; all kernels built from ``src/repro_torch/csrc`` (one nvcc per
   source, in parallel) with ptxas's registers, shared memory, spills
   and warnings; any spill fails the run.
2. Kernel parity: each kernel against its plain PyTorch version on the
   same CUDA tensors, at the main path's shapes, in bf16 (decode 2e-2,
   prefill 3e-2), plus a same-split-same-bits check.  The decode kernel
   (partials and combine in one launch) reads caches whose rows past
   kv_len hold NaN and Inf, against ``decode_plain`` on the clean cache:
   at buckets 128, 512 and 2048 with S 1, 3 and the plan's, at every
   shape of ``DECODE_SHAPES``, and at S > 32 (``WIDE_SPLIT_SHAPES``,
   where the merge finds m* before it reads the partials in chunks), and
   with the full-width model's large V entries and few dominant keys
   (``SHARP_SHAPES``); at
   the bucket grid its partials-only epilogue is held the same way, and
   the combine kernel against its plain version on those partials; a
   rerun of every decode case, in turns of S and B, gives the first
   run's bits.  The quantized cache's decode kernel (partials and
   combine in one launch, and its partials-only epilogue) over int8 and
   fp8 caches whose rows past kv_len hold codes 127 and scales 1e4,
   against ``decode_quant_plain`` on the clean cache (2e-2,
   ``AB_ATOL``): at the same bucket grid, at ``DECODE_SHAPES``, at
   ``WIDE_SPLIT_SHAPES`` and on ``SHARP_SHAPES`` data (K x 10 and V x 100
   before quantization); its cases join the rerun in turns.  The
   prefill kernel at the shapes its tiling cares about
   (``PREFILL_CASES``: the main path's buckets,
   ragged prompts, B=2, MHA, D=64 with a window, ``q_offset``, one
   non-causal case), bf16 at 3e-2 and f32 at 2e-5, same inputs same
   bits.  Those cases draw their inputs as every slice has, and a line
   ``parity digests`` prints their outputs' digests, so two checkouts
   can be compared bit for bit.  Then the shapes the main path lacks,
   from a generator of their own: both decode kernels at G in
   ``WIDE_GROUPS`` (up to 64 query heads per KV head) and D in
   ``WIDE_DIMS`` (128, 160, 256), at S = 1, 5 and 32 over poisoned tails,
   at G = 64 on the K x 10, V x 100 data, at G 32 and 64 on that data
   merging 16 and 32 splits over 2000 and 4000 rows, at G 72 and 128
   (passes of 64 rows) and at D 64 past G 16, joining the rerun in turns;
   the prefill kernel at D = 160 and 256 (``PREFILL_WIDE_CASES``: causal,
   windowed, a q_offset with a ragged Lq; bf16, the sharp data, f32).
3. Serving at full width: qwen2.5-3b (36 layers, d_model 2048, 16 query
   heads over 2 KV heads, bf16, seeded random weights) through
   ``ServingEngine`` submit/step/drain: 4 greedy requests, 2 slots, with
   a bf16 cache, then under ``kv_quant="int8"`` and ``"fp8"``.  Launch
   counts are zeroed just before each run and read just after: the decode
   kernel 36 per decode step with a bf16 cache, the quantized cache's
   decode kernel 36 per decode step under int8 and fp8, the combine
   kernel none in every run; logits must be finite.  Each admission
   step's wall ms is printed with its prompt buckets.  Then the logits check: the model's
   first ``LOGITS_STEPS`` decode steps, teacher-forced, at the main
   path's decode shape (B=2, bucket 1024) and the paper's cell (B=1,
   bucket 512).  Every layer's prefill attention of the prompts must be
   within 3e-2 of ``prefill_plain`` on the same inputs.  The decode
   attention runs through the tensor-core kernel, through its CUDA-core
   body (f32 q over the same bf16 cache) and through ``decode_plain``
   (f32 math on the card); on the tensor-core route each layer's output
   must be within 2e-2 of ``decode_plain`` on the same inputs; the
   routes' logits are printed side by side.  Then an int8 and an fp8
   pass at the main path's cell (B=2, bucket 1024): the same prompts
   prefilled into a quantized cache, and every layer's quantized decode
   attention on the model's own quantized cache held against
   ``decode_quant_plain`` at 2e-2 for ``LOGITS_STEPS`` steps.
4. The paper's cell: one 420-token prompt decoding 64 tokens (every step
   in the 512 bucket) under ``paper`` and ``fa3_baseline``, in turns
   (three runs each), plus the decode kernel alone at that shape, for
   the bf16 cache and again under int8; then a torch.profiler window
   over its decode steps, bf16 and int8 (device busy and idle, device
   operations per step).  Then the paper's Table 1 (``phase_table1``):
   its 18 cells (B=1, H_Q=64, D=128, H_KV 1, 2, 8, L_K 128 to 4096)
   through ``ops.decode_attention`` under ``get_scheduler_metadata``'s
   frozen plans for ``fa3_baseline`` and ``paper`` at the card's SM
   count, each output held against ``decode_plain`` and rerun for the
   same bits, the launch counts zeroed before the cells run and read
   after; the policies must differ exactly at (512, 1) and (512, 2),
   with no policy evaluation in a call and one metadata-cache miss per
   (cell, policy); per cell the op and kernel times of each policy
   (mean, median, 10th-90th percentile) beside SDPA, the bound, the
   timing floor, ``H100_SXM``'s
   modeled latency and the paper's numbers; the two changed cells again
   over an int8 cache.
5. One JSON ``kernels`` line: per kernel its error (a decode row's at
   that row's own inputs, over NaN/Inf tails), launches on the main
   path (the bf16 run's; the quantized decode and the combine kernels'
   from the int8 run), its time (CUDA events, L2 flushed before each
   launch),
   the plain version's time, the yardstick library call's time, its
   bound, and ``floor_ms``, the time the same method gives one
   one-element ``fill_``.  The decode kernel has a row per decode shape
   of the serving run (buckets 384, 1024, 1152 at B=2) and of the paper's
   cell (B=1, 512, S=1 and S=3), each with the launches its wrapper
   counted at that view length and split count, and so has the quantized
   cache's decode kernel over int8 (the int8 run's launches), beside one
   row of its partials-only epilogue; the prefill kernel a row
   per main-path bucket (bf16, tensor cores) and one for its f32
   instantiation (CUDA cores) at 1024, each with the launches its wrapper
   counted at that dtype and length; both decode kernels a row at Table
   1's two changed cells under ``paper`` (bf16, and int8), with the
   launches of phase 4's Table 1 run.

``--phase admission`` times the serving cell's admission
steps alone, five runs on one engine; ``--phase times`` times the
decode op (``ops.decode_attention``, as the model calls it) and the
partials kernel followed by the combine kernel (the route of every
slice before the fused kernel) at the decode shapes of phase 5, the
quantized decode op (``ops.decode_attention_quant``) and the quantized
partials kernel followed by the combine kernel there, over int8 and
fp8, and the bf16 prefill kernel at the main path's buckets, beside
SDPA and the timing floor.  These two, and ``--phase digests``, use
only calls every slice of the port has, so a copy of this script in an
older checkout runs that checkout's kernels.  ``--phase table1`` runs
phase 4's Table 1 alone; ``--phase shapes`` times both decode kernels
and the prefill kernel at the reference configs' head shapes that only
the wide bodies serve (``CONFIG_SHAPES``).

The last line of standard output is ``{"ok": true, "device": {...}}``.
The script exits non-zero, printing no result, without a CUDA device or
outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ServeConfig  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_decode as fdec  # noqa: E402
from repro_torch.kernels.flash_combine import (  # noqa: E402
    combine_plain,
    flash_combine,
)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    flash_decode_partials,
)
from repro_torch.kernels import flash_decode_quant as fdq  # noqa: E402
from repro_torch.kernels.flash_decode_quant import (  # noqa: E402
    decode_quant_partials_plain,
    flash_decode_quant_partials,
)
from repro_torch.kernels.flash_prefill import (  # noqa: E402
    flash_prefill,
    prefill_plain,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.plan import AttentionSpec, Planner  # noqa: E402
from repro_torch.quant import (  # noqa: E402
    AB_ATOL,
    QUANT_DTYPES,
    QuantizedKV,
    Quantizer,
)
from repro_torch.serving import (  # noqa: E402
    TOKEN,
    GreedySampler,
    Request,
    ServingEngine,
)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12         # dense int8 / fp8 tensor-core peak
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
DECODE_TOL, PREFILL_TOL, F32_TOL = 2e-2, 3e-2, 2e-5
QUANT_TOL = AB_ATOL["int8"]      # == AB_ATOL["fp8"]
REPLACES = {
    "flash_decode": "src/repro/kernels/flash_decode.py:42",
    "flash_combine": "src/repro/kernels/flash_combine.py:28",
    "flash_prefill": "src/repro/kernels/flash_prefill.py:31",
    "flash_decode_quant": "src/repro/kernels/flash_decode.py:186",
}
TOLS = {"flash_decode": DECODE_TOL, "flash_combine": DECODE_TOL,
        "flash_prefill": PREFILL_TOL, "flash_decode_quant": QUANT_TOL}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
DEVICE = "cuda"
PREFILL_BUCKETS = (128, 384, 512, 1024)   # the serving cell's admissions
# the prefill kernel's parity shapes (tests/test_torch_gpu.py has the
# same list): b, lq, lk, hq, hkv, d, window, q_offset, causal
PREFILL_CASES = [(1, L, L, 16, 2, 128, None, 0, True)
                 for L in PREFILL_BUCKETS] + [
    (1, 37, 37, 16, 2, 128, None, 0, True),       # ragged real prompts
    (1, 1000, 1000, 16, 2, 128, None, 0, True),
    (2, 200, 200, 16, 2, 128, None, 0, True),     # B=2
    (1, 200, 200, 16, 2, 128, None, 0, True),
    (1, 256, 256, 8, 8, 128, None, 0, True),      # MHA
    (1, 256, 256, 4, 1, 64, 100, 0, True),        # D=64, window off-tile
    (1, 256, 256, 4, 1, 64, 64, 0, True),         # D=64, window on-tile
    (1, 512, 512, 16, 2, 128, 128, 0, True),
    (1, 64, 320, 16, 2, 128, None, 256, True),    # q_offset = Lk - Lq
    (1, 64, 320, 2, 1, 64, None, 256, True),      # D=64, group of 2
    (1, 100, 1124, 16, 2, 128, None, 1024, True),
    (1, 300, 300, 16, 2, 128, None, 0, False),    # not causal
]
# f32 inputs take the CUDA-core instantiation
PREFILL_F32_CASES = [(1, 200, 200, 16, 2, 128, None, 0, True),
                     (1, 256, 256, 4, 1, 64, 100, 0, True)]
SERVING_PROMPTS = (37, 300, 450, 1000)    # buckets 128, 384, 512, 1024
# the decode kernel's timed shapes: the serving run's decode buckets at
# B=2 (the main path's 1024 first) and the paper's cell, B=1 in the 512
# bucket at S=1 and S=3: batch, bucket, kv_len, S (None: the paper
# policy's at 132 SMs)
DECODE_SHAPES = [(2, 1024, (1000, 450), None), (2, 384, (60, 320), None),
                 (2, 1152, (1030, 480), None), (1, 512, (484,), 1),
                 (1, 512, (484,), 3)]
# S > 32, which the policy reaches past 4096 rows: an 8192-row view of
# 64 blocks, kv_len 5000 leaving splits with no valid row, S = 33 and 40
# leaving splits past the view's end
WIDE_SPLIT_SHAPES = [(1, 8192, (5000,), 40), (1, 8192, (5000,), 64),
                     (2, 8192, (5000, 8192), 33)]
# the full-width model's regime (V entries up to ~150, a few keys
# sharing most of the softmax, with seeded weights) at the main path's
# decode shapes: K times 10 and V times 100 (SHARP_MUL: q, K, V), so the
# top scores lie a few units apart and an output is a short sum of large
# V entries.  P rounded to one bf16 term misses 2e-2 there.
SHARP_SHAPES = [(2, 1024, (1000, 450), 8), (2, 384, (60, 320), 1),
                (1, 512, (484,), 3)]
SHARP_MUL = (1.0, 10.0, 100.0)
# the prefill kernel in that regime: the main path's largest bucket, a
# ragged prompt at B=2, a q_offset
PREFILL_SHARP_CASES = [(1, 1024, 1024, 16, 2, 128, None, 0, True),
                       (2, 200, 200, 16, 2, 128, None, 0, True),
                       (1, 64, 320, 16, 2, 128, None, 256, True)]
# the logits check: each cell's prompt lengths and decode bucket (the
# main path's decode shape, then the paper's cell), and its steps
LOGITS_CELLS = [((1000, 450), 1024), ((420,), 512)]
LOGITS_STEPS = 8
# the decode kernels at the shapes the reference's configs and the paper's
# Table 1 need beyond the main path's (G up to 64, D 160 and 256): each
# (G, D) of these over one cache of 2 x 4096 rows (H_KV 1 at G >= 32,
# else 2), at S = 1, S = 5 and S = 32 (one block a split): batch, bucket,
# kv_len, S; and on the K x 10, V x 100 data at G = 64
WIDE_GROUPS = (1, 3, 4, 32, 40, 64)
WIDE_DIMS = (128, 160, 256)
WIDE_SHAPES = [(2, 1024, (1000, 333), 1), (2, 2048, (2000, 700), 5),
               (1, 4096, (4000,), 32)]
WIDE_SHARP_SHAPES = [(1, 512, (484,), 1), (1, 512, (484,), 3)]
# the merge of many splits over 64 rows (four 16-row groups), as Table 1's
# long cells plan it, on the K x 10, V x 100 data at G 32 and 64 (D 128):
# a dropped or mis-weighted split moves an output by far more than the
# tolerance there
WIDE_SHARP_LONG_SHAPES = [(1, 2048, (2000,), 16), (1, 2048, (2000,), 32),
                          (1, 4096, (4000,), 16), (1, 4096, (4000,), 32)]
# more than 64 query rows a KV head: the wide bodies' passes of 64 rows
# (G 72 and 128, D 128), at S = 1 and S = 32
WIDE_MULTI_GROUPS = (72, 128)
WIDE_MULTI_SHAPES = [(2, 1024, (1000, 333), 1), (1, 4096, (4000,), 32)]
# D = 64 past 16 query rows a KV head takes the wide bodies too
WIDE_D64_GROUPS = (32, 64)
# the prefill kernel at D 160 and 256: causal, windowed, q_offset > 0
# with a ragged Lq (the f32 cases take the CUDA-core body)
PREFILL_WIDE_CASES = [c for d in (160, 256) for c in (
    (1, 384, 384, 16, 2, d, None, 0, True),
    (1, 300, 300, 8, 2, d, 100, 0, True),
    (2, 100, 356, 8, 1, d, None, 256, True))]
PREFILL_WIDE_F32_CASES = [(1, 200, 200, 8, 2, d, None, 0, True)
                          for d in (160, 256)]
PREFILL_WIDE_SHARP_CASES = [(1, 384, 384, 16, 2, d, None, 0, True)
                            for d in (160, 256)]


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def max_err(got, want, tol: float) -> float:
    """Max abs error; raises unless |got - want| <= tol + tol * |want|."""
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), "non-finite kernel output")
    diff = (g - w).abs()
    check(bool((diff <= tol + tol * w.abs()).all()),
          f"max abs err {diff.max().item():.3e} over tolerance {tol}")
    return diff.max().item()


# device cycles the stream spins before each timed call (about 5 ms), so
# the host has enqueued the whole call before the card reaches it: the
# events then time the device's work, not the host's launch overhead
SPIN_CYCLES = 10_000_000


def device_times(fn, iters: int, flush) -> list:
    """Device ms of ``fn`` in each of ``iters`` calls, each timed by its
    own pair of CUDA events after a write that evicts the 50 MB L2 and a
    spin that keeps the card behind the host."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
        torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def time_ms(fn, iters: int, flush) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls (``device_times``)."""
    return sum(device_times(fn, iters, flush)) / iters


def time_stats_us(fn, iters: int, flush) -> dict:
    """Mean, median, 10th and 90th percentile device us of ``fn`` over
    ``iters`` calls (``device_times``)."""
    t = sorted(1e3 * x for x in device_times(fn, iters, flush))
    return {"mean": sum(t) / iters, "median": t[iters // 2],
            "p10": t[iters // 10], "p90": t[iters - 1 - iters // 10]}


def fmt_stats(a: dict, b: dict) -> str:
    """Two time_stats_us side by side: the means, the medians (each with
    a's over b's), and the 10th-90th percentile spreads."""
    return (f"mean {a['mean']:.3f} / {b['mean']:.3f} us (x"
            f"{a['mean'] / b['mean']:.3f}), median {a['median']:.3f} / "
            f"{b['median']:.3f} us (x{a['median'] / b['median']:.3f}), "
            f"p10-p90 {a['p10']:.3f}-{a['p90']:.3f} / "
            f"{b['p10']:.3f}-{b['p90']:.3f} us")


def bits(x: torch.Tensor) -> str:
    """A short digest of a tensor's bytes."""
    raw = x.detach().contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def bound(bytes_moved: float, flops: float, peak: float = BF16_FLOPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_env_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    props = torch.cuda.get_device_properties(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {props.major}.{props.minor} "
          f"sms {props.multi_processor_count}")
    ok, why = build.available()
    check(ok, f"kernels unavailable: {why}")
    t0 = time.perf_counter()
    results = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for "
          f"{len(results)} kernels in parallel")
    for name, res in results.items():
        print(f"build {name}: {res.seconds:.1f} s -> {res.path.name}")
        print_ptxas(name, res.log)
    return card, props.multi_processor_count


def print_ptxas(name: str, log: str) -> None:
    """Prints ptxas's registers, shared memory, spills and warnings for
    each kernel of a build; fails on any spill."""
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling",
                                   "arning")):
            print(f"  ptxas {line.strip()}")
        if "spill" in line:
            check("0 bytes spill stores, 0 bytes spill loads" in line,
                  f"{name}: ptxas spills: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def rand(gen, shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def prefill_case(gen, b, lq, lk, hq, hkv, d, dtype=torch.bfloat16,
                 mul=(1.0, 1.0, 1.0)):
    """Pre-scaled q (b, lq, hq, d) and k, v (b, lk, hkv, d) in ``dtype``,
    from normals of standard deviations ``mul`` (q's before the scaling
    by d ** -0.5)."""
    q = (rand(gen, (b, lq, hq, d), torch.float32) * (mul[0] * d ** -0.5)
         ).to(dtype)
    return q, (rand(gen, (b, lk, hkv, d), torch.float32) * mul[1]).to(
        dtype), (rand(gen, (b, lk, hkv, d), torch.float32) * mul[2]).to(dtype)


def quant_case(q, art, bucket: int, kv_len, s: int, kv_dtype: str):
    """One decode case over the quantized cache ``art`` (>= b, cap, hkv,
    d) and queries ``q`` (>= b, hq, d), b = len(kv_len): a dict with the
    label, b, bucket, S, kv_len, q, the clean cache rows ``art`` and
    their bucket view ``view``, a copy ``poisoned`` of the rows whose rows
    past kv_len hold codes 127 / -127 and scales 1e4 (the reference's
    poisoned-tail oracle: a kernel that read one would be off by orders
    of magnitude) and its bucket view ``pview``, and the pre-scaled qp
    (b, hkv, g, d)."""
    b = len(kv_len)
    cap, hkv, d = art.k.shape[1:]
    lens = torch.tensor(kv_len, device=DEVICE, dtype=torch.int32)
    rows = QuantizedKV(*(t[:b] for t in art))
    tail = torch.arange(cap, device=DEVICE)[None] >= lens[:, None]
    k, v, ks, vs = (t.clone() for t in rows)
    for x, val in ((k, 127.0), (v, -127.0)):     # through the raw bytes
        x.view(torch.uint8)[tail] = torch.tensor(
            val, device=DEVICE).to(x.dtype).view(torch.uint8)
    ks[tail] = 1e4
    vs[tail] = 1e4
    poisoned = QuantizedKV(k, v, ks, vs)
    return dict(
        label=f"{kv_dtype} B{b} view{bucket} of {cap} kv_len "
              f"{list(kv_len)} S{s}",
        b=b, bucket=bucket, s=s, lens=lens, q=q[:b], art=rows,
        view=QuantizedKV(*(t[:, :bucket] for t in rows)), poisoned=poisoned,
        pview=QuantizedKV(*(t[:, :bucket] for t in poisoned)),
        qp=(q[:b].float() * d ** -0.5).to(q.dtype).reshape(b, hkv, -1, d))


def quant_shapes(gen, sms: int, kv_dtype: str, shapes=DECODE_SHAPES,
                 cap: int = 2048, mul=(1.0, 1.0, 1.0)):
    """quant_case of each of ``shapes`` (as decode_shapes) over one
    ``kv_dtype`` cache of 2 x ``cap`` rows, 16/2 heads, D=128, quantized
    from normals of standard deviations ``mul`` (q, K, V)."""
    hkv, g, d = 2, 8, 128
    art = Quantizer.from_kv_dtype(kv_dtype).quantized_kv(
        rand(gen, (2, cap, hkv, d), torch.float32) * mul[1],
        rand(gen, (2, cap, hkv, d), torch.float32) * mul[2])
    q = rand(gen, (2, hkv * g, d)) * mul[0]
    return [quant_case(q, art, bucket, kv_len, s or Planner(
        policy="paper", num_cores=sms).plan(AttentionSpec.decode(
            b, bucket, hkv * g, hkv, d, kv_dtype=kv_dtype)).num_splits,
        kv_dtype) for b, bucket, kv_len, s in shapes]


def check_decode_quant(c):
    """The quantized cache's fused decode kernel at case ``c`` over its
    poisoned view against ``decode_quant_plain`` over the clean one
    (QUANT_TOL), then again for the same bits, and its partials-only
    epilogue (merged by ``combine_plain``) the same way.  Returns the max
    abs error and (a call that reruns the kernel, its first output, the
    label)."""
    qp, lens, s = c["qp"], c["lens"], c["s"]
    run = functools.partial(fdq.flash_decode_quant, qp, *c["pview"], lens,
                            num_splits=s)
    got = run()
    want = fdq.decode_quant_plain(qp, *c["view"], lens, num_splits=s)
    err = max_err(got, want, QUANT_TOL)
    check(torch.equal(got, run()),
          f"decode_quant {c['label']}: same split, other bits")
    parts = flash_decode_quant_partials(qp, *c["pview"], lens, num_splits=s)
    max_err(combine_plain(*parts, out_dtype=qp.dtype), want, QUANT_TOL)
    return err, (run, got, c["label"])


def parity_quant(gen, sms: int, kv_dtype: str, reruns) -> float:
    """The quantized cache's decode kernel against its plain version at
    the bucket grid (and, through ``ops.decode_attention_quant``, against
    the naive attention over the dequantized cache), at the decode shapes,
    at S > 32 and on the model's regime of data; appends each case's
    rerun to ``reruns``.  Returns the max abs error."""
    err = 0.0
    hkv, g, d, cap = 2, 8, 128, 2048
    qz = Quantizer.from_kv_dtype(kv_dtype)
    cases = []
    for b in (1, 2):
        art = qz.quantized_kv(rand(gen, (b, cap, hkv, d), torch.float32),
                              rand(gen, (b, cap, hkv, d), torch.float32))
        q = rand(gen, (b, hkv * g, d))
        for bucket in (128, 512, 2048):
            lens = [bucket - 17, bucket // 2 + 5][:b]
            plan = Planner(policy="paper", num_cores=sms).plan(
                AttentionSpec.decode(b, bucket, hkv * g, hkv, d,
                                     kv_dtype=kv_dtype), bucket=bucket)
            for s in sorted({1, 3, plan.num_splits}):
                c = quant_case(q, art, bucket, lens, s, kv_dtype)
                fixed = Planner(num_splits_override=s).plan(
                    AttentionSpec.decode(b, bucket, hkv * g, hkv, d,
                                         kv_dtype=kv_dtype), bucket=bucket)
                full = ops.decode_attention_quant(q, c["poisoned"],
                                                  c["lens"], plan=fixed)
                view = c["view"]
                max_err(full, ref.naive_decode_attention(
                    q, qz.dequantize(view.k, view.k_scale),
                    qz.dequantize(view.v, view.v_scale), c["lens"]),
                        QUANT_TOL)
                cases.append(c)
    # the serving run's and the paper cell's decode shapes, S > 32, and
    # the model's regime, K x 10 and V x 100 before quantization
    cases += quant_shapes(gen, sms, kv_dtype) + quant_shapes(
        gen, sms, kv_dtype, WIDE_SPLIT_SHAPES, 8192) + quant_shapes(
        gen, sms, kv_dtype, SHARP_SHAPES, mul=SHARP_MUL)
    for c in cases:
        e, rerun = check_decode_quant(c)
        err = max(err, e)
        reruns.append(rerun)
        print(f"parity decode_quant {c['label']} tails poisoned, fused and "
              f"partials only: ok")
    return err


def poison_tail(x, lens, value: float):
    """A copy of cache ``x`` whose rows at or past kv_len hold ``value``
    (NaN, Inf): a kernel that read one of them would return non-finite
    values."""
    y = x.clone()
    y[torch.arange(x.shape[1], device=DEVICE)[None] >= lens[:, None]] = value
    return y


def decode_case(q, k, v, bucket: int, kv_len, s: int):
    """One decode case over the cache ``k``, ``v`` (>= b, cap, hkv, d)
    and queries ``q`` (>= b, hq, d), b = len(kv_len): a dict with the
    label, b, bucket, S, kv_len, q, the cache rows k / v, their bucket
    views kv / vv, copies kp / vp whose rows past kv_len hold NaN / Inf,
    the pre-scaled qp (b, hkv, g, d) and SDPA on the clean views."""
    b = len(kv_len)
    hkv, d = k.shape[2:]
    lens = torch.tensor(kv_len, device=DEVICE, dtype=torch.int32)
    kv, vv = k[:b, :bucket], v[:b, :bucket]
    mask = (torch.arange(bucket, device=DEVICE)[None]
            < lens[:, None])[:, None, None]
    return dict(
        label=f"B{b} view{bucket} of {k.shape[1]} kv_len {list(kv_len)} "
              f"S{s}",
        b=b, bucket=bucket, s=s, lens=lens, q=q[:b], k=k[:b], v=v[:b],
        kv=kv, vv=vv, kp=poison_tail(k[:b], lens, float("nan")),
        vp=poison_tail(v[:b], lens, float("inf")),
        qp=(q[:b].float() * d ** -0.5).to(q.dtype).reshape(b, hkv, -1, d),
        sdpa=functools.partial(
            F.scaled_dot_product_attention, q[:b, :, None],
            kv.transpose(1, 2), vv.transpose(1, 2), attn_mask=mask,
            enable_gqa=True))


def decode_shapes(gen, sms: int, shapes=DECODE_SHAPES, cap: int = 2048,
                  mul=(1.0, 1.0, 1.0)):
    """decode_case of each of ``shapes`` (batch, bucket, kv_len, S or
    None for the paper policy's at ``sms`` SMs) over one random bf16
    cache of 2 x ``cap`` rows, 16/2 heads, D=128, q, K and V drawn from
    normals of standard deviations ``mul``."""
    hkv, g, d = 2, 8, 128
    k = rand(gen, (2, cap, hkv, d)) * mul[1]
    v = rand(gen, (2, cap, hkv, d)) * mul[2]
    q = rand(gen, (2, hkv * g, d)) * mul[0]
    return [decode_case(q, k, v, bucket, kv_len, s or Planner(
        policy="paper", num_cores=sms).plan(AttentionSpec.decode(
            b, bucket, hkv * g, hkv, d)).num_splits)
            for b, bucket, kv_len, s in shapes]


def check_decode(c):
    """The fused decode kernel at case ``c`` over its NaN/Inf-tailed
    cache against ``decode_plain`` over the clean one (DECODE_TOL), then
    again for the same bits.  Returns the max abs error and (a call that
    reruns the kernel, its first output, the label)."""
    bucket, s = c["bucket"], c["s"]
    run = functools.partial(fdec.flash_decode, c["qp"],
                            c["kp"][:, :bucket], c["vp"][:, :bucket],
                            c["lens"], num_splits=s)
    got = run()
    err = max_err(got, fdec.decode_plain(c["qp"], c["kv"], c["vv"],
                                         c["lens"], num_splits=s),
                  DECODE_TOL)
    check(torch.equal(got, run()),
          f"decode {c['label']}: same split, other bits")
    return err, (run, got, c["label"])


def wide_cases(gen, kv_dtype=None, shapes=WIDE_SHAPES, cap: int = 4096,
               mul=(1.0, 1.0, 1.0), groups=WIDE_GROUPS, dims=WIDE_DIMS):
    """decode_case (or, with ``kv_dtype``, quant_case) at each of
    ``shapes`` for every G of ``groups`` and D of ``dims``, each (G, D)
    over one random cache of 2 x ``cap`` rows, H_KV 1 at G >= 32 and 2
    below, q, K and V drawn from normals of standard deviations
    ``mul``."""
    cases = []
    for g in groups:
        for d in dims:
            hkv = 1 if g >= 32 else 2
            k, v = (rand(gen, (2, cap, hkv, d), torch.float32) * m
                    for m in mul[1:])
            q = rand(gen, (2, hkv * g, d)) * mul[0]
            if kv_dtype:
                art = Quantizer.from_kv_dtype(kv_dtype).quantized_kv(k, v)
                new = [quant_case(q, art, bucket, kv_len, s, kv_dtype)
                       for _, bucket, kv_len, s in shapes]
            else:
                k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
                new = [decode_case(q, k, v, bucket, kv_len, s)
                       for _, bucket, kv_len, s in shapes]
            for c in new:
                c["label"] = f"G{g} D{d} {c['label']}"
            cases += new
    return cases


def wide_grid(gen, kv_dtype=None):
    """The repair's decode cases of one cache type: WIDE_GROUPS x
    WIDE_DIMS at WIDE_SHAPES; G = 64 on the K x 10, V x 100 data at
    WIDE_SHARP_SHAPES; G 32 and 64 on that data at WIDE_SHARP_LONG_SHAPES;
    WIDE_MULTI_GROUPS at WIDE_MULTI_SHAPES; and WIDE_D64_GROUPS at D 64."""
    return (wide_cases(gen, kv_dtype)
            + wide_cases(gen, kv_dtype, WIDE_SHARP_SHAPES, mul=SHARP_MUL,
                         groups=(64,))
            + wide_cases(gen, kv_dtype, WIDE_SHARP_LONG_SHAPES,
                         mul=SHARP_MUL, groups=(32, 64), dims=(128,))
            + wide_cases(gen, kv_dtype, WIDE_MULTI_SHAPES,
                         groups=WIDE_MULTI_GROUPS, dims=(128,))
            + wide_cases(gen, kv_dtype, groups=WIDE_D64_GROUPS, dims=(64,)))


def parity_wide(gen, errs, reruns) -> None:
    """The decode kernels at the repair's shapes (``wide_grid``), over
    poisoned tails, against their plain versions; each case joins
    ``reruns``."""
    for c in wide_grid(gen):
        err, rerun = check_decode(c)
        errs["flash_decode"] = max(errs["flash_decode"], err)
        reruns.append(rerun)
        print(f"parity decode {c['label']} tails NaN/Inf: ok, max abs err "
              f"{err:.3g}")
    for kv_dtype in ("int8", "fp8"):
        for c in wide_grid(gen, kv_dtype):
            err, rerun = check_decode_quant(c)
            errs["flash_decode_quant"] = max(errs["flash_decode_quant"], err)
            reruns.append(rerun)
            print(f"parity decode_quant {c['label']} tails poisoned, fused "
                  f"and partials only: ok, max abs err {err:.3g}")


def phase_parity(gen, sms: int, wide_gen=None):
    """Every kernel against its plain version.  The main path's cases draw
    from ``gen`` in the order every slice of the port has drawn them, and
    their output digests are printed (on a line starting ``parity
    digests``), so two checkouts can be compared bit for bit; with
    ``wide_gen`` the repair's shapes (G > 16, D 160 and 256) follow, drawn
    from it."""
    errs = {name: 0.0 for name in REPLACES}
    hkv, g, d, cap = 2, 8, 128, 2048
    reruns, digests = [], []
    for b in (1, 2):
        k = rand(gen, (b, cap, hkv, d))
        v = rand(gen, (b, cap, hkv, d))
        q = rand(gen, (b, hkv * g, d))
        for bucket in (128, 512, 2048):
            lens = [bucket - 17, bucket // 2 + 5][:b]
            plan = Planner(policy="paper", num_cores=sms).plan(
                AttentionSpec.decode(b, bucket, hkv * g, hkv, d),
                bucket=bucket)
            for s in sorted({1, 3, plan.num_splits}):
                c = decode_case(q, k, v, bucket, lens, s)
                err, rerun = check_decode(c)
                errs["flash_decode"] = max(errs["flash_decode"], err)
                reruns.append(rerun)
                qp, kpv, vpv = (c["qp"], c["kp"][:, :bucket],
                                c["vp"][:, :bucket])
                parts = flash_decode_partials(qp, kpv, vpv, c["lens"],
                                              num_splits=s)
                max_err(combine_plain(*parts, out_dtype=q.dtype),
                        fdec.decode_plain(qp, c["kv"], c["vv"], c["lens"],
                                          num_splits=s), DECODE_TOL)
                e = max_err(flash_combine(*parts, out_dtype=q.dtype),
                            combine_plain(*parts, out_dtype=q.dtype),
                            DECODE_TOL)
                errs["flash_combine"] = max(errs["flash_combine"], e)
                again = flash_combine(*flash_decode_partials(
                    qp, kpv, vpv, c["lens"], num_splits=s),
                    out_dtype=q.dtype)
                check(torch.equal(again, flash_combine(*parts,
                                                       out_dtype=q.dtype)),
                      f"partials {c['label']}: same split, other bits")
                full = ops.decode_attention(
                    q, c["kp"], c["vp"], c["lens"],
                    plan=Planner(num_splits_override=s).plan(
                        AttentionSpec.decode(b, bucket, hkv * g, hkv, d),
                        bucket=bucket))
                max_err(full, ref.naive_decode_attention(
                    q, c["kv"], c["vv"], c["lens"]), DECODE_TOL)
                print(f"parity decode {c['label']} tails NaN/Inf: ok")
    # the serving run's and the paper cell's decode shapes, S > 32, and
    # the model's regime
    for c in decode_shapes(gen, sms) + decode_shapes(
            gen, sms, WIDE_SPLIT_SHAPES, 8192) + decode_shapes(
            gen, sms, SHARP_SHAPES, mul=SHARP_MUL):
        err, rerun = check_decode(c)
        errs["flash_decode"] = max(errs["flash_decode"], err)
        reruns.append(rerun)
        print(f"parity decode {c['label']} tails NaN/Inf: ok")
    for kv_dtype in ("int8", "fp8"):
        errs["flash_decode_quant"] = max(
            errs["flash_decode_quant"], parity_quant(gen, sms, kv_dtype,
                                                     reruns))
    digests += [(label, bits(first)) for _, first, label in reruns]
    if wide_gen is not None:
        parity_wide(wide_gen, errs, reruns)
    # every case again, in turns of S and B and of the two decode kernels,
    # which share one workspace: each launch must have left the arrival
    # counters at zero
    for fn, first, label in reruns:
        check(torch.equal(fn(), first), f"decode {label}: other bits after "
                                        f"calls of other S and B")
    print(f"parity decode and decode_quant: {len(reruns)} cases rerun in "
          f"turns, same bits")
    errs["flash_prefill_f32"] = 0.0
    groups = [(gen, PREFILL_CASES, torch.bfloat16, (1.0, 1.0, 1.0)),
              (gen, PREFILL_SHARP_CASES, torch.bfloat16, SHARP_MUL),
              (gen, PREFILL_F32_CASES, torch.float32, (1.0, 1.0, 1.0))]
    if wide_gen is not None:
        groups += [
            (wide_gen, PREFILL_WIDE_CASES, torch.bfloat16, (1.0, 1.0, 1.0)),
            (wide_gen, PREFILL_WIDE_SHARP_CASES, torch.bfloat16, SHARP_MUL),
            (wide_gen, PREFILL_WIDE_F32_CASES, torch.float32,
             (1.0, 1.0, 1.0))]
    for src, cases, dtype, mul in groups:
        f32 = dtype == torch.float32
        key = "flash_prefill_f32" if f32 else "flash_prefill"
        tol = F32_TOL if f32 else PREFILL_TOL
        for b, lq, lk, hq, hkv, d, window, off, causal in cases:
            q, k, v = prefill_case(src, b, lq, lk, hq, hkv, d, dtype, mul)
            kw = dict(causal=causal, window=window, q_offset=off)
            got = flash_prefill(q, k, v, **kw)
            err = max_err(got, prefill_plain(q, k, v, **kw), tol)
            errs[key] = max(errs[key], err)
            check(torch.equal(got, flash_prefill(q, k, v, **kw)),
                  f"prefill {dtype} B{b} Lq{lq} Lk{lk}: same inputs, other "
                  f"bits")
            label = (f"prefill {str(dtype)[6:]} B{b} Lq{lq} Lk{lk} heads "
                     f"{hq}/{hkv} D{d} window {window} q_offset {off} "
                     f"causal {causal} q, K, V x {mul}")
            if src is gen:
                digests.append((label, bits(got)))
            print(f"parity {label}: ok, max abs err {err:.3g}")
    torch.cuda.synchronize()
    print(f"parity max abs errors: {json.dumps(errs)}")
    print(f"parity digests of the main path's {len(digests)} cases: "
          f"{json.dumps(digests)}")
    return errs


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------


class CheckedGreedy(GreedySampler):
    """Greedy sampling that also keeps, on the device, whether every
    logit was finite and each row's top-2 margin."""

    def __init__(self):
        self.finite = torch.ones((), dtype=torch.bool, device=DEVICE)
        self.margins = []

    def sample(self, logits):
        self.finite &= torch.isfinite(logits).all()
        top = torch.topk(logits, 2, dim=-1).values
        self.margins.append(top[:, 0] - top[:, 1])
        return super().sample(logits)


def drive(engine, requests, sampler=None):
    """Submit everything, then step to completion.  Returns per-request
    TTFT ms, the ms of steps that only decoded, the wall seconds, the
    completions, given the engine's CheckedGreedy ``sampler`` the top-2
    logit margin behind each emitted token, keyed (request index, token
    index) (a device scalar, or None where it cannot be told), and each
    admission step as (prompt buckets admitted, wall ms)."""
    t0 = time.perf_counter()
    submitted = {engine.submit(r): r.request_id for r in requests}
    first, decode_ms, margins, admits = {}, [], {}, []
    while engine.has_work():
        prefills = {k: v for k, v in engine.stats.launches.items()
                    if isinstance(k, tuple)}
        live = {st.handle: i for i, st in engine.sched.live()}
        calls = len(sampler.margins) if sampler is not None else 0
        ts = time.perf_counter()
        events = engine.step()       # ends in a host copy of the tokens
        te = time.perf_counter()
        buckets = sorted(k[1] for k, v in engine.stats.launches.items()
                         if isinstance(k, tuple)
                         for _ in range(v - prefills.get(k, 0)))
        if buckets:
            admits.append((buckets, (te - ts) * 1e3))
        else:
            decode_ms.append((te - ts) * 1e3)
        for ev in events:
            if ev.kind == TOKEN and ev.handle not in first:
                first[ev.handle] = (te - t0) * 1e3
        if sampler is not None:
            # one sampler call per admission (one row), in order, then one
            # decode call over all slots
            now = {st.handle: i for i, st in engine.sched.live()}
            admitted = 0
            for ev in events:
                if ev.kind != TOKEN:
                    continue
                if ev.index == 0 and ev.handle not in live:
                    m = sampler.margins[calls + admitted][0]
                    admitted += 1
                else:
                    slot = live.get(ev.handle, now.get(ev.handle))
                    m = None if slot is None else sampler.margins[-1][slot]
                margins[(submitted[ev.handle], ev.index)] = m
    wall = time.perf_counter() - t0
    return ([first[h] for h in submitted], decode_ms, wall,
            engine.drain(), margins, admits)


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def phase_serving(model, params, cfg, seed: int, kv_quant=None,
                  bf16=None):
    """The main path: 4 requests through 2 slots, with a bf16 cache or
    under ``kv_quant``.  Returns the launch counts, the JSON-safe metrics
    and the streams with their margins; ``bf16`` is the bf16 run's
    streams, which a quantized run's are printed against (never
    checked)."""
    label = kv_quant or "bf16"
    rng = np.random.default_rng(seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=32) for i, n in enumerate(SERVING_PROMPTS)]
    scfg = ServeConfig(model=cfg, seed=seed, kv_quant=kv_quant)
    # warm-up on a throwaway engine: the same prompt buckets, 2 tokens
    # each, so one-time library set-up stays out of the measured run
    warm = ServingEngine(model, scfg, max_len=2048, batch_slots=2,
                         policy="paper", device=DEVICE)
    warm.load(params)
    drive(warm, [Request(r.request_id, r.prompt, max_new_tokens=2)
                 for r in reqs])
    del warm
    sampler = CheckedGreedy()
    engine = ServingEngine(model, scfg, max_len=2048, batch_slots=2,
                           policy="paper", sampler=sampler, device=DEVICE)
    engine.load(params)
    ops.reset_launch_counts()
    ops.reset_policy_eval_count()
    ttft, decode_ms, wall, done, margins, admits = drive(engine, reqs,
                                                         sampler)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    by_shape = ops.launch_counts_by_key("flash_prefill")
    decode = "flash_decode_quant" if kv_quant else "flash_decode"
    other = "flash_decode" if kv_quant else "flash_decode_quant"
    decode_by_shape = {f"{L} S{s}": n for (L, s), n in sorted(
        ops.launch_counts_by_key(decode).items())}
    st = engine.stats
    admissions = sum(v for k, v in st.launches.items()
                     if isinstance(k, tuple))
    steps = sum(v for k, v in st.launches.items() if isinstance(k, int))
    layers = cfg.num_layers
    print(f"serving {label} launches {json.dumps(counts)} admissions "
          f"{admissions} decode steps {steps} plan misses {st.misses} "
          f"distinct buckets {st.distinct_buckets} policy evals "
          f"{ops.policy_eval_count()}")
    check(engine._caches["k"].dtype == (
        QUANT_DTYPES[kv_quant].torch_dtype if kv_quant else torch.bfloat16),
        f"{label}: cache dtype")
    check(bool(sampler.finite.item()),
          f"{label}: non-finite logits at full width")
    check(counts["flash_prefill"] == layers * admissions == layers * 4,
          f"{label}: prefill launches != layers x admissions")
    check(by_shape == {("bfloat16", k[1]): layers * v
                       for k, v in st.launches.items()
                       if isinstance(k, tuple)},
          f"{label}: prefill launches by (dtype, Lq) {by_shape} != layers "
          f"x admissions by bucket")
    check(counts[decode] == layers * steps
          == sum(decode_by_shape.values()),
          f"{label}: {decode} launches != layers x decode steps")
    check(counts[other] == 0, f"{label}: {other} launched")
    # both decode kernels merge their own splits
    check(counts["flash_combine"] == 0,
          f"{label}: {counts['flash_combine']} combine launches")
    check(ops.policy_eval_count() == 0,
          f"{label}: policy evaluated inside a launch")
    check(st.misses == st.distinct_buckets, f"{label}: plan misses != "
          f"buckets")
    check([len(c.tokens) for c in done] == [32] * 4,
          f"{label}: wrong token counts")
    check(all(c.finish_reason == "length" for c in done),
          f"{label}: finish reasons")
    tokens = sum(len(c.tokens) for c in done)
    print(f"serving {label} planned splits {engine.planned_splits()} "
          f"prefill buckets {engine.planned_prefill_buckets()} decode "
          f"launches by (view, S) {decode_by_shape}")
    print(f"serving {label} ttft ms {[round(x, 3) for x in ttft]} median "
          f"decode step ms {median(decode_ms):.3f} over {len(decode_ms)} "
          f"steps, {tokens} tokens in {wall:.3f} s = {tokens / wall:.3f} "
          f"tokens/s")
    for buckets, ms in admits:
        print(f"serving {label} admission step, prompt buckets {buckets}: "
              f"{ms:.3f} ms wall")
    out = {"ttft_ms": ttft, "decode_step_ms": median(decode_ms),
           "tokens_per_s": tokens / wall,
           "admission_steps": [{"buckets": bk, "ms": ms}
                               for bk, ms in admits],
           "prefill_launches": {f"{dt} {lq}": n
                                for (dt, lq), n in by_shape.items()},
           "decode_launches": decode_by_shape}
    trace = {"streams": [c.tokens for c in done], "margins": margins}
    if bf16 is not None:
        out["leaves_bf16_at"] = leaves_at(bf16, trace, label)
    return counts, out, trace


def leaves_at(base, run, label):
    """Per request, the first token index where ``run``'s stream leaves
    ``base``'s, printed with both runs' top-2 logit margins there."""
    where = []
    for r, (a, b) in enumerate(zip(base["streams"], run["streams"])):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        where.append(i)
        if i is None:
            print(f"serving {label} request {r}: stream equals bf16's")
            continue
        ma, mb = (m.get((r, i)) for m in (base["margins"], run["margins"]))
        ma, mb = (None if m is None else round(float(m), 4)
                  for m in (ma, mb))
        print(f"serving {label} request {r}: leaves bf16's stream at token "
              f"{i}; top-2 logit margin there {ma} (bf16) {mb} ({label})")
    return where


def phase_admission(model, params, cfg, seed: int, rounds: int = 5):
    """The serving cell's admission steps alone: its four prompts with 2
    new tokens each through 2 slots, so one step admits buckets [128,
    384] and decodes them once, and the next does the same for [512,
    1024].  ``rounds`` runs on one engine after a warm-up run, then one
    run under the profiler; returns each pair's step ms by run and the
    profiled run's wall, device busy and prefill-kernel ms.  Uses only
    engine calls that every slice of the port has, so it can time an
    older checkout's package too."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SERVING_PROMPTS]
    engine = ServingEngine(model, ServeConfig(model=cfg, seed=seed),
                           max_len=2048, batch_slots=2, policy="paper",
                           device=DEVICE)
    engine.load(params)
    by_pair = {}
    for run in range(rounds + 1):
        *_, admits = drive(engine, [Request(i, p, max_new_tokens=2)
                                    for i, p in enumerate(prompts)])
        for buckets, ms in admits if run else ():
            by_pair.setdefault(str(buckets), []).append(ms)
    for pair, ms in by_pair.items():
        print(f"admission step {pair}: median {median(ms):.3f} ms, runs "
              f"{[round(x, 3) for x in ms]}")
    # one more run under the profiler: the device's share of those steps
    with profiled() as (prof, wall):
        drive(engine, [Request(i, p, max_new_tokens=2)
                       for i, p in enumerate(prompts)])
    kernels, launches = device_kernels(prof)
    busy = sum(kernels.values())
    prefill = sum(v for k, v in kernels.items() if "prefill_kernel" in k)
    print(f"admission profile, both steps: wall {wall[0]:.3f} ms (profiler "
          f"on), device busy {busy:.3f} ms, prefill kernel {prefill:.3f} "
          f"ms, {launches} device operations")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {ms:.4f} ms  {name[:80]}")
    return {"step_ms": by_pair, "profile": {
        "wall_ms": wall[0], "device_busy_ms": busy,
        "prefill_kernel_ms": prefill, "device_ops": launches}}


@contextlib.contextmanager
def ops_route(name: str, fn):
    """Within the block, ``ops`` calls ``fn`` in place of its kernel
    wrapper ``name`` (same signature): ``flash_decode`` for a bf16 or f32
    cache's decode, ``flash_prefill`` for prefill."""
    saved = getattr(ops, name)
    setattr(ops, name, fn)
    try:
        yield
    finally:
        setattr(ops, name, saved)


def cuda_core_decode(q, k, v, kv_len, *, num_splits, out_dtype):
    """The decode kernel's CUDA-core body with the same fused epilogue:
    the bf16 query widened to f32 (exactly) over the same bf16 cache."""
    return fdec.flash_decode(q.float(), k, v, kv_len, num_splits=num_splits,
                             out_dtype=out_dtype)


def prefill_checked(model, params, cfg, rng, lens, kv_dtype="bfloat16"):
    """Prompts of ``lens`` tokens drawn from ``rng``, prefilled one per
    slot (bucket-padded, as the engine does) into a new ``kv_dtype``
    cache of 2048 rows, every layer's prefill attention held against
    ``prefill_plain`` on the same inputs at PREFILL_TOL.  Returns the
    caches, each prompt's greedy next token, and the check's max abs
    error and count."""
    caches = model.init_cache(len(lens), 2048, kv_dtype=kv_dtype)
    first = []
    pre = {"max_abs_err": 0.0, "launches": 0}

    def checked_prefill(q, k, v, **kw):
        got = flash_prefill(q, k, v, **kw)
        pre["max_abs_err"] = max(pre["max_abs_err"], max_err(
            got, prefill_plain(q, k, v, **kw), PREFILL_TOL))
        pre["launches"] += 1
        return got

    with ops_route("flash_prefill", checked_prefill):
        for slot, n in enumerate(lens):
            toks = torch.tensor(rng.integers(0, cfg.vocab_size, n),
                                device=DEVICE)
            padded = torch.zeros(-(-n // 128) * 128, dtype=toks.dtype,
                                 device=DEVICE)
            padded[:n] = toks
            first.append(model.prefill_slot(params, caches, padded, slot,
                                            n).argmax())
    return caches, first, pre


def phase_logits(model, params, cfg, seed: int, sms: int,
                 steps: int = LOGITS_STEPS):
    """The full-width model's first ``steps`` decode steps at each of
    LOGITS_CELLS, teacher-forced: the prompts are prefilled once
    (bucket-padded, as the engine does; every layer's prefill attention
    held against ``prefill_plain`` on the same inputs at PREFILL_TOL) and
    each route decodes from a copy of that cache with the cell's frozen
    ``paper`` plan, fed the tensor-core route's greedy tokens.  Routes:
    the tensor-core kernel (the main path), its CUDA-core body,
    ``decode_plain`` with one element of one layer's output moved by one
    bf16 step (a control), and ``decode_plain``.  On the tensor-core
    route every layer's attention output is held against
    ``decode_plain`` on the same inputs (the model's own q and cache) at
    DECODE_TOL.  Per step, each kernel route's logits are compared with the plain route's
    (relative L2, max abs, argmax): printed, not checked, since a change
    of one bf16 step in one layer's attention can move this random-weight
    model's logits by their own size (see PERF.md)."""
    rng = np.random.default_rng(seed + 2)
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    out = {}
    for lens, bucket in LOGITS_CELLS:
        b = len(lens)
        caches, first, pre = prefill_checked(model, params, cfg, rng, lens)
        plan = Planner(policy="paper", num_cores=sms).plan(
            AttentionSpec.decode(b, bucket, hq, hkv, d), bucket=bucket)
        cell = f"B{b} bucket{bucket} S{plan.num_splits}"
        check(pre["launches"] == cfg.num_layers * b,
              f"logits {cell}: {pre['launches']} prefill checks")
        print(f"logits {cell}: prefill attention of {pre['launches']} "
              f"layer prompts against prefill_plain on the model's inputs: "
              f"max abs err {pre['max_abs_err']:.4g}")
        attn = {"max_abs_err": 0.0, "launches": 0}

        def checked(q, k, v, kv_len, *, num_splits, out_dtype):
            got = fdec.flash_decode(q, k, v, kv_len, num_splits=num_splits,
                                    out_dtype=out_dtype)
            want = fdec.decode_plain(q, k, v, kv_len, num_splits=num_splits,
                                     out_dtype=out_dtype)
            attn["max_abs_err"] = max(attn["max_abs_err"],
                                      max_err(got, want, DECODE_TOL))
            attn["launches"] += 1
            return got

        nudged = []

        def plain_nudged(q, k, v, kv_len, *, num_splits, out_dtype):
            """decode_plain, with one element of the first layer's first
            output moved by one bf16 step: how far one rounding moves
            the logits."""
            o = fdec.decode_plain(q, k, v, kv_len, num_splits=num_splits,
                                  out_dtype=out_dtype)
            if not nudged:
                nudged.append(o.flatten()[0].item())
                o.view(torch.int16).flatten()[0] += 1
            return o

        routes = {"tensor_cores": checked, "cuda_cores": cuda_core_decode,
                  "plain_nudged": plain_nudged, "plain": fdec.decode_plain}
        pos = torch.tensor(lens, device=DEVICE)
        logits, fed = {}, [torch.stack(first)]
        for name, fn in routes.items():
            cache = {key: x.clone() for key, x in caches.items()}
            logits[name] = []
            with ops_route("flash_decode", fn):
                for i in range(steps):
                    x = model.decode_step(params, cache, fed[i], pos + i,
                                          plan=plan)
                    check(bool(torch.isfinite(x).all()),
                          f"logits {cell} {name}: non-finite")
                    logits[name].append(x.float())
                    if name == "tensor_cores":
                        fed.append(x.argmax(-1))
        check(attn["launches"] == cfg.num_layers * steps,
              f"logits {cell}: {attn['launches']} attention checks")
        print(f"logits {cell}: attention of {attn['launches']} layer steps "
              f"against decode_plain on the model's inputs: max abs err "
              f"{attn['max_abs_err']:.4g}")
        res = {"prefill_attention": pre, "attention": attn,
               "logit_rms": logits["plain"][0].pow(
            2).mean().sqrt().item()}
        for name in ("tensor_cores", "cuda_cores", "plain_nudged"):
            rel, mx, agree = [], [], []
            for got, want in zip(logits[name], logits["plain"]):
                rel.append(((got - want).norm() / want.norm()).item())
                mx.append((got - want).abs().max().item())
                agree.append(bool((got.argmax(-1)
                                   == want.argmax(-1)).all()))
            res[name] = {"rel_l2": rel, "max_abs": mx, "argmax_agrees": agree}
            print(f"logits {cell} {name} vs plain, steps 0..{steps - 1}: "
                  f"rel L2 {[f'{x:.3e}' for x in rel]} max abs "
                  f"{[round(x, 4) for x in mx]} argmax agrees {agree}")
        out[cell] = res
    return out


def phase_logits_quant(model, params, cfg, seed: int, sms: int,
                       kv_dtype: str, steps: int = LOGITS_STEPS):
    """Phase 3's per-layer check over a ``kv_dtype`` cache at the main
    path's cell (LOGITS_CELLS' first, B=2, bucket 1024): the same prompts
    as phase_logits prefilled into a quantized cache, then ``steps``
    greedy decode steps under the cell's frozen ``paper`` plan, every
    layer's quantized decode attention (the model's own q and quantized
    cache) held against ``decode_quant_plain`` at QUANT_TOL."""
    rng = np.random.default_rng(seed + 2)
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    lens, bucket = LOGITS_CELLS[0]
    b = len(lens)
    caches, first, pre = prefill_checked(model, params, cfg, rng, lens,
                                         kv_dtype)
    plan = Planner(policy="paper", num_cores=sms).plan(
        AttentionSpec.decode(b, bucket, hq, hkv, d, kv_dtype=kv_dtype),
        bucket=bucket)
    cell = f"{kv_dtype} B{b} bucket{bucket} S{plan.num_splits}"
    attn = {"max_abs_err": 0.0, "launches": 0}

    def checked(q, k, v, k_scale, v_scale, kv_len, *, num_splits,
                out_dtype):
        got = fdq.flash_decode_quant(q, k, v, k_scale, v_scale, kv_len,
                                     num_splits=num_splits,
                                     out_dtype=out_dtype)
        want = fdq.decode_quant_plain(q, k, v, k_scale, v_scale, kv_len,
                                      num_splits=num_splits,
                                      out_dtype=out_dtype)
        attn["max_abs_err"] = max(attn["max_abs_err"],
                                  max_err(got, want, QUANT_TOL))
        attn["launches"] += 1
        return got

    pos = torch.tensor(lens, device=DEVICE)
    tok = torch.stack(first)
    with ops_route("flash_decode_quant", checked):
        for i in range(steps):
            x = model.decode_step(params, caches, tok, pos + i, plan=plan)
            check(bool(torch.isfinite(x).all()), f"logits {cell}: non-finite")
            tok = x.argmax(-1)
    check(pre["launches"] == cfg.num_layers * b
          and attn["launches"] == cfg.num_layers * steps,
          f"logits {cell}: {pre['launches']} prefill and {attn['launches']} "
          f"decode attention checks")
    print(f"logits {cell}: prefill attention of {pre['launches']} layer "
          f"prompts against prefill_plain, max abs err "
          f"{pre['max_abs_err']:.4g}; quantized decode attention of "
          f"{attn['launches']} layer steps against decode_quant_plain on "
          f"the model's inputs: max abs err {attn['max_abs_err']:.4g}")
    return {"prefill_attention": pre, "attention": attn}


def phase_paper_cell(model, params, cfg, seed: int, flush, sms: int,
                     kv_quant=None, runs_per_policy: int = 3):
    label = kv_quant or "bf16"
    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(0, cfg.vocab_size, 420).tolist()
    runs = {"paper": [], "fa3_baseline": []}
    for policy in ("paper", "fa3_baseline") * runs_per_policy:
        sampler = CheckedGreedy()
        engine = ServingEngine(model, ServeConfig(model=cfg,
                                                  kv_quant=kv_quant),
                               max_len=2048, batch_slots=1, policy=policy,
                               sampler=sampler, device=DEVICE)
        engine.load(params)
        _, decode_ms, _, done, _, _ = drive(
            engine, [Request(0, prompt, max_new_tokens=64)])
        check(bool(sampler.finite.item()), f"{label}: non-finite logits")
        runs[policy].append((engine.planned_splits(), decode_ms,
                             done[0].tokens,
                             torch.cat(sampler.margins).tolist()))
    out = {}
    for policy, rs in runs.items():
        splits = rs[0][0]
        per_run = [median(r[1]) for r in rs]
        ms = median([m for r in rs for m in r[1]])
        print(f"paper cell {label} {policy}: planned splits {splits} median "
              f"decode step ms {ms:.3f} (per run "
              f"{[round(x, 3) for x in per_run]})")
        out[policy] = {"splits": splits, "decode_step_ms": ms,
                       "per_run_ms": per_run}
    if kv_quant:
        # the policies read no dtype_bytes: a quantized cache plans as bf16
        check(out["paper"]["splits"] == {512: 3}
              and out["fa3_baseline"]["splits"] == {512: 1},
              f"{label}: paper cell splits {out['paper']['splits']} / "
              f"{out['fa3_baseline']['splits']}")
    a, b = runs["paper"][0], runs["fa3_baseline"][0]
    if a[2] == b[2]:
        print(f"paper cell {label}: token streams match")
    else:
        i = next(j for j, (x, y) in enumerate(zip(a[2], b[2])) if x != y)
        print(f"paper cell {label}: streams differ at token {i}; top-2 logit "
              f"margin there {a[3][i]:.4g} (paper) {b[3][i]:.4g} "
              f"(fa3_baseline)")
    # the decode kernel alone at this cell's shape: B=1, 512 view
    lens = torch.tensor([484], device=DEVICE, dtype=torch.int32)
    qp = torch.randn((1, 2, 8, 128), device=DEVICE).to(torch.bfloat16)
    if kv_quant:
        art = Quantizer.from_kv_dtype(kv_quant).quantized_kv(
            torch.randn((1, 2048, 2, 128), device=DEVICE),
            torch.randn((1, 2048, 2, 128), device=DEVICE))
        view = [t[:, :512] for t in art]
        name = "decode_quant"

        def kernel(s):
            return fdq.flash_decode_quant(qp, *view, lens, num_splits=s)
    else:
        k = torch.randn((1, 2048, 2, 128), device=DEVICE).to(torch.bfloat16)
        name = "decode"

        def kernel(s):
            return fdec.flash_decode(qp, k[:, :512], k[:, :512], lens,
                                     num_splits=s)
    for s in (1, 3):
        ms = time_ms(lambda: kernel(s), 200, flush)
        print(f"paper cell {label} {name} kernel B1 view512 kv_len 484 "
              f"S{s}: {ms:.5f} ms")
        out[f"kernel_ms_s{s}"] = ms
    return out


@contextlib.contextmanager
def profiled():
    """torch.profiler over the block, CPU and CUDA; yields the profiler
    and a list that holds the block's wall ms once it ends."""
    wall = []
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield prof, wall
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)


def device_kernels(prof):
    """Device ms by kernel name, and the number of device operations."""
    from torch.autograd import DeviceType
    kernels, launches = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            launches += 1
            kernels[e.name] = kernels.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    return kernels, launches


def phase_profile(model, params, cfg, seed: int, steps: int = 8,
                  kv_quant=None):
    """Where a decode step's time goes: torch.profiler over ``steps``
    decode steps of the paper cell (B=1, 512 bucket, ``paper``), with a
    bf16 cache or under ``kv_quant``.  Reports the step's wall ms, the
    device's busy ms (sum of kernel durations), the idle share, the
    kernels launched per step, and the kernels with the most device
    time."""
    label = kv_quant or "bf16"
    rng = np.random.default_rng(seed + 1)
    engine = ServingEngine(model, ServeConfig(model=cfg, kv_quant=kv_quant),
                           max_len=2048, batch_slots=1, policy="paper",
                           device=DEVICE)
    engine.load(params)
    engine.submit(Request(0, rng.integers(0, cfg.vocab_size, 420).tolist(),
                          max_new_tokens=steps + 4))
    engine.step()
    engine.step()
    with profiled() as (prof, wall):
        for _ in range(steps):
            engine.step()
    wall_ms = wall[0] / steps
    kernels, launches = device_kernels(prof)
    busy_ms = sum(kernels.values()) / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
           "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
           "device_ops_per_step": launches / steps,
           "top_kernels_ms_per_step": {k[:80]: v / steps for k, v in top}}
    print(f"profile {label} decode step B1 bucket512 paper: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{out['idle_share']:.3f}, {launches / steps:.1f} device ops per "
          f"step (profiler on)")
    for name, ms in out["top_kernels_ms_per_step"].items():
        print(f"  {ms:.4f} ms/step  {name}")
    engine.drain()
    return out


# ---------------------------------------------------------------------------
# the paper's Table 1
# ---------------------------------------------------------------------------

# The paper's Table 1 (as benchmarks/table1_ab.py holds it): (L_K, H_KV) ->
# the paper's measured (standard us, patched us) of FA3's decode on an
# H100, B = 1, H_Q = 64, D = 128, bf16.  The patch changes the launch in
# exactly two cells.
PAPER_TABLE1 = {
    (128, 1): (9.56, 9.56), (128, 2): (9.45, 9.45), (128, 8): (9.46, 9.46),
    (256, 1): (11.57, 11.57), (256, 2): (11.58, 11.58),
    (256, 8): (11.60, 11.60),
    (384, 1): (13.60, 13.60), (384, 2): (13.57, 13.57),
    (384, 8): (13.55, 13.55),
    (512, 1): (13.72, 11.37), (512, 2): (13.52, 10.93),
    (512, 8): (13.56, 13.56),
    (2048, 1): (11.99, 11.99), (2048, 2): (12.66, 12.66),
    (2048, 8): (12.73, 12.73),
    (4096, 1): (13.88, 13.88), (4096, 2): (13.53, 13.53),
    (4096, 8): (15.05, 15.05),
}
TABLE1_CHANGED = {(512, 1), (512, 2)}
TABLE1_POLICIES = ("fa3_baseline", "paper")


def phase_table1(gen, sms: int, card: str, flush, iters: int = 100):
    """The paper's Table 1 on the card.  For each of its 18 cells (B=1,
    H_Q=64, D=128, bf16, kv_len = L_K) and each policy, the frozen plan
    ``get_scheduler_metadata(1, 1, L_K, 64, H_KV, 128, policy=...,
    num_cores=sms)``; the decode op (``ops.decode_attention``) under it,
    run once with the launch counts zeroed before and read after (the
    path), held against ``decode_plain`` at DECODE_TOL, and at DECODE_TOL
    of the largest output, and rerun for the same bits; then timed
    (``time_stats_us``), beside the decode kernel alone at
    the same split, SDPA (GQA) at the same shape, the bytes bound, the
    timing floor, the modeled latency of ``H100_SXM`` and the paper's
    numbers.  Each time is given as the mean, the median and the 10th to
    90th percentile of ``iters`` calls.  The cells where the two
    policies' splits differ must be
    TABLE1_CHANGED; no policy may run inside a call; the metadata cache
    must miss once per (cell, policy) and hit on the repeat.  The changed
    cells run again over an int8 cache.  Returns the cells' results and
    the kernels line's rows for the changed cells at ``paper``'s split."""
    from repro_torch.core import (H100_SXM, DecodeWorkload,
                                  get_scheduler_metadata,
                                  metadata_cache_info, modeled_latency_us)
    hq, d = 64, 128
    print(f"table1 on {card}: B=1 H_Q={hq} D={d} bf16 kv_len = L_K, "
          f"{' vs '.join(TABLE1_POLICIES)} at {sms} SMs, CUDA events, L2 "
          f"flushed, {iters} calls each")
    info0 = metadata_cache_info()

    def plan_of(lk, hkv, policy):
        return get_scheduler_metadata(1, 1, lk, hq, hkv, d, policy=policy,
                                      num_cores=sms)

    cells = {}
    for lk, hkv in PAPER_TABLE1:
        k, v = (rand(gen, (1, lk, hkv, d)) for _ in range(2))
        lens = torch.tensor([lk], device=DEVICE, dtype=torch.int32)
        cells[lk, hkv] = dict(q=rand(gen, (1, hq, d)), k=k, v=v, lens=lens,
                              plans={pol: plan_of(lk, hkv, pol)
                                     for pol in TABLE1_POLICIES})
    # the path: every (cell, policy) once through the decode op
    ops.reset_launch_counts()
    ops.reset_policy_eval_count()
    launches = {}
    for key, c in cells.items():
        c["out"] = {}
        for pol, plan in c["plans"].items():
            before = ops.launch_counts()["flash_decode"]
            c["out"][pol] = ops.decode_attention(c["q"], c["k"], c["v"],
                                                 c["lens"], plan=plan)
            launches[key, pol] = ops.launch_counts()["flash_decode"] - before
    torch.cuda.synchronize()
    check(ops.policy_eval_count() == 0, "table1: policy evaluated inside "
                                        "the decode op")
    check(all(n == 1 for n in launches.values()), f"table1: launches "
                                                  f"{launches}")
    tiny = torch.empty(1, device=DEVICE)
    floor_us = time_stats_us(lambda: tiny.fill_(1.0), iters, flush)
    results, rows = [], []
    for (lk, hkv), c in cells.items():
        q, k, v, lens = c["q"], c["k"], c["v"], c["lens"]
        qp = (q.float() * d ** -0.5).to(q.dtype).reshape(1, hkv, -1, d)
        w = DecodeWorkload(1, 1, lk, hq, hkv, d)
        row = {"L_K": lk, "H_KV": hkv, "G": hq // hkv,
               "paper_us": dict(zip(TABLE1_POLICIES,
                                    PAPER_TABLE1[lk, hkv]))}
        for pol in TABLE1_POLICIES:
            plan = plan_of(lk, hkv, pol)        # a hit: the same frozen plan
            s = plan.num_splits
            got = c["out"][pol]
            want = fdec.decode_plain(qp, k, v, lens,
                                     num_splits=s).reshape(1, hq, d)
            err = max_err(got, want, DECODE_TOL)
            # at L_K in the thousands an output is a few hundredths, so
            # the error is also held to DECODE_TOL of the largest one: a
            # dropped or mis-weighted split moves it further
            scale = want.float().abs().max().item()
            check(err <= DECODE_TOL * scale,
                  f"table1 ({lk}, {hkv}) {pol}: max abs err {err:.3e} over "
                  f"{DECODE_TOL} x the largest output {scale:.3e}")
            check(torch.equal(got, ops.decode_attention(q, k, v, lens,
                                                        plan=plan)),
                  f"table1 ({lk}, {hkv}) {pol}: other bits on a rerun")
            row[pol] = {
                "splits": s, "max_abs_err": err,
                "op_us": time_stats_us(functools.partial(
                    ops.decode_attention, q, k, v, lens, plan=plan), iters,
                    flush),
                "kernel_us": time_stats_us(functools.partial(
                    fdec.flash_decode, qp, k, v, lens, num_splits=s), iters,
                    flush),
                "model_us": modeled_latency_us(
                    w, s, num_cores=H100_SXM.num_cores, hw=H100_SXM),
                "launches": launches[(lk, hkv), pol]}
        sdpa = functools.partial(
            F.scaled_dot_product_attention, q[:, :, None], k.transpose(1, 2),
            v.transpose(1, 2), scale=d ** -0.5, enable_gqa=True)
        nbytes = 2 * lk * hkv * d * 2 + 2 * hq * d * 2   # K, V, q, output
        row["sdpa_us"] = time_stats_us(sdpa, iters, flush)
        row["bound_us"] = 1e3 * bound(nbytes, 4 * lk * hq * d)[0]
        row["floor_us"] = floor_us
        std, pat = (row[pol] for pol in TABLE1_POLICIES)
        p_std, p_pat = PAPER_TABLE1[lk, hkv]
        print(f"table1 L_K {lk} H_KV {hkv} (G {hq // hkv}): s_std "
              f"{std['splits']} s_patched {pat['splits']}; measured op "
              f"{fmt_stats(std['op_us'], pat['op_us'])}; kernel alone "
              f"{fmt_stats(std['kernel_us'], pat['kernel_us'])}; model "
              f"{std['model_us']:.2f} / {pat['model_us']:.2f} us; paper "
              f"{p_std} / {p_pat} us, speedup {p_std / p_pat:.3f}; SDPA "
              f"mean {row['sdpa_us']['mean']:.3f} median "
              f"{row['sdpa_us']['median']:.3f} us; bound "
              f"{row['bound_us']:.4f} us; floor mean "
              f"{floor_us['mean']:.3f} median {floor_us['median']:.3f} us")
        results.append(row)
        if (lk, hkv) in TABLE1_CHANGED:
            s = pat["splits"]
            rows.append(dict(
                name="flash_decode",
                shape=f"Table 1 L_K {lk} H_KV {hkv} G {hq // hkv} D {d} S{s} "
                      f"fused combine",
                fn=functools.partial(fdec.flash_decode, qp, k, v, lens,
                                     num_splits=s),
                plain=functools.partial(fdec.decode_plain, qp, k, v, lens,
                                        num_splits=s),
                lib=sdpa, nbytes=nbytes, flops=4 * lk * hq * d,
                err=pat["max_abs_err"], launches=pat["launches"]))
    changed = {(r["L_K"], r["H_KV"]) for r in results
               if r["fa3_baseline"]["splits"] != r["paper"]["splits"]}
    check(changed == TABLE1_CHANGED, f"table1: the policies differ at "
                                     f"{sorted(changed)}")
    check(ops.policy_eval_count() == 0, "table1: policy evaluated inside a "
                                        "timed call")
    info1 = metadata_cache_info()
    n = len(cells) * len(TABLE1_POLICIES)
    check((info1.misses - info0.misses, info1.hits - info0.hits) == (n, n),
          f"table1: metadata cache {info0} -> {info1}, want {n} misses and "
          f"{n} hits")
    print(f"table1: cells where the policies differ {sorted(changed)}; "
          f"metadata cache {n} misses then {n} hits; 0 policy evaluations "
          f"in the calls")
    # the changed cells over an int8 cache
    for lk, hkv in sorted(TABLE1_CHANGED):
        c = cells[lk, hkv]
        art = Quantizer.from_kv_dtype("int8").quantized_kv(
            c["k"].float(), c["v"].float())
        q, lens = c["q"], c["lens"]
        qp = (q.float() * d ** -0.5).to(q.dtype).reshape(1, hkv, -1, d)
        row = {"L_K": lk, "H_KV": hkv, "kv_dtype": "int8"}
        for pol in TABLE1_POLICIES:
            plan = c["plans"][pol]
            s = plan.num_splits
            before = ops.launch_counts()["flash_decode_quant"]
            got = ops.decode_attention_quant(q, art, lens, plan=plan)
            n_launch = ops.launch_counts()["flash_decode_quant"] - before
            err = max_err(got, fdq.decode_quant_plain(
                qp, *art, lens, num_splits=s).reshape(1, hq, d), QUANT_TOL)
            row[pol] = {
                "splits": s, "max_abs_err": err, "launches": n_launch,
                "op_us": time_stats_us(functools.partial(
                    ops.decode_attention_quant, q, art, lens, plan=plan),
                    iters, flush),
                "kernel_us": time_stats_us(functools.partial(
                    fdq.flash_decode_quant, qp, *art, lens, num_splits=s),
                    iters, flush)}
        std, pat = (row[pol] for pol in TABLE1_POLICIES)
        print(f"table1 int8 L_K {lk} H_KV {hkv}: s_std {std['splits']} "
              f"s_patched {pat['splits']}; measured op "
              f"{fmt_stats(std['op_us'], pat['op_us'])}; kernel alone "
              f"{fmt_stats(std['kernel_us'], pat['kernel_us'])}")
        results.append(row)
        s = pat["splits"]
        rows.append(dict(
            name="flash_decode_quant",
            shape=f"Table 1 int8 L_K {lk} H_KV {hkv} G {hq // hkv} D {d} "
                  f"S{s} fused combine",
            fn=functools.partial(fdq.flash_decode_quant, qp, *art, lens,
                                 num_splits=s),
            plain=functools.partial(fdq.decode_quant_plain, qp, *art, lens,
                                    num_splits=s),
            lib=None, nbytes=2 * lk * hkv * (d + 4) + 2 * hq * d * 2,
            flops=4 * lk * hq * d + 2 * lk * hkv * d, peak=INT8_OPS_PER_S,
            err=pat["max_abs_err"], launches=pat["launches"]))
    check(ops.policy_eval_count() == 0, "table1 int8: policy evaluated")
    return results, rows


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------


def phase_kernels_line(gen, sms: int, errs, counts, flush,
                       prefill_launches, decode_launches, quant_launches,
                       table1_rows):
    """``counts``: the main path's launches by kernel name;
    ``prefill_launches`` / ``decode_launches``: the bf16 serving run's
    prefill launches by "dtype Lq" and decode launches by "view S",
    ``quant_launches`` the int8 run's quantized decode launches by "view
    S": each row's ``launches``; ``table1_rows``: the rows of
    phase_table1 (the decode kernels at Table 1's changed cells, with the
    launches of that phase's path)."""
    hkv, g, d, b = 2, 8, 128, 2
    hq = hkv * g
    out = []
    cases = decode_shapes(gen, sms)
    for c in cases:
        rows = int(c["lens"].sum())
        qp, kv, vv, lens, s = c["qp"], c["kv"], c["vv"], c["lens"], c["s"]
        flops = 4 * rows * hkv * g * d
        err, _ = check_decode(c)
        out.append(dict(
            name="flash_decode", shape=c["label"] + " fused combine",
            fn=functools.partial(fdec.flash_decode, qp, kv, vv, lens,
                                 num_splits=s),
            plain=functools.partial(fdec.decode_plain, qp, kv, vv, lens,
                                    num_splits=s),
            lib=c["sdpa"],
            # K and V rows below kv_len, q, and the output
            nbytes=2 * rows * hkv * d * 2 + 2 * qp.numel() * 2, flops=flops,
            err=err, launches=decode_launches.get(f"{c['bucket']} S{s}", 0)))
    # K2 and K4 at the main path's shape, DECODE_SHAPES' first
    qp, kv, vv, lens, s = (cases[0][key] for key in ("qp", "kv", "vv",
                                                     "lens", "s"))
    parts = flash_decode_partials(qp, kv, vv, lens, num_splits=s)
    part_bytes = s * b * hkv * g * (d + 2) * 4
    out.append(dict(
        name="flash_combine", shape=f"S{s} B{b} Hkv{hkv} G{g} D{d}",
        fn=lambda: flash_combine(*parts, out_dtype=torch.bfloat16),
        plain=lambda: combine_plain(*parts, out_dtype=torch.bfloat16),
        lib=None, nbytes=part_bytes + b * hq * d * 2,
        flops=6 * s * b * hq * d))
    for lq, dtype in [(L, torch.bfloat16) for L in PREFILL_BUCKETS] + [
            (1024, torch.float32)]:
        pq, pk, pv = prefill_case(gen, 1, lq, lq, hq, hkv, d, dtype)
        pqs, pks, pvs = (t.transpose(1, 2) for t in (pq, pk, pv))
        f32 = dtype == torch.float32
        out.append(dict(
            name="flash_prefill",
            shape=f"B1 Lq=Lk={lq} Hq{hq} Hkv{hkv} D{d} causal "
                  f"{'f32, CUDA cores' if f32 else 'bf16, tensor cores'}",
            fn=functools.partial(flash_prefill, pq, pk, pv, causal=True),
            plain=functools.partial(prefill_plain, pq, pk, pv, causal=True),
            lib=functools.partial(F.scaled_dot_product_attention, pqs, pks,
                                  pvs, is_causal=True, scale=1.0,
                                  enable_gqa=True),
            nbytes=pq.element_size() * (2 * pq.numel() + pk.numel()
                                        + pv.numel()),
            flops=4 * hq * d * lq * (lq + 1) / 2,
            peak=F32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S,
            err=errs["flash_prefill_f32" if f32 else "flash_prefill"],
            tol=F32_TOL if f32 else PREFILL_TOL,
            launches=prefill_launches.get(f"{str(dtype)[6:]} {lq}", 0)))
    # K4 at the same decode shapes, over int8 caches with poisoned tails
    # (the quantized main path's cache), fused; then its partials-only
    # epilogue at the main path's shape, DECODE_SHAPES' first
    qcases = quant_shapes(gen, sms, "int8")
    for c in qcases:
        rows = int(c["lens"].sum())
        qp, pview, view, lens, s = (c[key] for key in ("qp", "pview", "view",
                                                        "lens", "s"))
        err, _ = check_decode_quant(c)
        out.append(dict(
            name="flash_decode_quant", shape=c["label"] + " fused combine",
            fn=functools.partial(fdq.flash_decode_quant, qp, *pview, lens,
                                 num_splits=s),
            plain=functools.partial(fdq.decode_quant_plain, qp, *view, lens,
                                    num_splits=s),
            lib=None,
            # K and V codes and scales below kv_len, q, and the output
            nbytes=2 * rows * hkv * (d + 4) + 2 * qp.numel() * 2,
            flops=4 * rows * hkv * g * d + 2 * rows * hkv * d,
            peak=INT8_OPS_PER_S, err=err,
            launches=quant_launches.get(f"{c['bucket']} S{s}", 0)))
    c, main = qcases[0], out[-len(qcases)]
    qp, pview, view, lens, s = (c[key] for key in ("qp", "pview", "view",
                                                    "lens", "s"))
    parts = flash_decode_quant_partials(qp, *pview, lens, num_splits=s)
    out.append(main | dict(
        shape=c["label"] + " partials only",
        fn=functools.partial(flash_decode_quant_partials, qp, *pview, lens,
                             num_splits=s),
        plain=functools.partial(decode_quant_partials_plain, qp, *view, lens,
                                num_splits=s),
        nbytes=main["nbytes"] - qp.numel() * 2 + part_bytes,
        err=max_err(combine_plain(*parts, out_dtype=qp.dtype),
                    fdq.decode_quant_plain(qp, *view, lens, num_splits=s),
                    QUANT_TOL),
        launches=0))
    out += table1_rows
    # the method's floor: one one-element fill_, timed the same way
    tiny = torch.empty(1, device=DEVICE)
    floor_ms = time_ms(lambda: tiny.fill_(1.0), 100, flush)
    print(f"timing floor (one one-element fill_): {floor_ms:.6f} ms")
    kernels = []
    for row in out:
        name, lib = row["name"], row["lib"]
        bms, by = bound(row["nbytes"], row["flops"],
                        row.get("peak", BF16_FLOPS_PER_S))
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "shape": row["shape"],
            "launches": row.get("launches", counts[name]),
            "max_abs_err": row.get("err", errs[name]),
            "tol": row.get("tol", TOLS[name]),
            "ms": time_ms(row["fn"], 100, flush),
            "plain_ms": time_ms(row["plain"], 10, flush),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(lib, 100, flush) if lib else None,
            "floor_ms": floor_ms})
        print(f"kernel {name} {row['shape']}: {kernels[-1]['ms']:.6f} ms, "
              f"bound {bms:.6f} ms ({by}), library "
              f"{kernels[-1]['library_ms']}, launches "
              f"{kernels[-1]['launches']}")
    return kernels


def phase_times(gen, sms: int, flush, iters: int = 200):
    """At each of DECODE_SHAPES: the decode op as the model calls it
    (``ops.decode_attention`` under a frozen plan of that S and bucket,
    q's scaling included), the partials kernel followed by the combine
    kernel, and SDPA; there again over int8 and fp8 caches, the quantized
    decode op (``ops.decode_attention_quant``) and the quantized partials
    kernel followed by the combine kernel; at each of PREFILL_BUCKETS the
    bf16 prefill kernel
    (B=1, 16/2 heads, D=128, causal) and SDPA; and the timing floor (one
    one-element ``fill_``), all by ``time_ms``, and a digest of each
    decode op's output bits (equal digests in two checkouts: the same
    bits).  Uses only calls every slice of the port has."""
    tiny = torch.empty(1, device=DEVICE)
    out = {"floor_ms": time_ms(lambda: tiny.fill_(1.0), iters, flush)}
    print(f"decode timing floor: {out['floor_ms']:.6f} ms")
    for c in decode_shapes(gen, sms):
        b, bucket, s = c["b"], c["bucket"], c["s"]
        hkv, g, d = c["qp"].shape[1:]
        plan = Planner(num_splits_override=s).plan(
            AttentionSpec.decode(b, bucket, hkv * g, hkv, d), bucket=bucket)
        pair = functools.partial(flash_decode_partials, c["qp"], c["kv"],
                                 c["vv"], c["lens"], num_splits=s)
        op = functools.partial(ops.decode_attention, c["q"], c["k"],
                               c["v"], c["lens"], plan=plan)
        res = {
            "op_bits": bits(op()),
            "op_ms": time_ms(op, iters, flush),
            "partials_then_combine_ms": time_ms(
                lambda: flash_combine(*pair(), out_dtype=torch.bfloat16),
                iters, flush),
            "sdpa_ms": time_ms(c["sdpa"], iters, flush)}
        print(f"decode {c['label']}: op {res['op_ms']:.6f} ms, partials "
              f"then combine {res['partials_then_combine_ms']:.6f} ms, "
              f"SDPA {res['sdpa_ms']:.6f} ms, op bits {res['op_bits']}")
        out[c["label"]] = res
    for kv_dtype in ("int8", "fp8"):
        for c in quant_shapes(gen, sms, kv_dtype):
            b, bucket, s = c["b"], c["bucket"], c["s"]
            hkv, g, d = c["qp"].shape[1:]
            plan = Planner(num_splits_override=s).plan(
                AttentionSpec.decode(b, bucket, hkv * g, hkv, d,
                                     kv_dtype=kv_dtype), bucket=bucket)
            pair = functools.partial(flash_decode_quant_partials, c["qp"],
                                     *c["view"], c["lens"], num_splits=s)
            op = functools.partial(ops.decode_attention_quant, c["q"],
                                   c["art"], c["lens"], plan=plan)
            res = {
                "op_bits": bits(op()),
                "op_ms": time_ms(op, iters, flush),
                "partials_then_combine_ms": time_ms(
                    lambda: flash_combine(*pair(), out_dtype=torch.bfloat16),
                    iters, flush)}
            print(f"decode {c['label']}: op {res['op_ms']:.6f} ms, "
                  f"partials then combine "
                  f"{res['partials_then_combine_ms']:.6f} ms, op bits "
                  f"{res['op_bits']}")
            out[c["label"]] = res
    for lq in PREFILL_BUCKETS:
        q, k, v = prefill_case(gen, 1, lq, lq, 16, 2, 128)
        res = {"kernel_ms": time_ms(functools.partial(
                   flash_prefill, q, k, v, causal=True), iters, flush),
               "sdpa_ms": time_ms(functools.partial(
                   F.scaled_dot_product_attention, *(
                       t.transpose(1, 2) for t in (q, k, v)),
                   is_causal=True, scale=1.0, enable_gqa=True), iters,
                   flush)}
        print(f"prefill bf16 B1 Lq=Lk={lq}: kernel {res['kernel_ms']:.6f} "
              f"ms, SDPA {res['sdpa_ms']:.6f} ms")
        out[f"prefill {lq}"] = res
    return out


# the reference configs' attention shapes that only the repair's bodies
# serve (--phase shapes): name, H_Q, H_KV, D
CONFIG_SHAPES = [("stablelm-12b", 32, 8, 160), ("paligemma-3b", 8, 1, 256),
                 ("recurrentgemma-9b", 16, 1, 256)]


def phase_shapes(gen, sms: int, flush, iters: int = 100):
    """The decode kernels (bf16, and int8 over a quantized cache) at B=2,
    view 1024, kv_len [1000, 450] under the ``paper`` plan, and the bf16
    prefill kernel at Lq = Lk = 512, causal, at each of CONFIG_SHAPES,
    beside SDPA and the bytes (or operations) bound, by ``time_ms``."""
    out = {}
    for name, hq, hkv, d in CONFIG_SHAPES:
        s = Planner(policy="paper", num_cores=sms).plan(AttentionSpec.decode(
            2, 1024, hq, hkv, d)).num_splits
        k, v = (rand(gen, (2, 1024, hkv, d)) for _ in range(2))
        c = decode_case(rand(gen, (2, hq, d)), k, v, 1024, (1000, 450), s)
        err, _ = check_decode(c)
        rows = int(c["lens"].sum())
        art = Quantizer.from_kv_dtype("int8").quantized_kv(k.float(),
                                                           v.float())
        qerr, _ = check_decode_quant(quant_case(c["q"], art, 1024,
                                                (1000, 450), s, "int8"))
        pq, pk, pv = prefill_case(gen, 1, 512, 512, hq, hkv, d)
        res = {
            "splits": s, "max_abs_err": err, "int8_max_abs_err": qerr,
            "decode_ms": time_ms(functools.partial(
                fdec.flash_decode, c["qp"], c["kp"], c["vp"], c["lens"],
                num_splits=s), iters, flush),
            "decode_sdpa_ms": time_ms(c["sdpa"], iters, flush),
            "decode_bound_ms": bound(2 * rows * hkv * d * 2
                                     + 2 * c["qp"].numel() * 2,
                                     4 * rows * hq * d)[0],
            "int8_decode_ms": time_ms(functools.partial(
                fdq.flash_decode_quant, c["qp"], *art, c["lens"],
                num_splits=s), iters, flush),
            "int8_decode_bound_ms": bound(2 * rows * hkv * (d + 4)
                                          + 2 * c["qp"].numel() * 2,
                                          4 * rows * hq * d,
                                          INT8_OPS_PER_S)[0],
            "prefill_ms": time_ms(functools.partial(
                flash_prefill, pq, pk, pv, causal=True), iters, flush),
            "prefill_sdpa_ms": time_ms(functools.partial(
                F.scaled_dot_product_attention,
                *(t.transpose(1, 2) for t in (pq, pk, pv)), is_causal=True,
                scale=1.0, enable_gqa=True), iters, flush),
            "prefill_bound_ms": bound(
                2 * (2 * pq.numel() + pk.numel() + pv.numel()),
                4 * hq * d * 512 * 513 / 2)[0]}
        max_err(flash_prefill(pq, pk, pv, causal=True),
                prefill_plain(pq, pk, pv, causal=True), PREFILL_TOL)
        print(f"shapes {name} (H_Q {hq} H_KV {hkv} D {d}): decode B2 view "
              f"1024 S{s} {res['decode_ms']:.6f} ms (SDPA "
              f"{res['decode_sdpa_ms']:.6f}, bound "
              f"{res['decode_bound_ms']:.6f}), int8 "
              f"{res['int8_decode_ms']:.6f} ms (bound "
              f"{res['int8_decode_bound_ms']:.6f}); prefill 512 "
              f"{res['prefill_ms']:.6f} ms (SDPA {res['prefill_sdpa_ms']:.6f},"
              f" bound {res['prefill_bound_ms']:.6f})")
        out[name] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase",
                    choices=("all", "kernels", "digests", "admission",
                             "times", "table1", "shapes"),
                    default="all",
                    help="'kernels' stops after build and kernel parity; "
                         "'digests' builds, then runs the main path's "
                         "parity cases alone and prints their output "
                         "digests; 'admission' builds, then times the "
                         "serving cell's admission steps alone; 'times' "
                         "builds, then times the decode op at the decode "
                         "shapes and the prefill kernel at the buckets; "
                         "'table1' builds, then runs the paper's Table 1; "
                         "'shapes' builds, then times the kernels at the "
                         "configs' head shapes the main path lacks")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    card, sms = phase_env_build()
    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
    if args.phase == "admission":
        cfg = get_arch("qwen2.5-3b")
        model = build_model(cfg, device=DEVICE)
        params = model.init_params(args.seed)
        print(json.dumps({"admission": phase_admission(model, params, cfg,
                                                       args.seed),
                          "card": card}))
        return 0
    if args.phase == "times":
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
        print(json.dumps({"times": phase_times(gen, sms, flush),
                          "card": card}))
        return 0
    if args.phase == "table1":
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
        table1, _ = phase_table1(gen, sms, card, flush)
        print(json.dumps({"table1": table1, "card": card}))
        return 0
    if args.phase == "shapes":
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
        print(json.dumps({"shapes": phase_shapes(gen, sms, flush),
                          "card": card}))
        return 0
    if args.phase == "digests":
        phase_parity(gen, sms)
        print("phase digests: done")
        return 0
    wide_gen = torch.Generator(device=DEVICE).manual_seed(args.seed + 17)
    errs = phase_parity(gen, sms, wide_gen)
    if args.phase == "kernels":
        print("phase kernels: done")
        return 0

    cfg = get_arch("qwen2.5-3b")
    model = build_model(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params = model.init_params(args.seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model {cfg.name}: {cfg.num_layers} layers d_model {cfg.d_model} "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads} head_dim "
          f"{cfg.resolved_head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size} "
          f"{cfg.param_dtype}: {n_params} params, init "
          f"{time.perf_counter() - t0:.1f} s")
    counts, serving, bf16 = phase_serving(model, params, cfg, args.seed)
    qcounts, qserving, _ = phase_serving(model, params, cfg, args.seed,
                                         kv_quant="int8", bf16=bf16)
    _, fserving, _ = phase_serving(model, params, cfg, args.seed,
                                   kv_quant="fp8", bf16=bf16)
    logits = phase_logits(model, params, cfg, args.seed, sms)
    for kv_dtype in ("int8", "fp8"):
        logits[kv_dtype] = phase_logits_quant(model, params, cfg, args.seed,
                                              sms, kv_dtype)
    # K1 and K3 launches from the bf16 run, K4's from the int8 run; K2
    # runs in neither
    counts["flash_decode_quant"] = qcounts["flash_decode_quant"]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    paper = phase_paper_cell(model, params, cfg, args.seed, flush, sms)
    qpaper = phase_paper_cell(model, params, cfg, args.seed, flush, sms,
                              kv_quant="int8")
    profile = phase_profile(model, params, cfg, args.seed)
    qprofile = phase_profile(model, params, cfg, args.seed, kv_quant="int8")
    del params, model
    torch.cuda.empty_cache()
    table1, table1_rows = phase_table1(gen, sms, card, flush)
    kernels = phase_kernels_line(gen, sms, errs, counts, flush,
                                 serving["prefill_launches"],
                                 serving["decode_launches"],
                                 qserving["decode_launches"], table1_rows)
    print(json.dumps({"serving": serving, "serving_int8": qserving,
                      "serving_fp8": fserving, "logits": logits,
                      "paper_cell": paper,
                      "paper_cell_int8": qpaper, "profile": profile,
                      "profile_int8": qprofile, "table1": table1,
                      "card": card}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA card", file=sys.stderr)
        sys.exit(2)
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
