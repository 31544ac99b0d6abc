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
    python3 chip_smoke.py --phase paged   # build + paged, prefix sharing,
                                          # DecodeEngine, the serving CLI
    python3 chip_smoke.py --phase spec    # build + speculative decoding
                                          # and the sampled path
    python3 chip_smoke.py --phase archs   # build + codeqwen1.5-7b and
                                          # stablelm-12b at full width
    python3 chip_smoke.py --phase tune    # build + measured split
                                          # autotuning, served from
                                          # its table
    python3 chip_smoke.py --phase obs     # build + tracing and metrics
                                          # on the serving cell, the CLI
    python3 chip_smoke.py --phase moe     # build + granite-moe-3b-a800m
                                          # and qwen3-moe-235b-a22b
                                          # (4 of 94 layers)

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
   windowed, a q_offset with a ragged Lq; bf16, the sharp data, f32); the
   prefill kernel at the suffix prefill's shapes (``SUFFIX_CASES``, with
   ``q_offset + Lq > Lk``), on random and on the sharp data.
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
4b. The slice's paths (``phase_paged_all``), each driven with the launch
   counts zeroed just before and read just after.  Paged against dense
   (``phase_paged``): the serving cell through a dense and a paged engine
   (page 64, dense-equivalent budget), two runs of each in turns after
   a warm-up, with a bf16, an int8 and an fp8 cache: the same streams,
   launches by kernel and by key, and splits, no policy evaluation,
   conservation; the paper cell and the serving decode shape profiled in
   each layout.  The prefix cell (``phase_prefix``, bf16 and int8): a
   1000-token system prompt opening six requests with 4-11-token tails,
   4 slots, shared and unshared arms on one engine each, warmed on
   another system prompt (every layer's prefill attention checked there
   against ``prefill_plain`` on the model's inputs, the suffix prefills
   at Lq 128 over a 1024-row view from ``q_offset`` 960); three timed
   runs of each arm in turns (1 full and 5 suffix prefills against 6
   full, ``PREFIX_PAGES``, prefix hits, conservation; follower TTFT and
   admission steps); the follower admission step alone, in turns, then
   under torch.profiler and cProfile.  ``DecodeEngine`` at full width
   (``phase_decode_engine``: loop admission, every layer's decode
   attention against ``decode_plain``).  The serving CLI
   (``phase_cli``: ``run_serving`` four ways, then the module as a
   subprocess twice, with ``--share-prefix`` and with ``--speculate ngram
   --temperature 0.8``, each of which must exit 0).
4c. Speculative decoding and the sampled path (``phase_spec``), on
   ``benchmarks/spec_ab.py``'s workload at full width (8 prompts, half
   repetitive, half random, 32 new tokens, 4 slots, k = 4): spec-off,
   ``ngram`` and the replay oracle (registered through
   ``register_drafter``, replaying the spec-off run), dense and paged
   (page 64), and ``ngram`` and the oracle under int8 (paged; the oracle
   always drafts, so verify runs over the dequantized view).  Each run
   zeroes the
   launch counts just before and reads them just after: the decode
   kernels' launches by (view, S) must be what the run's plan keys imply
   (36 per plain step, K4's under int8; 36 x (k + 1) of K1 per verify
   step of k drafts, at its ``("verify", k, bucket)`` plan), the prefill
   kernel 36 per admission, no policy evaluation, finite logits,
   conservation (paged); the dense ``ngram`` run holds every layer's
   verify attention of its first 4 verify steps against ``decode_plain``
   row by row at 2e-2; ``verify_vs_decode`` feeds 5 tokens as 5 decode
   steps and as one verify block from one cache and checks equal output
   bits wherever a layer-row's attention inputs are equal.  A sampled
   pass (temperature 0.8, top-k 50, top-p 0.9, request 0 greedy),
   spec-off and with the oracle's drafts, twice each: the same
   tokens, greedy rows equal to GreedySampler's bits, and spec-off,
   request 0's stream equal to the GreedySampler engine's.  Acceptance,
   tokens per verify step, where spec-on streams leave spec-off's, the
   median verify-step ms, the sampler's share of a verify step and one
   profiled verify step are printed, not checked.
4d. codeqwen1.5-7b (32 layers, MHA: G 1, D 128, QKV bias) and stablelm-12b
   (40 layers, G 4, D 160) at full width, bf16, seeded random weights,
   one at a time (``phase_archs``): the serving cell's prompts, 16 new
   tokens, 2 slots, with a bf16 cache and under int8, each twice: a run
   that holds every layer's prefill attention against ``prefill_plain``
   (3e-2) and decode attention against ``decode_plain`` /
   ``decode_quant_plain`` (2e-2) on the model's own inputs, then a timed
   run that must take the same path and give the same streams; decode
   launches 1 a layer a step, no policy evaluation, finite logits;
   admission-step and median decode-step ms, the parameter count and
   ``torch.cuda.max_memory_allocated`` printed.
4e. Measured split autotuning (``phase_tune``): ``Calibrator`` times the
   decode op (K1; K4 over int8) at every candidate split of every cell
   of ``H100_SPEC`` (CUDA events, L2 flushed and the stream spun before
   each repeat, 8 calls a repeat, each on its own cache copy; the median
   of 5 repeats after 2), every time above the method's floor; each
   ``TUNE_CELLS`` cell prints its curve, argmin, and ``paper``'s and
   ``fa3_baseline``'s splits with t(S) / t(argmin) (a policy's S off the
   candidate grid timed on the cell's inputs), and over the whole table
   how often ``paper``'s, ``fa3_baseline``'s and ``tpu_adaptive``'s
   splits are the argmin and t(S) / t(argmin); ``TUNE_STABILITY``
   calibrated again on other inputs prints how many argmins changed, and
   the committed table of this card (``experiments/tune/h100/``) is
   compared with the fresh one the same way; the
   serving cell (2 slots, the 4 prompts, bf16 then int8) under
   ``split_policy="measured"`` from the fresh table: 0 policy
   evaluations, each resident bucket's frozen split = ``table.choose``
   (1152, off the grid, the nearest bucket's), launches by (view, S) =
   the plan keys', every layer's decode attention within 2e-2 of its
   plain version, 0 fallbacks; then the serving CLI as a subprocess with
   ``--policy measured --tune-table experiments/tune/h100/
   --stats-path``.  The fresh table goes to ``chiprun_out/tune/``.
4f. Observability (``phase_obs``): the serving cell (32 new tokens) four
   times on fresh engines with ``trace_path`` / ``metrics_path`` off, on,
   off, on: the same greedy streams, launches by kernel and key,
   ``PlanCacheStats.to_json()`` and 0 policy evaluations in every run;
   each traced run's trace validates, holds one ``request`` span a
   request with its ``queue_wait`` and ``admit`` spans and
   ``first_token`` instant inside, and one launch span a prefill or
   decode launch (with the plan provenance keys); its metrics count 4
   TTFTs and one decode ``launch_ms`` a decode step.  The median decode
   step on and off is printed, not checked.  Then the CLI as a
   subprocess with ``--arch granite-moe-3b-a800m --trace t.json
   --metrics m.prom`` (exit 0, a valid trace, Prometheus text that
   parses).  Artifacts land in ``chiprun_out/obs/``.
4g. The MoE family (``phase_moe``, after 4d, through the same
   ``serve_configs`` as 4d): granite-moe-3b-a800m (32 layers, d_model
   1536, 24/8 heads: G 3, D 64, 40 experts top 8, d_expert 512) at full
   width and depth, 16 new tokens, bf16 and int8, every layer's prefill
   and decode attention checked as in 4d, decode launches by (view, S)
   equal to the plan keys', the timed runs with tracing and metrics on
   (their artifacts checked as in 4f); layer 0's gather dispatch against
   its einsum dispatch at a 1024-token prefill group and two 1-token
   decode groups, within 2e-2, each timed beside the time to read every
   expert's weights; then qwen3-moe-235b-a22b (64/4 heads: G 16, D 128,
   128 experts top 8, d_expert 1536) at full width with its depth cut
   from 94 to 4 layers (470 GB in bf16 do not fit one card), 8 new
   tokens, bf16 and int8.  Peak memory and the median decode step are
   printed.
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
   counted at that dtype and length, and one at the suffix prefill's
   shape (Lq 128, Lk 1024, ``q_offset`` 960, with the first timed shared
   bf16 run of the prefix cell's launches); both decode kernels a row
   at Table 1's two changed cells under ``paper`` (bf16, and int8), with
   the launches of phase 4's Table 1 run; the decode kernel at one
   verify row of the spec cell (B=4, view 128, the verify plan), with
   the dense ``ngram`` run's verify-row launches; and per config of
   phases 4d and 4g the decode kernel (bf16, and int8) at B=2 view 1024
   and the prefill kernel at 1024, with that config's launches there.  Every
   phase prints its wall seconds.

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
import cProfile
import functools
import gc
import hashlib
import json
import os
import pstats
import re
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
from repro_torch.core.split_policy import (  # noqa: E402
    DecodeWorkload,
    choose_num_splits,
)
from repro_torch.tune import (  # noqa: E402
    H100_SPEC,
    H100_TABLE_DIR,
    Calibrator,
    SplitTable,
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
# the prefill kernel as prefix sharing's suffix prefill runs it: a padded
# suffix of 128 rows over a slot's view from q_offset = the shared rows;
# at Lk 1024 the last query rows lie past the view's end (q_offset + Lq >
# Lk) and attend every key (tests/test_torch_gpu.py has the same list)
SUFFIX_CASES = [(1, 128, 512, 16, 2, 128, None, 448, True),
                (1, 128, 1024, 16, 2, 128, None, 960, True),
                (1, 128, 1024, 16, 2, 128, None, 1000, True)]


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
             (1.0, 1.0, 1.0)),
            (wide_gen, SUFFIX_CASES, torch.bfloat16, (1.0, 1.0, 1.0)),
            (wide_gen, SUFFIX_CASES, torch.bfloat16, SHARP_MUL)]
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

    def sample(self, logits, *args):
        self.finite &= torch.isfinite(logits).all()
        top = torch.topk(logits, 2, dim=-1).values
        self.margins.append(top[:, 0] - top[:, 1])
        return super().sample(logits, *args)

    def verify(self, logits, *args):
        self.finite &= torch.isfinite(logits).all()
        return super().verify(logits, *args)


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
    layout = model.cache_manager(len(lens), 2048, kv_dtype).layout
    caches = layout.init_storage()
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
            logits, rows = model.prefill_slot_view(params, padded, n,
                                                   kv_dtype=kv_dtype)
            layout.write_slot(caches, rows, None, slot, 0)
            first.append(logits.argmax())
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
                  kv_quant=None, layout: str = "dense", lens=(420,)):
    """Where a decode step's time goes: torch.profiler over ``steps``
    decode steps of prompts of ``lens`` tokens, one slot each (the paper
    cell by default: B=1, 512 bucket, ``paper``), with a bf16 cache or
    under ``kv_quant``, in the cache ``layout``.  Reports the step's
    wall ms, the device's busy ms (sum of kernel durations), the idle
    share, the kernels launched per step, and the kernels with the most
    device time."""
    label = (kv_quant or "bf16") + (" paged" if layout == "paged" else "")
    rng = np.random.default_rng(seed + 1)
    engine = ServingEngine(model, ServeConfig(model=cfg, kv_quant=kv_quant,
                                              cache_layout=layout),
                           max_len=2048, batch_slots=len(lens),
                           policy="paper", device=DEVICE)
    engine.load(params)
    for i, n in enumerate(lens):
        engine.submit(Request(i, rng.integers(0, cfg.vocab_size, n).tolist(),
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
    bucket = max(engine.planned_splits())
    print(f"profile {label} decode step B{len(lens)} bucket{bucket} paper: "
          f"wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{out['idle_share']:.3f}, {launches / steps:.1f} device ops per "
          f"step (profiler on)")
    for name, ms in out["top_kernels_ms_per_step"].items():
        print(f"  {ms:.4f} ms/step  {name}")
    engine.drain()
    return out


# ---------------------------------------------------------------------------
# the paged cache, prefix sharing, DecodeEngine and the serving CLI
# ---------------------------------------------------------------------------

# the paged-against-dense runs of the serving cell, in turns (two of each:
# the run grew two phases, and this is the deepest earlier path)
PAGED_ORDER = ("dense", "paged") * 2
# the prefix cell: a 1000-token system prompt (15 full pages of 64 and 40
# rows) opening PREFIX_REQUESTS requests with unique tails of 4-11 tokens,
# PREFIX_NEW new tokens each through PREFIX_SLOTS slots, page 64, a
# dense-equivalent page budget.  tests/test_torch_prefix.py draws the same
# prompts and pins PREFIX_PAGES (pages allocated, shared and unshared)
# against the reference's cache manager.
PREFIX_SYSTEM, PREFIX_REQUESTS, PREFIX_SLOTS, PREFIX_NEW = 1000, 6, 4, 16
PREFIX_PAGES = {True: 23, False: 98}
PREFIX_RUNS = 3           # timed runs of each arm, in turns
FOLLOWER_ROUNDS = 10      # timed follower admission steps of each arm


def prefix_prompts(vocab: int, seed: int = 0):
    """The prefix cell's prompts and its warm-up's: another system prompt
    of the same length before the same tails, so the warm-up takes every
    plan the timed runs take, suffix prefills included."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, PREFIX_SYSTEM).tolist()
    warm = rng.integers(0, vocab, PREFIX_SYSTEM).tolist()
    tails = [rng.integers(0, vocab, int(n)).tolist()
             for n in rng.integers(4, 12, PREFIX_REQUESTS)]
    return [system + t for t in tails], [warm + t for t in tails]


def serve_once(model, params, cfg, requests, *, max_len: int = 2048,
               slots: int = 2, **scfg_kw):
    """One engine run of ``requests`` under ``paper``, the launch counts
    zeroed just before it and read just after; a paged cache is checked
    for conservation after the drain.  Returns the run's streams, finish
    reasons, launch counts (by kernel, and by key for each kernel), frozen
    splits, policy evaluations, step timings and cache summary."""
    sampler = CheckedGreedy()
    engine = ServingEngine(model, ServeConfig(model=cfg, **scfg_kw),
                           max_len=max_len, batch_slots=slots,
                           policy="paper", sampler=sampler, device=DEVICE)
    engine.load(params)
    ops.reset_launch_counts()
    ops.reset_policy_eval_count()
    ttft, decode_ms, wall, done, _, admits = drive(engine, requests)
    torch.cuda.synchronize()
    run = {"streams": [c.tokens for c in done],
           "reasons": [c.finish_reason for c in done],
           "counts": ops.launch_counts(),
           "by_key": {name: ops.launch_counts_by_key(name)
                      for name in build.KERNELS},
           "splits": engine.planned_splits(),
           "evals": ops.policy_eval_count(),
           "ttft_ms": ttft, "decode_ms": decode_ms, "admits": admits,
           "cache": engine.cache_stats()}
    check(bool(sampler.finite.item()), "non-finite logits")
    if engine.cache.is_paged:
        engine.cache.check_conservation()
    return run


def same_path(a, b, label):
    """Two runs of one workload took the same path: streams, finish
    reasons, launches by kernel and by key, frozen splits; no policy
    evaluation in either."""
    for key in ("streams", "reasons", "counts", "by_key", "splits"):
        check(a[key] == b[key], f"{label}: {key} differ: {a[key]} / "
              f"{b[key]}")
    check(a["evals"] == b["evals"] == 0, f"{label}: policy evaluated")


def phase_paged(model, params, cfg, seed: int):
    """Paged against dense at full width: the serving cell's 4 requests
    (32 new tokens each, 2 slots) through a dense and a paged engine (page
    64, dense-equivalent budget) after one dense warm-up run, two runs
    of each layout in turns, with a bf16, an int8 and an fp8 cache; the
    launch counts zeroed just before each run and read just after.  Every
    run takes the warm-up's path: the same streams, launches by kernel and
    by (view, S) and (dtype, Lq), frozen splits, no policy evaluation;
    conservation.  Then a profiler window of 8 decode steps of the paper
    cell (B=1, bucket 512) and of the serving cell's decode shape (B=2,
    bucket 1024) in each layout."""
    out = {}
    rng = np.random.default_rng(seed)
    serving = [Request(i, rng.integers(0, cfg.vocab_size, n).tolist(),
                       max_new_tokens=32)
               for i, n in enumerate(SERVING_PROMPTS)]
    for kv_quant in (None, "int8", "fp8"):
        label = kv_quant or "bf16"
        first = serve_once(model, params, cfg, serving, kv_quant=kv_quant)
        runs = {"dense": [], "paged": []}
        for layout in PAGED_ORDER:
            runs[layout].append(serve_once(
                model, params, cfg, serving, kv_quant=kv_quant,
                cache_layout=layout))
        for run in runs["dense"] + runs["paged"]:
            same_path(first, run, f"paged {label} serving")
        res = {layout: {
            "decode_step_ms": median([m for r in rs for m in r["decode_ms"]]),
            "per_run_ms": [median(r["decode_ms"]) for r in rs]}
            for layout, rs in runs.items()}
        paged = runs["paged"][0]
        decode = "flash_decode_quant" if kv_quant else "flash_decode"
        res["launches"] = paged["counts"]
        res["decode_launches"] = {f"{v} S{s}": n for (v, s), n in sorted(
            paged["by_key"][decode].items())}
        res["cache"] = paged["cache"]
        per_run = {layout: [round(x, 3) for x in res[layout]["per_run_ms"]]
                   for layout in runs}
        print(f"paged {label} serving: streams, launches by key and splits "
              f"{paged['splits']} equal dense's in all {len(PAGED_ORDER) + 1} "
              f"runs; median decode "
              f"step ms dense {res['dense']['decode_step_ms']:.3f} (runs "
              f"{per_run['dense']}) paged "
              f"{res['paged']['decode_step_ms']:.3f} (runs "
              f"{per_run['paged']}); launches {json.dumps(paged['counts'])}; "
              f"decode launches by (view, S) {res['decode_launches']}; cache "
              f"{json.dumps(paged['cache'])}")
        out[f"serving_{label}"] = res
    for name, lens in (("paper", (420,)), ("serving", (1000, 450))):
        for layout in ("dense", "paged"):
            out[f"profile_{name}_{layout}"] = phase_profile(
                model, params, cfg, seed, layout=layout, lens=lens)
    return out


def prefix_run(engine, prompts, label: str, share: bool, layers: int):
    """One timed run of the prefix cell on a warmed engine, the launch
    counts zeroed just before it and read just after; then the trie is
    emptied (``reset_prefix``), so every run's leader prefills in full.
    Checks the structure: 1 full and 5 suffix prefills shared (6 full
    unshared), the prefill kernel at (dtype, Lq) accordingly, the pages
    allocated, the prefix hits, conservation, no policy evaluation."""
    base = dict(engine.stats.launches)
    cache = engine.cache
    before = (cache.pages_allocated_total, cache.prefix_hits,
              cache.prefix_shared_rows)
    ops.reset_launch_counts()
    ops.reset_policy_eval_count()
    ttft, decode_ms, wall, done, _, admits = drive(
        engine, [Request(i, p, max_new_tokens=PREFIX_NEW)
                 for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    kinds, steps = {}, 0
    for key, n in engine.stats.launches.items():
        n -= base.get(key, 0)
        if isinstance(key, tuple) and n:
            kinds[key[0]] = kinds.get(key[0], 0) + n
        elif isinstance(key, int):
            steps += n
    pages, hits, rows = (a - b for a, b in zip(
        (cache.pages_allocated_total, cache.prefix_hits,
         cache.prefix_shared_rows), before))
    counts = ops.launch_counts()
    by_key = ops.launch_counts_by_key("flash_prefill")
    decode = ("flash_decode_quant" if engine.kv_dtype in QUANT_DTYPES
              else "flash_decode")
    dt = "bfloat16"
    n = PREFIX_REQUESTS
    want = ({"prefill": 1, "sprefill": n - 1}, {(dt, 1024): layers,
                                                 (dt, 128): (n - 1) * layers},
            n - 1, (n - 1) * (PREFIX_SYSTEM // 64) * 64) if share else (
        {"prefill": n}, {(dt, 1024): n * layers}, 0, 0)
    check((kinds, by_key, hits, rows) == want,
          f"prefix {label}: admissions {kinds}, prefill launches {by_key}, "
          f"hits {hits}, shared rows {rows}; want {want}")
    check(pages == PREFIX_PAGES[share],
          f"prefix {label}: {pages} pages allocated, want "
          f"{PREFIX_PAGES[share]}")
    check(counts[decode] == layers * steps and counts["flash_combine"] == 0,
          f"prefix {label}: launches {counts} over {steps} decode steps")
    check(ops.policy_eval_count() == 0, f"prefix {label}: policy evaluated")
    check([c.finish_reason for c in done] == ["length"] * n
          and all(len(c.tokens) == PREFIX_NEW for c in done),
          f"prefix {label}: completions")
    cache.check_conservation()
    cache.reset_prefix()
    cache.check_conservation()
    check(cache.free_pages == cache.spec.total_pages,
          f"prefix {label}: pages held after the trie was emptied")
    return {"streams": [c.tokens for c in done], "ttft_ms": ttft,
            "admit_ms": [ms for _, ms in admits], "decode_ms": decode_ms,
            "pages": pages, "prefill_by_key": by_key}


def follower_step(engine, leader, followers, ctx=contextlib.nullcontext):
    """The follower admission step alone: ``leader`` served by itself
    (one new token: admitted, prefilled, its full pages registered when
    the arm shares, finished), then one step, inside ``ctx()``, that
    admits ``followers`` (suffix prefills over the adopted pages when the
    arm shares, full prefills when not) and decodes them once.  Returns
    that step's wall ms and what ``ctx()`` yielded; the engine ends empty,
    its trie emptied."""
    drive(engine, [leader])
    for r in followers:
        engine.submit(r)
    torch.cuda.synchronize()
    with ctx() as handle:
        t0 = time.perf_counter()
        engine.step()             # ends in a host copy of the tokens
        ms = (time.perf_counter() - t0) * 1e3
    engine.drain()
    engine.cache.reset_prefix()
    engine.cache.check_conservation()
    return ms, handle


def host_profile(prof, rows: int = 10):
    """The profiler's host-side operations with the most self time:
    (name, self ms, calls), and the kernel launches the host issued."""
    ka = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    launches = sum(e.count for e in ka
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    return [(e.key, e.self_cpu_time_total / 1e3, e.count)
            for e in ka[:rows]], launches


@contextlib.contextmanager
def python_profiled():
    """cProfile over the block; yields the profiler."""
    prof = cProfile.Profile()
    prof.enable()
    try:
        yield prof
    finally:
        prof.disable()


def python_top(prof, rows: int = 12):
    """The Python functions with the most self time in a cProfile run,
    as (function, self ms, cumulative ms, calls)."""
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:rows]
    return [(f"{Path(f).name}:{line}({func})", tt * 1e3, ct * 1e3, nc)
            for (f, line, func), (_, nc, tt, ct, _) in top]


def pct(xs, q: float) -> float:
    """The ``q`` quantile of ``xs`` by nearest rank."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def phase_prefix(model, params, cfg, seed: int, kv_quant=None):
    """Prefix sharing at full width, a shared and an unshared arm, one
    engine each (4 slots, page 64, max_len 2048), on the prefix cell.

    1. Warm-up on each engine: the warm-up prompts (another system
       prompt), every plan the timed runs take, each layer's prefill
       attention held against ``prefill_plain`` on the model's own inputs
       at PREFILL_TOL (the shared arm's suffix prefills at Lq 128 over a
       1024-row view from ``q_offset`` 960, past the view's end).
    2. PREFIX_RUNS timed runs of each arm in turns (``prefix_run``):
       follower TTFT and admission-step ms; each arm's runs give the same
       streams.
    3. The follower admission step alone (``follower_step``), its two last
       requests after the leader, FOLLOWER_ROUNDS rounds of each arm in
       turns after one untimed round; then that step once in each arm
       under torch.profiler (wall, device busy, device operations, kernel
       launches, the host operations with the most self time) and once
       under cProfile (the Python functions with the most self time).
    """
    label = kv_quant or "bf16"
    layers = cfg.num_layers
    prompts, warm = prefix_prompts(cfg.vocab_size, seed)
    engines, checks = {}, {}
    for share in (True, False):
        c = checks[share] = {"max_abs_err": 0.0, "full": 0, "suffix": 0,
                             "suffix_shapes": []}

        def checked(q, k, v, c=c, **kw):
            got = flash_prefill(q, k, v, **kw)
            c["max_abs_err"] = max(c["max_abs_err"], max_err(
                got, prefill_plain(q, k, v, **kw), PREFILL_TOL))
            if kw.get("q_offset"):
                c["suffix"] += 1
                shape = (q.shape[1], k.shape[1], kw["q_offset"])
                if shape not in c["suffix_shapes"]:
                    c["suffix_shapes"].append(shape)
            else:
                c["full"] += 1
            return got

        engine = ServingEngine(
            model, ServeConfig(model=cfg, kv_quant=kv_quant,
                               cache_layout="paged", share_prefix=share),
            max_len=2048, batch_slots=PREFIX_SLOTS, policy="paper",
            sampler=CheckedGreedy(), device=DEVICE)
        engine.load(params)
        with ops_route("flash_prefill", checked):
            drive(engine, [Request(i, p, max_new_tokens=PREFIX_NEW)
                           for i, p in enumerate(warm)])
        engine.cache.reset_prefix()
        engine.cache.check_conservation()
        engines[share] = engine
    n = PREFIX_REQUESTS
    check(checks[True]["full"] == layers
          and checks[True]["suffix"] == (n - 1) * layers
          and checks[False]["full"] == n * layers
          and checks[False]["suffix"] == 0,
          f"prefix {label}: prefill attention checks {checks}")

    runs = {True: [], False: []}
    for _ in range(PREFIX_RUNS):
        for share in (True, False):
            runs[share].append(prefix_run(engines[share], prompts,
                                          f"{label} share={share}", share,
                                          layers))
    for share, rs in runs.items():
        check(all(r["streams"] == rs[0]["streams"] for r in rs),
              f"prefix {label} share={share}: streams differ across runs")
        check(bool(engines[share].sampler.finite.item()),
              f"prefix {label}: non-finite logits")
    parted = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                   None) for a, b in zip(runs[True][0]["streams"],
                                         runs[False][0]["streams"])]

    def by_position(rs, key):
        return [median([r[key][j] for r in rs])
                for j in range(len(rs[0][key]))]

    ttft = {s: by_position(rs, "ttft_ms") for s, rs in runs.items()}
    admit = {s: by_position(rs, "admit_ms") for s, rs in runs.items()}
    step = {s: median([m for r in rs for m in r["decode_ms"]])
            for s, rs in runs.items()}

    leader = Request(0, prompts[0], max_new_tokens=1)
    followers = [Request(i, prompts[i], max_new_tokens=2)
                 for i in range(n - 2, n)]
    alone = {True: [], False: []}
    for r in range(FOLLOWER_ROUNDS + 1):
        for share in (True, False):
            ms, _ = follower_step(engines[share], leader, followers)
            if r:
                alone[share].append(ms)
    prof_out = {}
    for share in (True, False):
        engine = engines[share]
        _, (prof, wall) = follower_step(engine, leader, followers, profiled)
        kernels, dev_ops = device_kernels(prof)
        busy = sum(kernels.values())
        host, launches = host_profile(prof)
        _, py = follower_step(engine, leader, followers, python_profiled)
        prof_out[share] = {
            "wall_ms": wall[0], "device_busy_ms": busy,
            "device_ops": dev_ops, "host_launches": launches,
            "host_ops": host,
            "top_kernels": sorted(kernels.items(), key=lambda kv: -kv[1])[:5],
            "python": python_top(py)}
    for share in (True, False):
        engines[share].cache.check_conservation()

    arm = {True: "shared", False: "unshared"}
    print(f"prefix {label}: {n} requests, a {PREFIX_SYSTEM}-token system "
          f"prompt, {PREFIX_SLOTS} slots, page 64; shared 1 full + "
          f"{n - 1} suffix prefills, unshared {n} full, in each of "
          f"{PREFIX_RUNS} runs an arm; pages allocated shared "
          f"{runs[True][0]['pages']} unshared {runs[False][0]['pages']}; "
          f"prefill attention of {checks[True]['full']} full and "
          f"{checks[True]['suffix']} suffix layer launches (Lq, Lk, "
          f"q_offset {checks[True]['suffix_shapes']}) and "
          f"{checks[False]['full']} unshared against prefill_plain on the "
          f"model's inputs: max abs err "
          f"{max(c['max_abs_err'] for c in checks.values()):.4g}; streams "
          f"shared vs unshared part at tokens {parted}")
    for share in (True, False):
        print(f"prefix {label} {arm[share]}: TTFT ms by request (median of "
              f"{PREFIX_RUNS} runs) {[round(x, 3) for x in ttft[share]]}, "
              f"followers' median {median(ttft[share][1:]):.3f}; admission "
              f"steps ms {[round(x, 3) for x in admit[share]]}; median "
              f"decode step {step[share]:.3f} ms; follower admission step "
              f"alone (2 followers + 1 decode step) ms median "
              f"{median(alone[share]):.3f}, p10-p90 "
              f"{pct(alone[share], 0.1):.3f}-{pct(alone[share], 0.9):.3f} "
              f"over {FOLLOWER_ROUNDS} rounds")
        p = prof_out[share]
        print(f"prefix {label} {arm[share]} follower admission step, "
              f"profiler on: wall {p['wall_ms']:.3f} ms, device busy "
              f"{p['device_busy_ms']:.3f} ms, idle share "
              f"{1 - p['device_busy_ms'] / p['wall_ms']:.3f}, "
              f"{p['device_ops']} device operations, "
              f"{p['host_launches']} kernel launches by the host")
        for name, ms, calls in p["host_ops"]:
            print(f"  host {ms:9.3f} ms self  {calls:6d} calls  {name[:70]}")
        for name, ms in p["top_kernels"]:
            print(f"  device {ms:9.4f} ms  {name[:80]}")
        for name, tt, ct, calls in p["python"]:
            print(f"  python {tt:9.3f} ms self {ct:9.3f} ms cum {calls:6d} "
                  f"calls  {name[:70]}")
    return {"pages_allocated": {arm[s]: runs[s][0]["pages"] for s in runs},
            "prefill_attention": {arm[s]: checks[s] for s in checks},
            "streams_part_at": parted,
            "ttft_ms": {arm[s]: ttft[s] for s in ttft},
            "follower_ttft_median_ms": {arm[s]: median(ttft[s][1:])
                                        for s in ttft},
            "admission_step_ms": {arm[s]: admit[s] for s in admit},
            "decode_step_ms": {arm[s]: step[s] for s in step},
            "follower_step_ms": {arm[s]: alone[s] for s in alone},
            "follower_step_profile": {arm[s]: prof_out[s] for s in prof_out},
            "prefill_launches": {f"{dt} {lq}": k for (dt, lq), k in
                                 runs[True][0]["prefill_by_key"].items()}}


def phase_decode_engine(model, params, cfg, seed: int):
    """DecodeEngine at full width: two greedy requests (prompts of 24 and
    40 tokens, 8 new tokens each) through 2 slots by loop admission, the
    launch counts zeroed just before and read just after; every layer's
    decode attention held against ``decode_plain`` on the model's own
    inputs at DECODE_TOL.  The decode kernel runs once a layer a step and
    the prefill kernel never; no policy evaluation.  Then one unchecked
    run of the same requests: the same streams, and its wall time."""
    # imported here, so that a copy of this script runs an older
    # checkout's ``--phase admission``, ``times`` and ``digests``
    from repro_torch.serving import DecodeEngine
    rng = np.random.default_rng(seed + 2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (24, 40)]
    engine = DecodeEngine(model, ServeConfig(model=cfg), max_len=2048,
                          batch_slots=2, policy="paper", device=DEVICE)
    engine.load(params)
    attn = {"max_abs_err": 0.0, "launches": 0}

    def checked(q, k, v, kv_len, *, num_splits, out_dtype):
        got = fdec.flash_decode(q, k, v, kv_len, num_splits=num_splits,
                                out_dtype=out_dtype)
        attn["max_abs_err"] = max(attn["max_abs_err"], max_err(
            got, fdec.decode_plain(q, k, v, kv_len, num_splits=num_splits,
                                   out_dtype=out_dtype), DECODE_TOL))
        attn["launches"] += 1
        return got

    def requests():
        return [Request(i, p, max_new_tokens=8)
                for i, p in enumerate(prompts)]

    ops.reset_launch_counts()
    ops.reset_policy_eval_count()
    with ops_route("flash_decode", checked):
        done = engine.generate(requests())
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    steps = sum(v for k, v in engine.stats.launches.items()
                if isinstance(k, int))
    layers = cfg.num_layers
    check(steps == 40 - 1 + 8 and counts["flash_decode"] == attn["launches"]
          == layers * steps and counts["flash_prefill"] == 0
          and ops.policy_eval_count() == 0,
          f"DecodeEngine: {counts} over {steps} steps, {attn}")
    check([len(c.tokens) for c in done] == [8, 8]
          and all(c.finish_reason == "length" for c in done),
          "DecodeEngine: completions")
    t0 = time.perf_counter()
    again = engine.generate(requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check([c.tokens for c in again] == [c.tokens for c in done],
          "DecodeEngine: streams differ between two runs")
    print(f"DecodeEngine: 2 requests (24 and 40 prompt tokens, 8 new) by "
          f"loop admission, {steps} decode steps, launches "
          f"{json.dumps(counts)}, splits {engine.planned_splits()}; decode "
          f"attention of {attn['launches']} layer steps against "
          f"decode_plain on the model's inputs: max abs err "
          f"{attn['max_abs_err']:.4g}; unchecked run {wall:.3f} s "
          f"({wall / steps * 1e3:.3f} ms a step)")
    return {"steps": steps, "launches": counts, "decode_attention": attn,
            "wall_s": wall, "splits": engine.planned_splits()}


def phase_cli():
    """The serving CLI: ``run_serving`` (the reduced qwen2.5-3b at d_model
    512, 2 layers) dense, paged, paged with prefix sharing and paged
    under int8, no policy evaluation, the paged-cache and prefix-sharing
    lines printed; then ``python -m repro_torch.launch.serve
    --cache-layout paged --share-prefix`` and ``... --speculate ngram
    --temperature 0.8`` as subprocesses, which must exit 0 (the second
    printing the speculation line)."""
    from repro_torch.launch.serve import run_serving
    cli = {}
    for kw in (dict(), dict(cache_layout="paged"),
               dict(cache_layout="paged", share_prefix=True),
               dict(cache_layout="paged", kv_quant="int8")):
        name = "+".join(f"{k}={v}" for k, v in kw.items()) or "dense"
        lines = []
        ops.reset_launch_counts()
        ops.reset_policy_eval_count()
        outs = run_serving("qwen2.5-3b", log_fn=lines.append, **kw)
        counts = ops.launch_counts()
        decode = "flash_decode_quant" if kw.get("kv_quant") else \
            "flash_decode"
        check(ops.policy_eval_count() == 0, f"cli {name}: policy evaluated")
        check(counts[decode] > 0 and counts["flash_prefill"] > 0,
              f"cli {name}: launches {counts}")
        check(len(outs) == 8 and all(len(c.tokens) == 16 for c in outs),
              f"cli {name}: completions")
        want = ["paged cache:"] if kw else []
        if kw.get("share_prefix"):
            want.append("prefix sharing:")
        for head in want:
            check(any(x.startswith(head) for x in lines),
                  f"cli {name}: no {head!r} line")
        summary = [x for x in lines if not x.startswith("req ")]
        print(f"cli {name}: launches {json.dumps(counts)} | "
              + " | ".join(summary))
        cli[name] = summary
    env = dict(os.environ, PYTHONPATH=str(SRC))
    module = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
              "qwen2.5-3b"]
    for flags, key in ((["--cache-layout", "paged", "--share-prefix"],
                        "subprocess_rc"),
                       (["--speculate", "ngram", "--temperature", "0.8"],
                        "subprocess_speculate_sampled_rc")):
        cmd = module + flags
        res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        print(f"cli subprocess {' '.join(cmd[1:])}: exit {res.returncode}; "
              + " | ".join(res.stdout.strip().splitlines()[-4:]))
        check(res.returncode == 0,
              f"cli subprocess failed: {res.stderr[-2000:]}")
        if "--speculate" in flags:
            check("speculation (ngram, k=4): " in res.stdout,
                  "cli subprocess: no speculation line")
        cli[key] = res.returncode
    return cli


# ---------------------------------------------------------------------------
# the two dense configs still missing, at full width
# ---------------------------------------------------------------------------

# codeqwen1.5-7b (MHA: G = 1, D 128, QKV bias) and stablelm-12b (G = 4,
# D 160): the serving cell's prompts, 16 new tokens each, 2 slots
ARCHS = ("codeqwen1.5-7b", "stablelm-12b")
ARCH_NEW = 16


@contextlib.contextmanager
def checked_kernels(acc):
    """Within the block, every prefill-kernel launch and every decode-
    kernel launch (bf16 or quantized cache) is held against its plain
    version on the same inputs: prefill at PREFILL_TOL, decode at
    DECODE_TOL and QUANT_TOL.  ``acc`` gathers the largest errors and the
    number of checks by kernel name.  Each wrapper launches its kernel
    once, so the launch counts are the unchecked path's."""
    for name in ("flash_prefill", "flash_decode", "flash_decode_quant"):
        acc.setdefault(name, {"max_abs_err": 0.0, "checks": 0})

    def note(name, got, want, tol):
        acc[name]["max_abs_err"] = max(acc[name]["max_abs_err"],
                                       max_err(got, want, tol))
        acc[name]["checks"] += 1
        return got

    def prefill(q, k, v, **kw):
        return note("flash_prefill", flash_prefill(q, k, v, **kw),
                    prefill_plain(q, k, v, **kw), PREFILL_TOL)

    def decode(q, k, v, kv_len, *, num_splits, out_dtype):
        kw = dict(num_splits=num_splits, out_dtype=out_dtype)
        return note("flash_decode", fdec.flash_decode(q, k, v, kv_len, **kw),
                    fdec.decode_plain(q, k, v, kv_len, **kw), DECODE_TOL)

    def decode_quant(q, k, v, k_scale, v_scale, kv_len, *, num_splits,
                     out_dtype):
        args = (q, k, v, k_scale, v_scale, kv_len)
        kw = dict(num_splits=num_splits, out_dtype=out_dtype)
        return note("flash_decode_quant", fdq.flash_decode_quant(*args, **kw),
                    fdq.decode_quant_plain(*args, **kw), QUANT_TOL)

    with ops_route("flash_prefill", prefill), \
            ops_route("flash_decode", decode), \
            ops_route("flash_decode_quant", decode_quant):
        yield acc


def arch_run(model, params, cfg, prompts, kv_quant=None, new=ARCH_NEW,
             phase="archs", trace=False):
    """One config's serving cell: the requests (``new`` tokens each)
    through 2 slots with a bf16 cache or under ``kv_quant``, twice on
    fresh engines, the launch counts zeroed just before each run and read
    just after.  The first run holds every layer's prefill attention
    against ``prefill_plain`` and every layer's decode attention against
    ``decode_plain`` (int8: ``decode_quant_plain``) on the model's own
    inputs; the second, which is timed, must take the same path and give
    the same streams.  In both the decode launches by (view, S) must be
    what the run's plan keys imply.  With ``trace`` the timed run writes
    the trace and metrics artifacts (``ServeConfig.trace_path`` /
    ``metrics_path``, under ``chiprun_out/obs/``), which must pass
    ``check_obs_artifacts``."""
    label = f"{phase} {cfg.name} {kv_quant or 'bf16'}"
    layers = cfg.num_layers
    decode = "flash_decode_quant" if kv_quant else "flash_decode"
    runs, acc = [], {}
    paths = {}
    if trace:
        OBS_DIR.mkdir(parents=True, exist_ok=True)
        stem = OBS_DIR / f"{cfg.name}_{kv_quant or 'bf16'}"
        paths = dict(trace_path=f"{stem}_trace.json",
                     metrics_path=f"{stem}_metrics.json")
    for checked in (True, False):
        sampler = CheckedGreedy()
        engine = ServingEngine(model, ServeConfig(
            model=cfg, kv_quant=kv_quant, **({} if checked else paths)),
            max_len=2048, batch_slots=2, policy="paper", sampler=sampler,
            device=DEVICE)
        engine.load(params)
        reqs = [Request(i, p, max_new_tokens=new)
                for i, p in enumerate(prompts)]
        ops.reset_launch_counts()
        ops.reset_policy_eval_count()
        with checked_kernels(acc) if checked else contextlib.nullcontext():
            ttft, decode_ms, wall, done, _, admits = drive(engine, reqs)
        torch.cuda.synchronize()
        st = engine.stats
        run = {"streams": [c.tokens for c in done],
               "counts": ops.launch_counts(),
               "by_key": {name: ops.launch_counts_by_key(name)
                          for name in ("flash_decode", "flash_decode_quant",
                                       "flash_prefill")},
               "steps": sum(v for k, v in st.launches.items()
                            if isinstance(k, int)),
               "admissions": sum(v for k, v in st.launches.items()
                                 if isinstance(k, tuple)),
               "evals": ops.policy_eval_count(), "splits":
               engine.planned_splits(), "decode_ms": decode_ms,
               "admits": admits, "stats": st.to_json()}
        counts = run["counts"]
        check(bool(sampler.finite.item()), f"{label}: non-finite logits")
        check(counts[decode] == layers * run["steps"],
              f"{label}: {counts[decode]} {decode} launches over "
              f"{run['steps']} decode steps")
        want = expected_decode_launches(engine, layers, kv_quant)[decode]
        check(run["by_key"][decode] == want, f"{label}: {decode} launches "
              f"by (view, S) {run['by_key'][decode]}, plan keys imply "
              f"{want}")
        check(counts["flash_prefill"] == layers * run["admissions"]
              == layers * len(prompts), f"{label}: prefill launches")
        other = "flash_decode" if kv_quant else "flash_decode_quant"
        check(counts[other] == 0 and counts["flash_combine"] == 0,
              f"{label}: launches {counts}")
        check(run["evals"] == 0, f"{label}: policy evaluated")
        check(st.misses == st.distinct_buckets, f"{label}: plan misses != "
              f"buckets")
        check([len(c.tokens) for c in done] == [new] * len(prompts)
              and all(c.finish_reason == "length" for c in done),
              f"{label}: completions")
        runs.append(run)
    first, timed_run = runs
    counts = first["counts"]
    check(acc[decode]["checks"] == counts[decode]
          and acc["flash_prefill"]["checks"] == counts["flash_prefill"],
          f"{label}: {acc} checks against {first['counts']}")
    for key in ("streams", "counts", "by_key", "splits", "stats"):
        check(first[key] == timed_run[key], f"{label}: the checked and the "
              f"timed run differ in {key}")
    obs = (check_obs_artifacts(f"{label} traced", paths["trace_path"],
                               paths["metrics_path"], timed_run)
           if trace else None)
    if obs is not None:
        print(f"{label}: the timed run traced (trace and metrics on): "
              f"{obs['events']} trace events, {obs['request_spans']} "
              f"request spans, {obs['launch_spans']} launch spans, ttft_ms "
              f"p50 {obs['ttft_ms']['p50']} ms, decode launch_ms p50 "
              f"{obs['launch_ms_decode']['p50']} ms")
    step_ms = median(timed_run["decode_ms"])
    by_view = {f"{v} S{s}": n for (v, s), n in sorted(
        first["by_key"][decode].items())}
    print(f"{label}: {first['admissions']} admissions, "
          f"{first['steps']} decode steps, launches "
          f"{json.dumps(first['counts'])}, splits {first['splits']}, 0 "
          f"policy evaluations; prefill attention of "
          f"{acc['flash_prefill']['checks']} layer prompts against "
          f"prefill_plain: max abs err "
          f"{acc['flash_prefill']['max_abs_err']:.4g}; decode attention of "
          f"{acc[decode]['checks']} layer steps against "
          f"{'decode_quant_plain' if kv_quant else 'decode_plain'} on the "
          f"model's inputs: max abs err {acc[decode]['max_abs_err']:.4g}; "
          f"decode launches by (view, S) = the plan keys' "
          f"{json.dumps(by_view)}")
    for buckets, ms in timed_run["admits"]:
        print(f"{label} admission step, prompt buckets {buckets}: "
              f"{ms:.3f} ms wall")
    print(f"{label}: median decode step {step_ms:.3f} ms over "
          f"{len(timed_run['decode_ms'])} steps")
    return {"admissions": first["admissions"], "decode_steps": first["steps"],
            "launches": first["counts"],
            "decode_launches": by_view,
            "prefill_launches": {f"{dt} {lq}": n for (dt, lq), n in sorted(
                first["by_key"]["flash_prefill"].items())},
            "checks": acc, "splits": first["splits"],
            "admission_steps": [{"buckets": bk, "ms": ms}
                                for bk, ms in timed_run["admits"]],
            "decode_step_ms": step_ms, "obs": obs}


def serve_configs(phase: str, cfgs, seed: int, new: int = ARCH_NEW,
                  extra=None, trace=False):
    """Each config at its widths, bf16, seeded random weights, one at a
    time: it serves the serving cell's prompts (37, 300, 450, 1000 tokens,
    ``new`` tokens each, 2 slots) with a bf16 cache and under int8
    (``arch_run``, its timed runs traced with ``trace``),
    ``extra(model, params, cfg)`` adds to its results, then it is freed
    before the next loads."""
    out = {}
    for cfg in cfgs:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cfg, device=DEVICE)
        params = model.init_params(seed)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.parameters())
        moe_desc = (f" experts {cfg.moe.num_experts} top {cfg.moe.top_k} "
                    f"d_expert {cfg.moe.d_expert} capacity factor "
                    f"{cfg.moe.capacity_factor}" if cfg.moe else "")
        print(f"{phase} model {cfg.name}: {cfg.num_layers} layers d_model "
              f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} "
              f"(G {cfg.q_group_size}) head_dim {cfg.resolved_head_dim} "
              f"d_ff {cfg.d_ff} vocab {cfg.vocab_size} qkv_bias "
              f"{cfg.qkv_bias}{moe_desc} {cfg.param_dtype}: {n_params} "
              f"params, init {time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in SERVING_PROMPTS]
        res = {"params": n_params, "layers": cfg.num_layers,
               "heads": (cfg.num_heads, cfg.num_kv_heads,
                         cfg.resolved_head_dim)}
        for kv_quant in (None, "int8"):
            res[kv_quant or "bf16"] = arch_run(model, params, cfg, prompts,
                                               kv_quant, new, phase, trace)
        if extra is not None:
            res.update(extra(model, params, cfg))
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        print(f"{phase} {cfg.name}: torch.cuda.max_memory_allocated "
              f"{res['max_memory_allocated']} B")
        out[cfg.name] = res
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_archs(seed: int):
    """codeqwen1.5-7b and stablelm-12b at full width (``serve_configs``)."""
    return serve_configs("archs", [get_arch(a) for a in ARCHS], seed)


# ---------------------------------------------------------------------------
# the MoE family: granite-moe-3b-a800m at full width and depth,
# qwen3-moe-235b-a22b at full width and 4 of its 94 layers
# ---------------------------------------------------------------------------

# (arch, layers kept (None: all), new tokens a request).  qwen3-moe's 94
# layers hold about 235e9 parameters, 470 GB in bf16: 4 layers (about
# 19.3 GB of experts plus 2.5 GB of embedding and unembedding) fit one
# card and keep every width
MOE_ARCHS = (("granite-moe-3b-a800m", None, ARCH_NEW),
             ("qwen3-moe-235b-a22b", 4, 8))
DISPATCH_TOL = 2e-2          # bf16: the two dispatches round otherwise


def moe_dispatch_check(model, params, cfg):
    """Layer 0's experts on the card: the gather dispatch against the
    einsum one at the serving cell's prefill group (one row of the 1024
    bucket) and decode groups (two rows of one token), on normal inputs
    of the model's dtype, within DISPATCH_TOL; each timed (CUDA events,
    L2 flushed) beside the time to read every expert's weights once."""
    from repro_torch.models import moe
    ffn = params.layers[0].ffn
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    weights = sum(getattr(ffn, n).numel() * getattr(ffn, n).element_size()
                  for n in ("wi_gate", "wi_up", "wo"))
    out = {}
    for name, shape in (("prefill", (1, 1024, cfg.d_model)),
                        ("decode", (2, 1, cfg.d_model))):
        x = torch.randn(shape, generator=gen, device=DEVICE).to(
            ffn.wo.dtype)
        runs = {d: functools.partial(moe.apply_moe, ffn, cfg, x,
                                     dispatch=d)
                for d in ("gather", "einsum")}
        err = max_err(runs["gather"](), runs["einsum"](),
                      DISPATCH_TOL)
        ms = {d: time_ms(fn, 20, flush) for d, fn in runs.items()}
        bound = weights / HBM_BYTES_PER_S * 1e3
        print(f"moe {cfg.name} layer 0 {name} group {tuple(shape)}: gather "
              f"against einsum dispatch max abs err {err:.4g} (tol "
              f"{DISPATCH_TOL}); gather {ms['gather']:.6f} ms, einsum "
              f"{ms['einsum']:.6f} ms; reading every expert's weights "
              f"({weights} B) takes {bound:.6f} ms")
        out[name] = {"max_abs_err": err, "gather_ms": ms["gather"],
                     "einsum_ms": ms["einsum"], "weights_bytes": weights,
                     "weights_bound_ms": bound}
    return {"dispatch": out}


def phase_moe(seed: int):
    """The MoE family through ``serve_configs``: granite-moe-3b-a800m at
    full width and depth (16 new tokens a request, its timed runs with
    tracing and metrics on, and the dispatch check), then
    qwen3-moe-235b-a22b at full width with its depth cut to 4 layers (8
    new tokens)."""
    out = {}
    for arch, layers, new in MOE_ARCHS:
        cfg = get_arch(arch)
        if layers is not None:
            print(f"moe {arch}: depth cut from {cfg.num_layers} to {layers} "
                  f"layers (every width kept)")
            cfg = cfg.replace(num_layers=layers)
        full = layers is None
        out.update(serve_configs(
            "moe", [cfg], seed, new, moe_dispatch_check if full else None,
            trace=full))
    return out


def arch_kernel_rows(gen, sms: int, archs):
    """The kernels line's rows at each config's shapes, with the launches
    its serving runs counted there: the decode kernel at B=2, view 1024,
    kv_len [1000, 450] (the second wave's decode shape) under ``paper``,
    over a bf16 cache and over int8 (NaN / poisoned tails), and the bf16
    prefill kernel at Lq = Lk = 1024 (the 1000-token prompt's bucket)."""
    rows = []
    for arch, res in archs.items():
        hq, hkv, d = res["heads"]
        g = hq // hkv
        s = Planner(policy="paper", num_cores=sms).plan(AttentionSpec.decode(
            2, 1024, hq, hkv, d)).num_splits
        sq = Planner(policy="paper", num_cores=sms).plan(AttentionSpec.decode(
            2, 1024, hq, hkv, d, kv_dtype="int8")).num_splits
        k, v = (rand(gen, (2, 1024, hkv, d)) for _ in range(2))
        c = decode_case(rand(gen, (2, hq, d)), k, v, 1024, (1000, 450), s)
        n = int(c["lens"].sum())
        err, _ = check_decode(c)
        rows.append(dict(
            name="flash_decode", shape=f"{arch} G{g} D{d} {c['label']} "
                                       f"fused combine",
            fn=functools.partial(fdec.flash_decode, c["qp"], c["kp"],
                                 c["vp"], c["lens"], num_splits=s),
            plain=functools.partial(fdec.decode_plain, c["qp"], c["kv"],
                                    c["vv"], c["lens"], num_splits=s),
            lib=c["sdpa"],
            nbytes=2 * n * hkv * d * 2 + 2 * c["qp"].numel() * 2,
            flops=4 * n * hq * d, err=err,
            launches=res["bf16"]["decode_launches"].get(f"1024 S{s}", 0)))
        art = Quantizer.from_kv_dtype("int8").quantized_kv(k.float(),
                                                           v.float())
        qc = quant_case(c["q"], art, 1024, (1000, 450), sq, "int8")
        qerr, _ = check_decode_quant(qc)
        rows.append(dict(
            name="flash_decode_quant",
            shape=f"{arch} G{g} D{d} {qc['label']} fused combine",
            fn=functools.partial(fdq.flash_decode_quant, qc["qp"],
                                 *qc["pview"], qc["lens"], num_splits=sq),
            plain=functools.partial(fdq.decode_quant_plain, qc["qp"],
                                    *qc["view"], qc["lens"], num_splits=sq),
            lib=None, nbytes=2 * n * hkv * (d + 4) + 2 * qc["qp"].numel() * 2,
            flops=4 * n * hq * d + 2 * n * hkv * d, peak=INT8_OPS_PER_S,
            err=qerr,
            launches=res["int8"]["decode_launches"].get(f"1024 S{sq}", 0)))
        pq, pk, pv = prefill_case(gen, 1, 1024, 1024, hq, hkv, d)
        rows.append(dict(
            name="flash_prefill",
            shape=f"{arch} B1 Lq=Lk=1024 Hq{hq} Hkv{hkv} D{d} causal bf16",
            fn=functools.partial(flash_prefill, pq, pk, pv, causal=True),
            plain=functools.partial(prefill_plain, pq, pk, pv, causal=True),
            lib=functools.partial(F.scaled_dot_product_attention,
                                  *(t.transpose(1, 2) for t in (pq, pk, pv)),
                                  is_causal=True, scale=1.0, enable_gqa=True),
            nbytes=2 * (2 * pq.numel() + pk.numel() + pv.numel()),
            flops=4 * hq * d * 1024 * 1025 / 2,
            err=max_err(flash_prefill(pq, pk, pv, causal=True),
                        prefill_plain(pq, pk, pv, causal=True), PREFILL_TOL),
            launches=res["bf16"]["prefill_launches"].get("bfloat16 1024", 0)))
    return rows


# ---------------------------------------------------------------------------
# speculative decoding and the sampled path
# ---------------------------------------------------------------------------

# benchmarks/spec_ab.py's full workload at full width: 8 prompts (half
# repetitive, which the n-gram drafter drafts well, half random, which
# reject every draft), 32 new tokens, 4 slots, k = 4, max_len 256
SPEC_REQUESTS, SPEC_NEW, SPEC_SLOTS, SPEC_K, SPEC_MAX_LEN = 8, 32, 4, 4, 256
SPEC_CHECKED_STEPS = 4     # verify steps held per layer against the plain
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)


def spec_prompts(vocab: int, seed: int):
    """benchmarks/spec_ab.py's prompts (its ``_workload``), at ``vocab``."""
    rng = np.random.default_rng(seed)
    prompts = []
    for i in range(SPEC_REQUESTS):
        if i % 2 == 0:
            period = rng.integers(2, 5)
            motif = rng.integers(1, vocab, size=period).tolist()
            n = int(rng.integers(8, 16))
            prompts.append((motif * n)[:n])
        else:
            prompts.append(rng.integers(1, vocab,
                                        size=rng.integers(6, 14)).tolist())
    return prompts


@functools.lru_cache(maxsize=None)
def spec_classes():
    """The spec phase's replay drafter (registered as ``"replay"``) and
    checked sampler, made on first use: they build on modules that came
    with speculative decoding, and a copy of this script also runs an
    older checkout's ``--phase admission``, ``times`` and ``digests``."""
    from repro_torch.serving import CategoricalSampler
    from repro_torch.spec import Drafter, register_drafter

    class ReplayDrafter(Drafter):
        """The replay oracle of benchmarks/spec_ab.py: proposes a
        recorded run's continuation of the history's prompt."""

        script = {}

        def propose(self, history, k):
            h = tuple(history)
            for prompt, toks in self.script.items():
                if h[:len(prompt)] == prompt:
                    done = len(h) - len(prompt)
                    return list(toks[done:done + k])
            return []

    register_drafter("replay", ReplayDrafter)

    class CheckedCategorical(CategoricalSampler):
        """CategoricalSampler that keeps, on the device, whether every
        logit was finite and whether its greedy rows equal
        GreedySampler's bits on the same logits (sample and verify), and
        the host ms of its verify calls (each between two
        synchronizes)."""

        def __init__(self):
            self.finite = torch.ones((), dtype=torch.bool, device=DEVICE)
            self.greedy_same = torch.ones((), dtype=torch.bool,
                                          device=DEVICE)
            self.verify_ms = []

        def sample(self, logits, state, pos):
            self.finite &= torch.isfinite(logits).all()
            out = super().sample(logits, state, pos)
            g = torch.as_tensor(state["temperature"] <= 0, device=DEVICE)
            want = GreedySampler().sample(logits, state, pos)
            self.greedy_same &= ((out == want) | ~g).all()
            return out

        def verify(self, logits, draft, state, pos):
            self.finite &= torch.isfinite(logits).all()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, acc = super().verify(logits, draft, state, pos)
            torch.cuda.synchronize()
            self.verify_ms.append((time.perf_counter() - t0) * 1e3)
            g = torch.as_tensor(state["temperature"] <= 0, device=DEVICE)
            wt, wa = GreedySampler().verify(logits, draft, state, pos)
            self.greedy_same &= (((toks == wt).all(-1) & (acc == wa))
                                 | ~g).all()
            return toks, acc

    return ReplayDrafter, CheckedCategorical


@contextlib.contextmanager
def checked_verify(acc, layer_calls: int):
    """Within the block, the first ``layer_calls`` layer calls of
    ``ops.verify_attention`` hold each row's decode-kernel launch against
    ``decode_plain`` on the same inputs (the model's own q and view) at
    DECODE_TOL; every other launch runs unchecked."""
    verify = ops.verify_attention

    def layer(*args, **kw):
        acc["active"] = acc["layers"] < layer_calls
        try:
            return verify(*args, **kw)
        finally:
            acc["layers"] += acc["active"]
            acc["active"] = False

    def row(q, k, v, kv_len, *, num_splits, out_dtype):
        got = fdec.flash_decode(q, k, v, kv_len, num_splits=num_splits,
                                out_dtype=out_dtype)
        if acc["active"]:
            acc["max_abs_err"] = max(acc["max_abs_err"], max_err(
                got, fdec.decode_plain(q, k, v, kv_len,
                                       num_splits=num_splits,
                                       out_dtype=out_dtype), DECODE_TOL))
            acc["rows"] += 1
        return got

    with ops_route("verify_attention", layer), ops_route("flash_decode",
                                                         row):
        yield acc


def drive_steps(engine, requests):
    """Submit everything, then step to completion.  Returns each step's
    kind ("admission" when it prefilled, else "verify" or "decode", from
    the plan keys it launched) with its wall ms, and the completions."""
    for r in requests:
        engine.submit(r)
    steps = []
    while engine.has_work():
        before = dict(engine.stats.launches)
        t0 = time.perf_counter()
        engine.step()           # ends in a host copy of the tokens
        ms = (time.perf_counter() - t0) * 1e3
        new = [k for k, v in engine.stats.launches.items()
               if v != before.get(k, 0)]
        kind = ("admission" if any(isinstance(k, tuple) and "prefill" in k[0]
                                   for k in new)
                else "verify" if any(isinstance(k, tuple) for k in new)
                else "decode")
        steps.append((kind, ms))
    return steps, engine.drain()


def expected_decode_launches(engine, layers: int, kv_quant=None):
    """The decode-kernel launches a run's plan keys imply, by kernel and
    (view, S): a plain step launches the decode kernel (the quantized
    cache's under ``kv_quant``) once a layer at its bucket's plan; a
    verify step of k drafts launches the bf16 decode kernel k + 1 times a
    layer (one per row), at its ("verify", k, bucket) plan."""
    plans = dict(engine.sched.plans.items())
    plain = "flash_decode_quant" if kv_quant else "flash_decode"
    want = {plain: {}, "flash_decode": {}}
    for key, n in engine.stats.launches.items():
        if isinstance(key, int):
            name, bucket, rows = plain, key, 1
        elif key[0] == "verify":
            name, bucket, rows = "flash_decode", key[2], key[1] + 1
        else:
            continue
        s = max(1, min(plans[key].plan.num_splits, bucket))
        by = want[name]
        by[(bucket, s)] = by.get((bucket, s), 0) + layers * rows * n
    return want


def spec_run(model, params, cfg, prompts, method=None, layout="dense",
             kv_quant=None, checked_steps: int = 0, sampling=None,
             sampler=None):
    """One engine run of the spec cell: ``prompts`` with ``method``'s
    drafter at k = SPEC_K (None: spec-off), ``sampling(i)`` the knobs of
    request i (None: greedy), the launch counts zeroed just before the run
    and read just after.  Checks: the decode-kernel launches by kernel and
    by (view, S) are what the plan keys imply (36 per plain step, 36 x (k
    + 1) per verify step of k drafts), the prefill kernel 36 per
    admission, no combine, no policy evaluation, finite logits, full
    completions, conservation (paged); with ``checked_steps``, every
    layer's verify attention of the first verify steps against
    ``decode_plain`` row by row."""
    from repro_torch.serving import SamplingParams
    from repro_torch.spec import SpecConfig
    spec_classes()                      # registers the replay drafter
    layers = cfg.num_layers
    label = (f"spec {method or 'off'} {layout} {kv_quant or 'bf16'}"
             + (" sampled" if sampling else ""))
    sampler = sampler if sampler is not None else CheckedGreedy()
    engine = ServingEngine(
        model, ServeConfig(model=cfg, cache_layout=layout, kv_quant=kv_quant),
        max_len=SPEC_MAX_LEN, batch_slots=SPEC_SLOTS, policy="paper",
        sampler=sampler, device=DEVICE)
    engine.load(params)
    spec = SpecConfig(method, SPEC_K) if method else None
    reqs = [Request(i, p, max_new_tokens=SPEC_NEW, sampling=SamplingParams(
        speculation=spec, **((sampling and sampling(i)) or {})))
        for i, p in enumerate(prompts)]
    acc = {"max_abs_err": 0.0, "rows": 0, "layers": 0, "active": False}
    ops.reset_launch_counts()
    ops.reset_policy_eval_count()
    with checked_verify(acc, checked_steps * layers):
        steps, done = drive_steps(engine, reqs)
    torch.cuda.synchronize()
    st = engine.stats
    counts = ops.launch_counts()
    want = expected_decode_launches(engine, layers, kv_quant)
    for name, by in want.items():
        got = ops.launch_counts_by_key(name)
        check(got == by, f"{label}: {name} launches by (view, S) {got} != "
              f"{by} from the plan keys")
        check(counts[name] == sum(by.values()), f"{label}: {name} "
              f"launches {counts[name]}")
    admissions = sum(v for k, v in st.launches.items()
                     if isinstance(k, tuple) and k[0] == "prefill")
    check(counts["flash_prefill"] == layers * admissions
          == layers * len(prompts), f"{label}: prefill launches")
    check(counts["flash_combine"] == 0, f"{label}: combine launched")
    check(ops.policy_eval_count() == 0, f"{label}: policy evaluated")
    check(bool(sampler.finite.item()), f"{label}: non-finite logits")
    check([len(c.tokens) for c in done] == [SPEC_NEW] * len(prompts)
          and all(c.finish_reason == "length" for c in done),
          f"{label}: completions")
    if engine.cache.is_paged:
        engine.cache.check_conservation()
    if checked_steps:
        check(acc["layers"] == checked_steps * layers and acc["rows"] > 0,
              f"{label}: {acc['layers']} verify layer calls checked")
    verify_ms = [ms for kind, ms in steps if kind == "verify"]
    plain_ms = [ms for kind, ms in steps if kind == "decode"]
    plain_steps = sum(v for k, v in st.launches.items() if isinstance(k, int))
    verify_keys = {f"{k[1]}/{k[2]}": v for k, v in st.launches.items()
                   if isinstance(k, tuple) and k[0] == "verify"}
    run = {"streams": [c.tokens for c in done],
           "plain_steps": plain_steps, "verify_launches": verify_keys,
           "verify_row_launches": layers * sum(
               v * (int(k.split("/")[0]) + 1)
               for k, v in verify_keys.items()),
           "spec": {k: v for k, v in st.to_json().items()
                    if k.startswith("spec_")},
           "launches": counts,
           "decode_launches": {f"{name} {v} S{s}": n
                               for name, by in want.items()
                               for (v, s), n in sorted(by.items())},
           "median_verify_step_ms": median(verify_ms) if verify_ms
           else None,
           "median_decode_step_ms": median(plain_ms) if plain_ms else None,
           "verify_steps": len(verify_ms), "decode_steps": len(plain_ms)}
    if checked_steps:
        run["checked"] = {"layer_calls": acc["layers"], "rows": acc["rows"],
                          "max_abs_err": acc["max_abs_err"]}
    print(f"{label}: acceptance {st.spec_acceptance_rate:.4f} "
          f"({st.spec_accepted}/{st.spec_proposed}), "
          f"{st.spec_tokens_per_step:.4f} tokens per verify step, "
          f"{st.spec_steps} verify slot steps, {st.spec_disabled} disabled; "
          f"{plain_steps} plain steps, verify launches {verify_keys}; "
          f"decode-kernel launches {run['decode_launches']}; median verify "
          f"step {run['median_verify_step_ms']} ms over {len(verify_ms)}, "
          f"median plain step {run['median_decode_step_ms']} ms over "
          f"{len(plain_ms)}")
    if checked_steps:
        print(f"{label}: verify attention of the first {checked_steps} "
              f"verify steps, {acc['layers']} layer calls, {acc['rows']} "
              f"row launches against decode_plain on the model's inputs: "
              f"max abs err {acc['max_abs_err']:.4g}")
    return run


def parts_at(base, run):
    """Per request, the first token index where ``run``'s stream leaves
    ``base``'s (None where they agree)."""
    return [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
            for a, b in zip(base, run)]


def verify_vs_decode(model, params, cfg, seed: int, rows: int = SPEC_K + 1):
    """Where a verify step's values leave sequential decode's on the same
    tokens, at full width: 4 prompts (37, 60, 90 and 120 tokens)
    prefilled into one cache, then ``rows`` tokens fed either as ``rows``
    decode steps or as one verify block, from copies of that cache, under
    frozen ``paper`` plans of the same bucket (both S1 here); once through
    the kernels and once with the decode kernel's plain version (f32
    attention).  Every layer's attention inputs (q, and the K and V rows a
    row may read) and output are recorded in both: wherever a row's inputs
    are equal bit for bit its output must be too (checked), which holds
    the verify rows to decode's function exactly.  The first layer whose
    inputs differ (the GEMMs over B x rows rows round otherwise than over
    B), the logits' relative L2 and the share of equal argmaxes are
    printed."""
    rng = np.random.default_rng(seed + 3)
    lens = (37, 60, 90, 120)
    caches, first, _ = prefill_checked(model, params, cfg, rng, lens)
    b, bucket = len(lens), 128
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    planner = Planner(policy="paper",
                      num_cores=torch.cuda.get_device_properties(
                          0).multi_processor_count)
    dplan = planner.plan(AttentionSpec.decode(b, bucket, hq, hkv, d),
                         bucket=bucket)
    vplan = planner.plan(AttentionSpec.verify(b, rows, bucket, hq, hkv, d),
                         bucket=bucket)
    pos = torch.tensor(lens, device=DEVICE)
    tokens = torch.stack([torch.stack(first)]
                         + [torch.tensor(rng.integers(0, cfg.vocab_size, b),
                                         device=DEVICE)
                            for _ in range(rows - 1)], dim=1)
    out = {}
    for route, fn in (("kernels", fdec.flash_decode),
                      ("plain", fdec.decode_plain)):
        rec = {"decode": [], "verify": []}

        def recorded(kind, op):
            def call(q, k, v, *args, **kw):
                o = op(q, k, v, *args, **kw)
                rec[kind].append((q.clone(), k[:, :bucket].clone(),
                                  v[:, :bucket].clone(), o))
                return o
            return call

        with ops_route("flash_decode", fn), \
                ops_route("decode_attention",
                          recorded("decode", ops.decode_attention)), \
                ops_route("verify_attention",
                          recorded("verify", ops.verify_attention)):
            cache = {k: x.clone() for k, x in caches.items()}
            seq = torch.stack([model.decode_step(params, cache, tokens[:, j],
                                                 pos + j, plan=dplan)
                               for j in range(rows)], dim=1)
            cache = {k: x.clone() for k, x in caches.items()}
            ver = model.verify_step(params, cache, tokens, pos, plan=vplan)
        layers = cfg.num_layers
        first_diff, same_inputs = None, 0
        for layer in range(layers):
            qv, kv, vv, ov = rec["verify"][layer]
            for j in range(rows):
                qd, kd, vd, od = rec["decode"][j * layers + layer]
                equal_in = torch.equal(qd, qv[:, j]) and all(
                    torch.equal(x[i, :n + j + 1], y[i, :n + j + 1])
                    for x, y in ((kd, kv), (vd, vv))
                    for i, n in enumerate(lens))
                if not equal_in:
                    first_diff = layer if first_diff is None else first_diff
                    continue
                same_inputs += 1
                if dplan.num_splits == vplan.num_splits:
                    check(torch.equal(od, ov[:, j]),
                          f"spec verify vs decode ({route}): layer {layer} "
                          f"row {j} equal inputs, other output bits")
        rel = ((ver - seq).norm(dim=-1) / seq.norm(dim=-1)).flatten()
        same = (ver.argmax(-1) == seq.argmax(-1)).float().mean().item()
        out[route] = {"rel_l2_max": rel.max().item(),
                      "rel_l2_median": rel.median().item(),
                      "argmax_agrees": same,
                      "first_layer_inputs_differ": first_diff,
                      "rows_with_equal_inputs": same_inputs,
                      "rows": layers * rows}
        print(f"spec verify vs decode ({route}, B{b} bucket{bucket}, {rows} "
              f"rows, decode S{dplan.num_splits} verify S{vplan.num_splits}):"
              f" {same_inputs} of {layers * rows} layer rows see the same "
              f"attention inputs, and give the same output bits; inputs "
              f"first differ at layer {first_diff}; logits rel L2 median "
              f"{out[route]['rel_l2_median']:.3e} max "
              f"{out[route]['rel_l2_max']:.3e}, argmax agrees {same:.3f}")
    return out


def profile_verify_step(model, params, cfg, prompts, script):
    """torch.profiler over one verify step of the replay oracle (dense,
    the first wave of SPEC_SLOTS requests, after its admission and one
    verify step): wall ms, device busy ms, idle share and device
    operations."""
    from repro_torch.serving import SamplingParams
    from repro_torch.spec import SpecConfig
    replay, _ = spec_classes()
    replay.script = script
    engine = ServingEngine(model, ServeConfig(model=cfg),
                           max_len=SPEC_MAX_LEN, batch_slots=SPEC_SLOTS,
                           policy="paper", device=DEVICE)
    engine.load(params)
    for i, p in enumerate(prompts[:SPEC_SLOTS]):
        engine.submit(Request(i, p, max_new_tokens=SPEC_NEW,
                              sampling=SamplingParams(
                                  speculation=SpecConfig("replay", SPEC_K))))
    engine.step()
    engine.step()

    def verify_launches():
        return sum(v for k, v in engine.stats.launches.items()
                   if isinstance(k, tuple) and k[0] == "verify")

    before = verify_launches()
    with profiled() as (prof, wall):
        engine.step()
    check(verify_launches() == before + 1, "spec profile: not a verify step")
    kernels, launches = device_kernels(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_ms": wall[0], "device_busy_ms": busy,
           "idle_share": 1 - busy / wall[0], "device_ops": launches,
           "top_kernels_ms": {k[:80]: v for k, v in top}}
    print(f"spec profile, one verify step (B{SPEC_SLOTS}, k={SPEC_K}, "
          f"oracle, dense): wall {wall[0]:.3f} ms, device busy {busy:.3f} "
          f"ms, idle share {out['idle_share']:.3f}, {launches} device ops "
          f"(profiler on)")
    for name, ms in out["top_kernels_ms"].items():
        print(f"  {ms:.4f} ms  {name}")
    engine.drain()
    return out


def phase_spec(model, params, cfg, seed: int):
    """Speculative decoding and the sampled path at full width (the
    qwen2.5-3b of phase 3) on benchmarks/spec_ab.py's workload, each run
    through ``spec_run``: spec-off, ``ngram`` and the replay oracle (the
    spec-off run's streams), dense and paged (page 64), the dense ngram
    run with every layer's verify attention of its first
    SPEC_CHECKED_STEPS verify steps checked; the ngram cell again under
    int8 (paged; K4 on plain steps, K1 on the dequantized view for
    verify), and the oracle, which always drafts; ``verify_vs_decode``; a
    sampled pass (SAMPLED, request 0 greedy) spec-off and with the
    oracle's drafts, twice each, for the same tokens, its greedy rows
    equal to GreedySampler's, and, spec-off, request 0's stream equal to
    a GreedySampler engine's; one profiled verify step.  Acceptance,
    tokens per verify step and where each spec-on stream leaves
    spec-off's are printed, not checked: at full width the verify rows'
    GEMMs over k + 1 rows round otherwise than a decode row's."""
    replay, checked_categorical = spec_classes()
    torch.cuda.reset_peak_memory_stats()
    prompts = spec_prompts(cfg.vocab_size, seed)
    out = {}
    for layout in ("dense", "paged"):
        base = spec_run(model, params, cfg, prompts, None, layout)
        ngram = spec_run(model, params, cfg, prompts, "ngram", layout,
                         checked_steps=SPEC_CHECKED_STEPS
                         if layout == "dense" else 0)
        replay.script = {tuple(p): t
                         for p, t in zip(prompts, base["streams"])}
        oracle = spec_run(model, params, cfg, prompts, "replay", layout)
        for name, run in (("ngram", ngram), ("oracle", oracle)):
            run["leaves_spec_off_at"] = parts_at(base["streams"],
                                                 run["streams"])
            print(f"spec {name} {layout}: streams leave spec-off's at "
                  f"{run['leaves_spec_off_at']}")
        out[layout] = {"off": base, "ngram": ngram, "oracle": oracle}
    check(out["dense"]["off"]["streams"] == out["paged"]["off"]["streams"],
          "spec: paged spec-off streams differ from dense")
    for layout in ("dense", "paged"):
        check(out[layout]["oracle"]["verify_steps"] > 0,
              f"spec oracle {layout}: no verify step")
    script = {tuple(p): t for p, t in zip(prompts,
                                          out["dense"]["off"]["streams"])}
    # under int8 the n-gram drafter may find nothing to draft in these
    # streams; the replay oracle always drafts, so verify runs over the
    # dequantized view
    for method in ("ngram", "replay"):
        replay.script = script
        out[f"int8_{method}"] = spec_run(model, params, cfg, prompts, method,
                                         "paged", kv_quant="int8")
    check(out["int8_replay"]["verify_steps"] > 0, "spec int8: no verify step")
    out["verify_vs_decode"] = verify_vs_decode(model, params, cfg, seed)
    out["profile"] = profile_verify_step(model, params, cfg, prompts, script)

    def sampled(i):
        return None if i == 0 else dict(SAMPLED, seed=seed + i)

    for method in (None, "replay"):
        runs, samplers = [], []
        for _ in range(2):
            replay.script = script
            samplers.append(checked_categorical())
            runs.append(spec_run(model, params, cfg, prompts, method,
                                 sampling=sampled, sampler=samplers[-1]))
        name = f"sampled_{method or 'off'}"
        check(runs[0]["streams"] == runs[1]["streams"],
              f"spec {name}: two runs with the same seeds differ")
        check(all(bool(s.greedy_same.item()) for s in samplers),
              f"spec {name}: greedy rows differ from GreedySampler's")
        res = runs[0]
        if method:
            check(res["verify_steps"] > 0, f"spec {name}: no verify step")
            ms = samplers[0].verify_ms
            share = sum(ms) / (res["median_verify_step_ms"]
                               * res["verify_steps"])
            res["sampler_verify_ms"] = median(ms)
            res["sampler_share_of_verify_step"] = share
            print(f"spec {name}: sampler.verify median {median(ms):.3f} ms "
                  f"over {len(ms)} calls (host, synchronized), about "
                  f"{share:.3f} of the verify steps' wall")
        else:
            check(res["streams"][0] == out["dense"]["off"]["streams"][0],
                  f"spec {name}: request 0 (greedy) differs from the "
                  f"GreedySampler engine's stream")
        print(f"spec {name}: two runs give the same tokens; greedy rows "
              f"equal GreedySampler's bits")
        out[name] = res
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(f"spec: torch.cuda.max_memory_allocated "
          f"{out['max_memory_allocated']} B")
    return out


def verify_kernel_row(gen, sms: int, spec):
    """The kernels line's row of one verify-row launch at the spec cell's
    shape: B=4 slots, view 128, the verify plan of k = SPEC_K at that
    bucket, kv_len of a mid-run verify step; launches: the dense ngram
    run's verify-row launches (a layer's k + 1 per verify step)."""
    hkv, g, d, b, bucket = 2, 8, 128, SPEC_SLOTS, 128
    s = Planner(policy="paper", num_cores=sms).plan(AttentionSpec.verify(
        b, SPEC_K + 1, bucket, hkv * g, hkv, d), bucket=bucket).num_splits
    k, v = (rand(gen, (b, bucket, hkv, d)) for _ in range(2))
    c = decode_case(rand(gen, (b, hkv * g, d)), k, v, bucket,
                    (30, 41, 25, 36), s)
    n = int(c["lens"].sum())
    err, _ = check_decode(c)
    ngram = spec["dense"]["ngram"]
    return dict(
        name="flash_decode", shape=f"verify row, {c['label']} fused combine",
        fn=functools.partial(fdec.flash_decode, c["qp"], c["kp"], c["vp"],
                             c["lens"], num_splits=s),
        plain=functools.partial(fdec.decode_plain, c["qp"], c["kv"], c["vv"],
                                c["lens"], num_splits=s),
        lib=c["sdpa"], nbytes=2 * n * hkv * d * 2 + 2 * c["qp"].numel() * 2,
        flops=4 * n * hkv * g * d, err=err,
        launches=ngram["verify_row_launches"])


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
                       table1_rows, suffix_launches, extra_rows=()):
    """``counts``: the main path's launches by kernel name;
    ``prefill_launches`` / ``decode_launches``: the bf16 serving run's
    prefill launches by "dtype Lq" and decode launches by "view S",
    ``quant_launches`` the int8 run's quantized decode launches by "view
    S": each row's ``launches``; ``table1_rows``: the rows of
    phase_table1 (the decode kernels at Table 1's changed cells, with the
    launches of that phase's path); ``suffix_launches``: the first timed
    shared bf16 run of the prefix cell's prefill launches by "dtype Lq"
    (its suffix prefills run at Lq 128 over a 1024-row view from q_offset
    960); ``extra_rows``: rows built elsewhere in the same form (the
    verify row of the spec cell, the two configs' rows)."""
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
    # K3 as the prefix cell's suffix prefill runs it: the padded suffix
    # (Lq 128) over the slot's 1024-row view from q_offset 960, so its
    # last 64 query rows lie past the view's end
    lq, lk, off = 128, 1024, (PREFIX_SYSTEM // 64) * 64
    pq, pk, pv = prefill_case(gen, 1, lq, lk, hq, hkv, d)
    mask = (torch.arange(lk, device=DEVICE)[None]
            <= off + torch.arange(lq, device=DEVICE)[:, None])
    kw = dict(causal=True, q_offset=off)
    out.append(dict(
        name="flash_prefill",
        shape=f"B1 Lq={lq} Lk={lk} q_offset={off} Hq{hq} Hkv{hkv} D{d} "
              f"causal bf16, suffix prefill",
        fn=functools.partial(flash_prefill, pq, pk, pv, **kw),
        plain=functools.partial(prefill_plain, pq, pk, pv, **kw),
        lib=functools.partial(F.scaled_dot_product_attention,
                              *(t.transpose(1, 2) for t in (pq, pk, pv)),
                              attn_mask=mask, scale=1.0, enable_gqa=True),
        nbytes=2 * (2 * pq.numel() + pk.numel() + pv.numel()),
        # query row i attends keys 0 .. min(off + i, lk - 1)
        flops=4 * hq * d * sum(min(off + i + 1, lk) for i in range(lq)),
        err=max_err(flash_prefill(pq, pk, pv, **kw),
                    prefill_plain(pq, pk, pv, **kw), PREFILL_TOL),
        launches=suffix_launches.get(f"bfloat16 {lq}", 0)))
    out += table1_rows
    out += list(extra_rows)
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


# ---------------------------------------------------------------------------
# phase 4e: measured split autotuning
# ---------------------------------------------------------------------------

# the cells whose measured curve is printed beside the policies' splits:
# the paper's Table 1 changed cells (B 1, H_Q 64, H_KV 1 / 2, L_K 512),
# then qwen2.5-3b's decode shape at B 1 / 2 and four buckets, bf16 / int8
TUNE_CELLS = [(1, 512, 64, 1, "bfloat16"), (1, 512, 64, 2, "bfloat16")] + [
    (b, lk, 16, 2, dt) for dt in ("bfloat16", "int8") for b in (1, 2)
    for lk in (384, 512, 1024, 2048)]
# the sub-grid calibrated a second time, on other seeded inputs: the
# table's stability (48 cells)
TUNE_STABILITY = dict(lk_buckets=(384, 512, 1024, 2048), batches=(1, 2, 4),
                      head_shapes=((16, 2, 128), (64, 2, 128)))


def tune_cell_lines(cal, table, sms: int):
    """Per TUNE_CELLS cell: the measured curve, its argmin, ``paper``'s
    and ``fa3_baseline``'s splits and t(policy's S) / t(argmin), timing a
    policy's S that is not a candidate (S=3 over 4 blocks partitions as
    S=2 does, plus one empty CTA) on the cell's own inputs."""
    fams = {(e["batch"], e["lk_bucket"], e["num_heads_q"],
             e["num_heads_kv"], e["kv_dtype"]): e for e in table.entries}
    out = []
    for i, (b, lk, hq, hkv, dt) in enumerate(TUNE_CELLS):
        e = fams[(b, lk, hq, hkv, dt)]
        lat = {int(k): v for k, v in e["latencies_us"].items()}
        w = DecodeWorkload(b, 1, lk, hq, hkv, 128,
                           dtype_bytes=2 if dt == "bfloat16" else 1,
                           kv_dtype=dt)
        pol = {p: choose_num_splits(w, policy=p, num_cores=sms)
               for p in ("paper", "fa3_baseline")}
        extra = sorted({s for s in pol.values() if s not in lat})
        if extra:
            lat.update(cal.time_splits(w, extra, cell=10_000 + i))
        best = e["best_split"]
        ratio = {p: lat[s] / lat[best] for p, s in pol.items()}
        row = {"cell": f"B{b} L{lk} Hq{hq} Hkv{hkv} {dt}",
               "curve_us": {str(k): round(v, 4) for k, v in sorted(
                   lat.items())},
               "argmin": best, "paper": pol["paper"],
               "fa3_baseline": pol["fa3_baseline"],
               "paper_over_argmin": round(ratio["paper"], 4),
               "baseline_over_argmin": round(ratio["fa3_baseline"], 4),
               "timed_off_grid": extra}
        print(f"tune {row['cell']}: curve us {row['curve_us']} argmin "
              f"S={best}; paper S={pol['paper']} x{ratio['paper']:.4f}, "
              f"fa3_baseline S={pol['fa3_baseline']} "
              f"x{ratio['fa3_baseline']:.4f} of the argmin's time"
              + (f" (S {extra} timed off the grid)" if extra else ""))
        out.append(row)
    return out


def tune_policy_summary(table, sms: int):
    """Over every cell of the table: how often each analytic policy's
    split is the measured argmin, and t(policy's S) / t(argmin) (median,
    max) where its S is on the cell's candidate grid (``paper``'s S=3
    over 4 blocks is not: it partitions as S=2 does)."""
    out = {}
    for policy in ("paper", "fa3_baseline", "tpu_adaptive"):
        hit, off, ratios = 0, 0, []
        for e in table.entries:
            w = DecodeWorkload(e["batch"], 1, e["lk_bucket"],
                               e["num_heads_q"], e["num_heads_kv"],
                               e["head_dim"], dtype_bytes=e["dtype_bytes"],
                               kv_dtype=e["kv_dtype"])
            s = choose_num_splits(w, policy=policy, num_cores=sms)
            lat = e["latencies_us"]
            if str(s) not in lat:
                off += 1
                continue
            hit += s == e["best_split"]
            ratios.append(lat[str(s)] / lat[str(e["best_split"])])
        ratios.sort()
        out[policy] = {"argmin": hit, "off_grid": off,
                       "on_grid": len(ratios),
                       "median_over_argmin": round(median(ratios), 4),
                       "max_over_argmin": round(ratios[-1], 4)}
        print(f"tune {policy} over {len(table)} cells: its split is the "
              f"argmin in {hit}, off the grid in {off}; t(S) / t(argmin) "
              f"median {median(ratios):.4f}, max {ratios[-1]:.4f} over "
              f"{len(ratios)}")
    return out


def table_agreement(a, b):
    """Two calibrations of one grid, cell by cell: the argmins that
    differ (each with t(b's argmin) / t(a's argmin) in ``a``) and the
    quantiles of a's time over b's at every shared split."""
    key = lambda e: (e["batch"], e["num_heads_q"], e["num_heads_kv"],
                     e["head_dim"], e["kv_dtype"], e["lk_bucket"])
    first = {key(e): e for e in a.entries}
    changed, ratios = [], []
    for e in b.entries:
        f = first[key(e)]
        lat = f["latencies_us"]
        if f["best_split"] != e["best_split"]:
            changed.append(round(lat[str(e["best_split"])]
                                 / lat[str(f["best_split"])], 4))
        ratios += [lat[s] / t for s, t in e["latencies_us"].items()]
    ratios.sort()
    q = {p: round(ratios[round(p * (len(ratios) - 1))], 4)
         for p in (0.0, 0.01, 0.5, 0.99, 1.0)}
    return {"cells": len(b.entries), "argmins_changed": len(changed),
            "changed_ratios": sorted(changed), "time_ratio_quantiles": q}


def tune_serve(model, params, cfg, seed: int, table, kv_quant=None):
    """The serving cell (2 slots, the 4 prompts, 32 new tokens) under
    ``split_policy="measured"`` from ``table``, every layer's decode
    attention held against its plain version: 0 policy evaluations, each
    resident bucket's frozen split = ``table.choose`` of its decode
    workload (bucket 1152, off the grid, takes the nearest bucket),
    launches by (view, S) = the plan keys' implied counts, no fallback."""
    label = kv_quant or "bf16"
    rng = np.random.default_rng(seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=32) for i, n in enumerate(SERVING_PROMPTS)]
    sampler = CheckedGreedy()
    engine = ServingEngine(model, ServeConfig(model=cfg, seed=seed,
                                              kv_quant=kv_quant,
                                              split_policy="measured"),
                           max_len=2048, batch_slots=2, sampler=sampler,
                           tune_table=table, device=DEVICE)
    engine.load(params)
    acc = {}
    ops.reset_launch_counts()
    ops.reset_policy_eval_count()
    with checked_kernels(acc):
        _, decode_ms, wall, done, _, _ = drive(engine, reqs)
    torch.cuda.synchronize()
    st = engine.stats
    stats = {k: st.to_json()[k] for k in ("measured_lookups",
                                          "measured_fallbacks",
                                          "measured_fallback_trace")}
    layers = cfg.num_layers
    decode = "flash_decode_quant" if kv_quant else "flash_decode"
    got = {name: ops.launch_counts_by_key(name)
           for name in ("flash_decode", "flash_decode_quant")}
    got = {name: by for name, by in got.items() if by}
    want = {name: by for name, by in expected_decode_launches(
        engine, layers, kv_quant).items() if by}
    # a probe copy: its lookups do not count in the engine's stats
    probe = SplitTable(table.entries, table.fingerprint)
    splits = engine.planned_splits()
    chosen = {bk: probe.choose(engine.sched.decode_spec(bk).workload())[0]
              for bk in splits}
    print(f"tune serving {label}: planned splits {splits}, table's "
          f"{chosen}; launches by (view, S) {got[decode]}; lookups "
          f"{stats['measured_lookups']}, fallbacks "
          f"{stats['measured_fallbacks']} {stats['measured_fallback_trace']}"
          f"; decode attention of {acc[decode]['checks']} layer steps: max "
          f"abs err {acc[decode]['max_abs_err']:.4g}; median decode step "
          f"{median(decode_ms):.3f} ms")
    check(ops.policy_eval_count() == 0, f"tune {label}: policy evaluated")
    check(bool(sampler.finite.item()), f"tune {label}: non-finite logits")
    check(1152 in splits, f"tune {label}: no 1152 bucket in {splits}")
    check(splits == chosen, f"tune {label}: frozen splits {splits} != the "
          f"table's {chosen}")
    check(all(e.plan.tuned and e.plan.table_version == table.version
              for k, e in engine.sched.plans.items() if isinstance(k, int)),
          f"tune {label}: a decode plan not from the table")
    check(got == want, f"tune {label}: launches {got} != the plan keys' "
          f"{want}")
    check(acc[decode]["checks"] == sum(got[decode].values()) > 0,
          f"tune {label}: {acc[decode]['checks']} checks")
    check(stats["measured_lookups"] == len(splits)
          and stats["measured_fallbacks"] == 0,
          f"tune {label}: lookups / fallbacks {stats}")
    check([len(c.tokens) for c in done] == [32] * 4,
          f"tune {label}: completions")
    return {"splits": {str(k): v for k, v in splits.items()},
            "decode_launches": {f"{v} S{s}": n for (v, s), n in sorted(
                got[decode].items())},
            "checks": acc[decode], **stats,
            "decode_step_ms": median(decode_ms), "wall_s": wall}


def phase_tune(model, params, cfg, seed: int, sms: int):
    """Measured split autotuning on the card: calibrate ``H100_SPEC``
    (printing TUNE_CELLS' curves beside the policies' splits), calibrate
    TUNE_STABILITY again on other inputs and count the changed argmins,
    serve the serving cell from the fresh table (bf16, then int8) with
    its checks, then run the serving CLI as a subprocess with ``--policy
    measured --tune-table`` (the committed registry
    ``experiments/tune/h100/``, or the fresh table before one is
    committed) and ``--stats-path``."""
    t0 = time.perf_counter()
    cal = Calibrator(H100_SPEC, mode="wallclock", seed=seed)
    table = cal.calibrate()
    cal_s = time.perf_counter() - t0
    floor = cal.floor_us()
    timed = sum(len(e["latencies_us"]) for e in table.entries)
    print(f"tune: calibrated {len(table)} cells ({timed} candidate splits) "
          f"in {cal_s:.1f} s, version {table.version}, timing floor "
          f"{floor:.4f} us a call; fingerprint {table.fingerprint}")
    check(table.fingerprint["sources"] == "measured",
          "tune: some cells were not timed")
    check(all(t > floor for e in table.entries
              for t in e["latencies_us"].values()),
          "tune: a time at or below the timing floor")
    out_dir = ROOT / "chiprun_out" / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    fresh = table.save(out_dir / "h100_fresh.json")
    hist = {}
    for e in table.entries:
        hist[e["best_split"]] = hist.get(e["best_split"], 0) + 1
    print(f"tune: argmin histogram {dict(sorted(hist.items()))}")
    cells = tune_cell_lines(cal, table, sms)
    summary = tune_policy_summary(table, sms)

    t1 = time.perf_counter()
    again = Calibrator(H100_SPEC.replace(**TUNE_STABILITY), mode="wallclock",
                       seed=seed + 1).calibrate()
    first = {(e["batch"], e["num_heads_q"], e["num_heads_kv"],
              e["kv_dtype"], e["lk_bucket"]): e for e in table.entries}
    changed = []
    for e in again.entries:
        a = first[(e["batch"], e["num_heads_q"], e["num_heads_kv"],
                   e["kv_dtype"], e["lk_bucket"])]
        if a["best_split"] != e["best_split"]:
            changed.append({"cell": f"B{e['batch']} L{e['lk_bucket']} "
                                    f"Hq{e['num_heads_q']} "
                                    f"Hkv{e['num_heads_kv']} {e['kv_dtype']}",
                            "first": a["best_split"],
                            "again": e["best_split"],
                            "t_first_at_again": a["latencies_us"][str(
                                e["best_split"])] / a["latencies_us"][str(
                                    a["best_split"])]})
    stab_s = time.perf_counter() - t1
    agree = table_agreement(table, again)
    print(f"tune stability: {len(changed)} of {len(again)} argmins changed "
          f"in a second calibration on other inputs ({stab_s:.1f} s): "
          f"{changed}; first over second time quantiles "
          f"{agree['time_ratio_quantiles']}")
    check(len(again) >= 24, "tune: stability grid under 24 cells")
    # the committed table of this card, calibrated in another process on
    # the same seeded inputs, against the fresh one
    committed = None
    for path in sorted(H100_TABLE_DIR.glob("*.json")):
        t = SplitTable.load(path)
        if t.fingerprint.get("device") == table.fingerprint["device"] \
                and t.spec == table.spec:
            committed = {"table": path.name, "version": t.version,
                         **table_agreement(t, table)}
            print(f"tune against the committed {path.name} ({t.version}): "
                  f"{committed}")

    serving = {}
    for kv_quant in (None, "int8"):
        serving[kv_quant or "bf16"] = tune_serve(model, params, cfg, seed,
                                                 table, kv_quant)

    registry = H100_TABLE_DIR if any(H100_TABLE_DIR.glob("*.json")) \
        else fresh
    stats_path = out_dir / "cli_stats.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen2.5-3b", "--policy", "measured", "--tune-table",
           str(registry), "--stats-path", str(stats_path)]
    res = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ,
                                                  PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=600)
    lines = res.stdout.strip().splitlines()
    print(f"tune cli {' '.join(cmd[1:])}: exit {res.returncode}; "
          + " | ".join(x for x in lines if not x.startswith("req ")))
    check(res.returncode == 0, f"tune cli failed: {res.stderr[-2000:]}")
    check(any(x.startswith("measured policy: table ") for x in lines),
          "tune cli: no measured policy line")
    snap = json.loads(stats_path.read_text())
    check(snap["policy"] == "measured" and snap["measured_lookups"] > 0,
          f"tune cli: stats {snap}")
    return {"calibration_s": cal_s, "cells": len(table),
            "candidates_timed": timed, "version": table.version,
            "fingerprint": table.fingerprint, "floor_us": floor,
            "histogram": {str(k): v for k, v in sorted(hist.items())},
            "tune_cells": cells, "policies": summary, "stability": {
                "cells": len(again), "changed": changed, "seconds": stab_s,
                **agree}, "committed": committed,
            "serving": serving, "cli": {
                "table": str(registry.relative_to(ROOT)),
                "measured_lookups": snap["measured_lookups"],
                "measured_fallbacks": snap["measured_fallbacks"],
                "table_version": snap.get("table_version")}}


# ---------------------------------------------------------------------------
# observability: tracing and metrics on the serving cell
# ---------------------------------------------------------------------------

OBS_NEW = 32               # the serving cell's new tokens a request
OBS_ORDER = (False, True) * 2  # metrics and tracing off / on, in turns
OBS_DIR = ROOT / "chiprun_out" / "obs"


def prometheus_series(text: str) -> dict:
    """Prometheus text exposition as {series: value}; fails on a line
    that is neither ``# HELP`` / ``# TYPE`` nor ``name{labels} value``.
    The port's CLI test parses the metrics file with this too."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith(("# HELP ", "# TYPE ")):
            continue
        name, value = line.rsplit(" ", 1)
        check(re.fullmatch(r'[a-z_]+(\{([a-z_]+="[^"]*",?)*\})?', name)
              is not None, f"obs: bad Prometheus line {line!r}")
        out[name] = float(value)
    return out


def check_obs_artifacts(label, trace_path, metrics_path, run):
    """One traced run's artifacts: the trace validates; it has one
    ``request`` span a request, each containing its ``queue_wait`` and
    ``admit`` spans and a ``first_token`` instant on its track; one launch
    span a prefill or decode launch; the metrics snapshot's ``ttft_ms``
    count is the requests' and its decode ``launch_ms`` count the decode
    steps', and its plan-cache section is the run's PlanCacheStats."""
    from repro_torch.obs import TraceArtifact, validate_trace
    obj = json.loads(Path(trace_path).read_text())
    validate_trace(obj)
    art = TraceArtifact(obj["traceEvents"])
    reqs = art.spans("request")
    check(len(reqs) == len(SERVING_PROMPTS), f"{label}: {len(reqs)} "
          f"request spans")
    for r in reqs:
        t0, t1 = r["ts"], r["ts"] + r["dur"]

        def inside(e, r=r, t0=t0, t1=t1):
            end = e["ts"] + e.get("dur", 0)
            return e["tid"] == r["tid"] and t0 <= e["ts"] and end <= t1
        for name in ("queue_wait", "admit"):
            check(sum(inside(e) for e in art.spans(name)) == 1,
                  f"{label}: request {r['args']['request_id']} has no "
                  f"{name} span inside it")
        check(sum(inside(e) for e in art.instants("first_token")) == 1,
              f"{label}: request {r['args']['request_id']} has no "
              "first_token instant")
    launches = art.spans(cat="launch")
    check(len(launches) == run["admissions"] + run["steps"],
          f"{label}: {len(launches)} launch spans, {run['admissions']} "
          f"admissions + {run['steps']} decode steps")
    for e in launches:
        check(all(k in e["args"] for k in ("num_splits", "mesh_splits",
                                           "kv_dtype", "table_version")),
              f"{label}: launch span without provenance {e}")
    snap = json.loads(Path(metrics_path).read_text())
    mx = snap["metrics"]
    check(mx["ttft_ms"]["aggregate"]["count"] == len(SERVING_PROMPTS),
          f"{label}: ttft_ms count {mx['ttft_ms']['aggregate']['count']}")
    n_dec = mx["launch_ms"]["series"]["kind=decode"]["count"]
    check(n_dec == run["steps"], f"{label}: launch_ms{{kind=decode}} count "
          f"{n_dec}, {run['steps']} decode steps")
    check(snap["plan_cache"]["launches"] == run["stats"]["launches"],
          f"{label}: the metrics' plan-cache section is not the run's")
    return {"events": len(obj["traceEvents"]), "request_spans": len(reqs),
            "launch_spans": len(launches),
            "ttft_ms": mx["ttft_ms"]["aggregate"],
            "tpot_ms": mx["tpot_ms"]["aggregate"],
            "launch_ms_decode": mx["launch_ms"]["series"]["kind=decode"]}


def phase_obs(model, params, cfg, seed: int):
    """Observability on full-width qwen2.5-3b: the serving cell (2 slots,
    the 4 prompts, 32 new tokens each, bf16) four times in turns, with
    ``trace_path`` and ``metrics_path`` off, on, off, on (the engine's
    own dump at drain), each on a fresh engine with the launch counts
    zeroed just before and read just after.  Across the runs the greedy
    streams, the launches by kernel and key, ``PlanCacheStats.to_json()``
    and the policy evaluations (0) must be equal; each traced run's
    artifacts pass ``check_obs_artifacts``.  The median decode step with
    obs on and off is printed, not checked.  Then the serving CLI as a
    subprocess, ``--arch granite-moe-3b-a800m --trace t.json --metrics
    m.prom``: exit 0, both files written, the trace valid, the Prometheus
    text parsed."""
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SERVING_PROMPTS]
    runs, arts, steps_ms = [], [], {False: [], True: []}
    for i, on in enumerate(OBS_ORDER):
        label = f"obs run {i} ({'on' if on else 'off'})"
        paths = dict(trace_path=str(OBS_DIR / f"trace_{i}.json"),
                     metrics_path=str(OBS_DIR / f"metrics_{i}.json")) \
            if on else {}
        sampler = CheckedGreedy()
        engine = ServingEngine(model, ServeConfig(model=cfg, **paths),
                               max_len=2048, batch_slots=2, policy="paper",
                               sampler=sampler, device=DEVICE)
        engine.load(params)
        reqs = [Request(j, p, max_new_tokens=OBS_NEW)
                for j, p in enumerate(prompts)]
        ops.reset_launch_counts()
        ops.reset_policy_eval_count()
        _, decode_ms, wall, done, _, _ = drive(engine, reqs)
        torch.cuda.synchronize()
        st = engine.stats
        check(bool(sampler.finite.item()), f"{label}: non-finite logits")
        run = {"streams": [c.tokens for c in done],
               "counts": ops.launch_counts(),
               "by_key": {name: ops.launch_counts_by_key(name)
                          for name in build.KERNELS},
               "stats": st.to_json(), "evals": ops.policy_eval_count(),
               "steps": sum(v for k, v in st.launches.items()
                            if isinstance(k, int)),
               "admissions": sum(v for k, v in st.launches.items()
                                 if isinstance(k, tuple))}
        check(run["evals"] == 0, f"{label}: policy evaluated")
        check([len(t) for t in run["streams"]]
              == [OBS_NEW] * len(prompts), f"{label}: completions")
        if runs:
            for key in ("streams", "counts", "by_key", "stats"):
                check(run[key] == runs[0][key], f"{label}: {key} differ "
                      f"from run 0's")
        if on:
            arts.append(check_obs_artifacts(label, paths["trace_path"],
                                            paths["metrics_path"], run))
        steps_ms[on] += decode_ms
        runs.append(run)
        print(f"{label}: {run['admissions']} admissions, {run['steps']} "
              f"decode steps, median decode step {median(decode_ms):.3f} ms"
              f", wall {wall:.3f} s")
    a = arts[0]
    print(f"obs: streams, launches by key, PlanCacheStats and 0 policy "
          f"evaluations equal over {len(runs)} runs (on and off); trace "
          f"{a['events']} events, {a['request_spans']} request spans, "
          f"{a['launch_spans']} launch spans; ttft_ms count "
          f"{a['ttft_ms']['count']} (p50 {a['ttft_ms']['p50']} ms), "
          f"launch_ms decode count {a['launch_ms_decode']['count']} (p50 "
          f"{a['launch_ms_decode']['p50']} ms); median decode step on "
          f"{median(steps_ms[True]):.3f} ms, off "
          f"{median(steps_ms[False]):.3f} ms (not a claim: the step is "
          "host-bound)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "granite-moe-3b-a800m", "--trace", "t.json", "--metrics",
           "m.prom"]
    for name in ("t.json", "m.prom"):
        (OBS_DIR / name).unlink(missing_ok=True)
    res = subprocess.run(cmd, cwd=OBS_DIR, env=env, capture_output=True,
                         text=True, timeout=600)
    print(f"obs cli {' '.join(cmd[1:])}: exit {res.returncode}; "
          + " | ".join(res.stdout.strip().splitlines()[-6:]))
    check(res.returncode == 0, f"obs cli failed: {res.stderr[-2000:]}")
    from repro_torch.obs import TraceArtifact, validate_trace
    trace = json.loads((OBS_DIR / "t.json").read_text())
    validate_trace(trace)
    prom = prometheus_series((OBS_DIR / "m.prom").read_text())
    cli_reqs = len(TraceArtifact(trace["traceEvents"]).spans("request"))
    check(cli_reqs == 8 and prom.get("repro_ttft_ms_count") == 8,
          f"obs cli: {cli_reqs} request spans, ttft count "
          f"{prom.get('repro_ttft_ms_count')}")
    print(f"obs cli: trace valid ({len(trace['traceEvents'])} events, "
          f"{cli_reqs} request spans), {len(prom)} Prometheus series")
    return {"runs": [{k: r[k] for k in ("steps", "admissions", "counts")}
                     for r in runs], "artifacts": arts,
            "median_decode_ms_on": median(steps_ms[True]),
            "median_decode_ms_off": median(steps_ms[False]),
            "cli": {"rc": res.returncode, "events":
                    len(trace["traceEvents"]), "prometheus_series":
                    len(prom)}}


def phase_paged_all(model, params, cfg, seed: int):
    """The slice's paths, each fatal on failure: paged against dense, the
    prefix cell (bf16 and int8), DecodeEngine, the serving CLI."""
    out = {"paged": timed("paged", phase_paged, model, params, cfg, seed)}
    for kv_quant in (None, "int8"):
        label = kv_quant or "bf16"
        out[f"prefix_{label}"] = timed(f"prefix {label}", phase_prefix,
                                       model, params, cfg, seed,
                                       kv_quant=kv_quant)
    out["decode_engine"] = timed("decode engine", phase_decode_engine, model,
                                 params, cfg, seed)
    out["cli"] = timed("cli", phase_cli)
    return out


def timed(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, printing the phase's wall seconds."""
    t0 = time.perf_counter()
    res = fn(*args, **kw)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase",
                    choices=("all", "kernels", "digests", "admission",
                             "times", "table1", "shapes", "paged", "spec",
                             "archs", "tune", "moe", "obs"),
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
                         "configs' head shapes the main path lacks; "
                         "'paged' builds, then runs the paged cache, "
                         "prefix sharing, DecodeEngine and the serving "
                         "CLI; 'spec' builds, then runs speculative "
                         "decoding and the sampled path; 'archs' builds, "
                         "then serves codeqwen1.5-7b and stablelm-12b; "
                         "'tune' builds, then calibrates H100_SPEC and "
                         "serves qwen2.5-3b from the table; 'moe' builds, "
                         "then serves granite-moe-3b-a800m and "
                         "qwen3-moe-235b-a22b (4 layers); 'obs' builds, "
                         "then serves qwen2.5-3b with tracing and metrics "
                         "on and off and runs the CLI with them")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    card, sms = timed("build", phase_env_build)
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
    if args.phase == "archs":
        archs = timed("archs", phase_archs, args.seed)
        print(json.dumps({"archs": archs, "card": card}))
        return 0
    if args.phase == "moe":
        moe = timed("moe", phase_moe, args.seed)
        print(json.dumps({"moe": moe, "card": card}))
        return 0
    if args.phase not in ("paged", "spec", "tune", "obs"):
        wide_gen = torch.Generator(device=DEVICE).manual_seed(args.seed + 17)
        errs = timed("parity", phase_parity, gen, sms, wide_gen)
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
    if args.phase == "paged":
        paged = phase_paged_all(model, params, cfg, args.seed)
        print(json.dumps({"paged": paged, "card": card}))
        return 0
    if args.phase == "spec":
        spec = timed("spec", phase_spec, model, params, cfg, args.seed)
        print(json.dumps({"spec": spec, "card": card}))
        return 0
    if args.phase == "tune":
        tune = timed("tune", phase_tune, model, params, cfg, args.seed, sms)
        print(json.dumps({"tune": tune, "card": card}))
        return 0
    if args.phase == "obs":
        obs = timed("obs", phase_obs, model, params, cfg, args.seed)
        print(json.dumps({"obs": obs, "card": card}))
        return 0
    counts, serving, bf16 = timed("serving bf16", phase_serving, model,
                                  params, cfg, args.seed)
    qcounts, qserving, _ = timed("serving int8", phase_serving, model,
                                 params, cfg, args.seed, kv_quant="int8",
                                 bf16=bf16)
    _, fserving, _ = timed("serving fp8", phase_serving, model, params, cfg,
                           args.seed, kv_quant="fp8", bf16=bf16)
    logits = timed("logits", phase_logits, model, params, cfg, args.seed,
                   sms)
    for kv_dtype in ("int8", "fp8"):
        logits[kv_dtype] = timed(f"logits {kv_dtype}", phase_logits_quant,
                                 model, params, cfg, args.seed, sms,
                                 kv_dtype)
    # K1 and K3 launches from the bf16 run, K4's from the int8 run; K2
    # runs in neither
    counts["flash_decode_quant"] = qcounts["flash_decode_quant"]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    paper = timed("paper cell bf16", phase_paper_cell, model, params, cfg,
                  args.seed, flush, sms)
    qpaper = timed("paper cell int8", phase_paper_cell, model, params, cfg,
                   args.seed, flush, sms, kv_quant="int8")
    profile = timed("profile bf16", phase_profile, model, params, cfg,
                    args.seed)
    qprofile = timed("profile int8", phase_profile, model, params, cfg,
                     args.seed, kv_quant="int8")
    paged = phase_paged_all(model, params, cfg, args.seed)
    spec = timed("spec", phase_spec, model, params, cfg, args.seed)
    tune = timed("tune", phase_tune, model, params, cfg, args.seed, sms)
    obs = timed("obs", phase_obs, model, params, cfg, args.seed)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    archs = timed("archs", phase_archs, args.seed)
    moe = timed("moe", phase_moe, args.seed)
    table1, table1_rows = timed("table1", phase_table1, gen, sms, card,
                                flush)
    extra = [verify_kernel_row(gen, sms, spec)] + arch_kernel_rows(
        gen, sms, archs) + arch_kernel_rows(gen, sms, moe)
    kernels = timed("kernels line", phase_kernels_line, gen, sms, errs,
                    counts, flush, serving["prefill_launches"],
                    serving["decode_launches"], qserving["decode_launches"],
                    table1_rows, paged["prefix_bf16"]["prefill_launches"],
                    extra)
    print(json.dumps({"serving": serving, "serving_int8": qserving,
                      "serving_fp8": fserving, "logits": logits,
                      "paper_cell": paper,
                      "paper_cell_int8": qpaper, "profile": profile,
                      "profile_int8": qprofile, "paged": paged,
                      "spec": spec, "tune": tune, "obs": obs,
                      "archs": archs, "moe": moe, "table1": table1,
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
