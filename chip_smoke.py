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
    python3 chip_smoke.py --phase mla     # build + minicpm3-4b
    python3 chip_smoke.py --phase vlm     # build + paligemma-3b
    python3 chip_smoke.py --phase encdec  # build + whisper-large-v3
    python3 chip_smoke.py --phase hybrid  # build + recurrentgemma-9b
    python3 chip_smoke.py --phase ssm     # build + mamba2-780m
    python3 chip_smoke.py --phase shard   # build + qwen2.5-3b at dp 4
                                          # and sequence-sharded at sp 4
    python3 chip_smoke.py --phase tp      # build + tensor- and expert-
                                          # parallel serving, the frozen
                                          # mesh step builders
    python3 chip_smoke.py --phase train   # build + training qwen2.5-3b
                                          # at full width on K3 and K3b

Phases, each fatal on failure.  A phase run alone (``--phase``) serves
its models at full width and depth; the default run, to stay well inside
its 1200 s call on a slow host, serves every model after the main
path's phases (3, 4 and Table 1 keep qwen2.5-3b's 36 layers, as do 4c
and 4j) at full width and the depth of ``DEFAULT_RUN_LAYERS``:
qwen2.5-3b 12 layers in 4b, 4e and 4f, codeqwen1.5-7b, stablelm-12b and
granite-moe-3b-a800m 12 (in 4m too), minicpm3-4b 12, paligemma-3b 9,
whisper-large-v3 16 + 16, recurrentgemma-9b 11 (3 windowed); mamba2-780m
keeps its 48.  (qwen2.5-3b went from 18 to 12 layers and the configs
from 16 to 12 to make room for the training phase, 4l, which keeps full
depth.)

1. Environment and build: the card's name and power limit, CUDA version,
   SM count; all kernels built from ``src/repro_torch/csrc`` (one nvcc per
   source, in parallel) with ptxas's registers, shared memory, spills
   and warnings; any spill fails the run.  Then K3b's two launches at
   every width, bf16 and float32: the registers the runtime reports, the
   dynamic shared memory and threads each launches with, and the dk / dv
   launch's CTAs a chunk and CTAs an SM.
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
   ``q_offset + Lq > Lk``), on random and on the sharp data.  Last, K3b
   (``BWD_PARITY_CASES``, from a generator of its own) in bf16 and
   float32 on the forward kernel's output and LSE, against the float64
   plain backward normwise (1e-2, 1e-5), the same bits again, each
   case's digest in the ``parity digests`` line (float32's keep the
   bits of the CUDA-core body; bf16's are the tensor-core bodies').
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
4h. The single-KV-head families (``phase_mla``, ``phase_vlm``, after 4g,
   through the same ``serve_configs``): minicpm3-4b (62 layers, d_model
   2560, 40 heads, MLA: latent decode at H_KV 1 with K the 288-wide
   latent row and V its first 256 columns, prefill at q / k 96, v 64) at
   full width and depth, fused admission, bf16 dense, int8 (plans keyed
   int8, the latent left bf16 and decoded by the bf16 kernel, as in the
   reference) and bf16 paged; paligemma-3b (18 layers, d_model 2048, 8/1
   heads at D 256, geglu, vocab 257,216) at full width and depth, loop
   admission (every prompt token a decode step), bf16 and int8, then
   ``Model.prefill`` of 256 patch embeddings and 128 tokens at B 2 and 8
   decode steps; every layer's prefill and decode attention checked as
   in 4d, decode launches by (view, S) equal to the plan keys', and
   ``paper``'s splits at H_KV 1 printed beside ``fa3_baseline``'s for the
   serving buckets.
4i. The decode launches over another length than the frozen plan's
   (``phase_encdec``, ``phase_hybrid``, after 4h, through the same
   ``serve_configs``): whisper-large-v3 (32 + 32 layers, d_model 1280,
   20 / 20 heads at D 64, LayerNorm, gelu MLP, no RoPE) at full width
   and depth, the serving cell's prompts, fused admission, bf16, dense
   and paged (page 64): a decode step launches K1 over the self cache at
   the bucket's plan and over the 1500-row cross cache (zero, as the
   reference's: admission resets the slot) at the scheduler's cross side
   plan; then ``Model.prefill`` of 1500 seeded frames and 128 tokens at
   B 2 (the encoder's K3 non-causal at Lq = Lk = 1500, the decoder's
   self and cross K3) and 8 decode steps, where the cross launches read
   the encoder's K / V.  recurrentgemma-9b (38 layers: 26 RG-LRU, 12
   local attention at 16 / 1 heads, D 256, over a 2048-row ring; vocab
   256,000) at full width and depth, loop admission of the serving
   cell's first two prompts, bf16 and int8 (the ring read by K4); then
   ``Model.prefill`` of 2100 tokens at B 2 (windowed K3, the ring
   wrapped) and 8 decode steps over the wrapped ring.  Every layer's
   prefill and decode attention is held against the plain versions in
   float64, launches by (view, S) against the plan keys and side plans,
   no policy evaluation in a step; peak memory, the median decode step
   and a profiled serving step are printed, and the side plans' splits
   under ``paper`` and ``fa3_baseline`` at B 1 and 2.
4j. Mesh-native serving (``phase_shard``, after the obs phase, on the
   main path's qwen2.5-3b): dp 4 x sp 1 with 2 slots a shard, every
   shard on the card (``devices=[cuda:0] * 4``), the serving cell's 4
   prompts and 4 seeded ones, 16 new tokens each: routing [2, 2, 2, 2],
   and each shard's streams bit for bit those of a single-device 2-slot
   engine fed the requests routed to it.  Then dp 1 x sp 4 at max_len
   4096, one 4000-token prompt, 8 new tokens, bf16 and int8: every
   decode plan carries ``mesh_splits`` 4 and the grid; each layer of
   each decode step launches the decode kernel's partials-only epilogue
   (the quantized one's under int8) 4 times at (1024, S1) and the
   combine kernel once, with the counts zeroed just before the run and
   read just after; each layer's sharded output is held against the
   plain version over the whole view in float64 and bit for bit against
   one fused launch at S 4 (whose launches are taken back out of the
   counts), each prefill launch as ``checked_kernels`` does.
4m. Tensor- and expert-parallel serving and the frozen mesh step
   builders (``phase_tp``, after 4j, every grid ``[cuda:0] * n``):
   (a) qwen2.5-3b at full depth at dp 1 x sp 2, ``params="tp"``,
   max_len 2048, the serving cell's 300- and 1000-token prompts, 16 new
   tokens, bf16 then int8: each device's weight bytes against
   ``spec_for``'s slices; fed the replicated sp 2 engine's greedy
   streams, every admission's and step's embedding (bit for bit), layers
   (2e-2 normwise) and unembedding (the f32 sum's bound) against the
   replicated weights' on the same input, every decode and prefill
   launch against its plain version in float64, the launches against
   the plans, no policy evaluation; the logits' gap and the divergence
   by layer (measured); the TP and the replicated sp 2 engines' step
   times.  (b) granite-moe-3b-a800m at dp 1 x sp 4 (12 layers in
   the default run, 32 under ``--phase tp``), ``params="tp"``, prompts
   of 300 and 450 tokens: every MoE layer's expert-parallel output at
   admission against the float64 plain EP, the rows gather would have
   given differently, every decode gather over the sharded experts bit
   for bit the replicated one's.  (c) The paper's cell over a model axis
   of 2: ``build_prefill_step`` of a 480-token prompt, then 32 steps of
   ``build_mesh_decode_step`` (qwen2.5-3b, B 1, seq_len 512) under
   ``fa3_baseline`` (head-sharded: 2 decode launches a layer, one KV
   head a device), ``paper`` fused (2 partials over 256-row chunks + the
   combine) and ``paper`` auto (one launch at S 4), the ``paper`` arms
   fed ``fa3_baseline``'s greedy stream: plans, launches by key, every
   launch against its plain version, the prefill's and every step's
   embedding, layers (over a dense copy of the cache) and unembedding
   against the replicated weights' on the same input, step times, the
   logits' gap (measured), the arms' own streams held to each other
   while every arm's top-2 logit margin is above 0.1.  (d) ``build_prefill_step`` over a model axis of 3 (16 heads do
   not divide): 3 prefill launches a layer over 128-row chunks at
   q_offset 0 / 128 / 256, each layer bit for bit one whole launch and
   against the float64 plain version.
4k. The ssm family (``phase_ssm``, after 4i): mamba2-780m (48 SSD
   layers, d_model 1536, 48 heads of P 64, N 128) at full width and
   depth, bf16, loop admission of the serving cell's first two prompts,
   16 new tokens, one run (no kernel to check): no kernel launch and no
   policy evaluation in any step.
   On the model's own inputs (512 seeded tokens), at the first and the
   last layer, the chunked scan (two 256-row chunks) against the
   recurrence row by row in float64 (y and the final state within 1e-3
   of its largest entry), and ``Model.prefill``'s layer-0 state against
   512 decode steps of that layer (within 2e-2); peak memory and the
   median step are printed.
4l. Training (``phase_train``, in the default run right after 4j frees
   the serving model; alone as ``--phase train``): (a) qwen2.5-3b at full
   width and depth (36 layers, bf16 weights, f32 AdamW moments) trained
   6 steps (AdamW, constant lr 1e-4 after one warmup step, clip 1.0,
   remat ``nothing_saveable``) on one SyntheticLM batch of 2 x 1024
   tokens, repeated; per step the loss, grad_norm, ms and
   ``torch.cuda.max_memory_allocated``, and the launches (zeroed just
   before the step, read just after): K3 72 (36 forward with its LSE,
   36 recomputed), K3b 36 calls of ``BWD_LAUNCHES_PER_CALL`` launches,
   nothing else.  (b) At step 0 every layer's K3 output and LSE and K3b's
   dq, dk, dv, on the model's own inputs, against the float64 plain
   versions, normwise (``TRAIN_OUT_TOL``, ``TRAIN_LSE_TOL``,
   ``TRAIN_GRAD_TOL``).  (f) The loss after the 6 steps is below step
   0's.  At 2 layers and full width: (c) every gradient leaf against the
   same model whose attention runs the float64 plain forward and
   backward (``TRAIN_LEAF_TOL``); (d) remat ``nothing_saveable`` against
   ``none`` bit for bit, 2 microbatches against 1 (``TRAIN_MICRO_TOL``);
   (e) ``resumable_train_loop`` crashed at step 2 and resumed from the
   step-1 checkpoint (written to a temporary directory, removed after),
   its losses and grad norms bit for bit the uninterrupted run's.  (g) K3
   with its LSE and K3b timed at the training cell, rows of the kernels
   line (K3b's library time: SDPA's forward and backward less its
   forward).
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
   and the prefill kernel at 1024, with that config's launches there;
   phase 4h's shapes: the decode kernel at minicpm3-4b's latent widths
   (G 40, K 288, V 256) and the prefill kernel at its 96 / 64, both
   decode kernels at paligemma-3b's G 8, D 256, H_KV 1, and the prefill
   kernel at its ``Model.prefill`` (B 2, Lq 384); phase 4i's shapes: the
   decode kernel over whisper-large-v3's self cache (G 1, H_KV 20, D 64)
   and its 1500-row cross cache, the prefill kernel as its encoder (non-
   causal, 1500) and its decoder's self and cross prefill run, both
   decode kernels over recurrentgemma-9b's 2048-row ring (G 16, D 256,
   H_KV 1) and the prefill kernel windowed at Lq 2100; phase 4j's shape:
   the combine kernel over 4 partials (S 4, B 1, H_KV 2, G 8, D 128)
   with the sp 4 bf16 run's launches, the first serving launches it
   has, and the decode kernel's and the quantized one's partials-only
   epilogue over one 1024-row chunk at S 1 with the sp 4 runs' launches;
   phase 4m's shapes: the decode kernel over one device's KV head (B 1,
   H_KV 1, G 8, view 512, S 1) and at S 4, its partials over a 256-row
   chunk and the combine kernel over 2 of them, the prefill kernel over
   a 128-row chunk against 384 keys at q_offset 0, 128 and 256, and,
   where 4m(a)'s plans shard the sequence, the combine kernel at B 2 and
   the quantized partials over a 1024-row chunk.
   Every phase prints its wall seconds.

``--phase admission`` times the serving cell's admission
steps alone, five runs on one engine; ``--phase times`` times the
decode op (``ops.decode_attention``, as the model calls it) and the
partials kernel followed by the combine kernel (the route of every
slice before the fused kernel) at the decode shapes of phase 5, the
quantized decode op (``ops.decode_attention_quant``) and the quantized
partials kernel followed by the combine kernel there, over int8 and
fp8, the bf16 prefill kernel at the main path's buckets, beside
SDPA and the timing floor, and K3b at ``BWD_TIME_SHAPES`` (D 64, and
MLA's 96 / 64) beside its plain version, SDPA's backward and its bound.  These two, and ``--phase digests``, use
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
import dataclasses
import cProfile
import functools
import gc
import hashlib
import json
import os
import pstats
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import OptimizerConfig, ServeConfig, \
    ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.fault.elastic import resumable_train_loop  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    build_train_step,
    lm_loss,
    param_tree,
)
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
from repro_torch.kernels import flash_prefill as fprefill  # noqa: E402
from repro_torch.kernels.flash_prefill import (  # noqa: E402
    BWD_LAUNCHES_PER_CALL,
    flash_prefill,
    prefill_plain,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.models import mla as mla_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssd as ssd_mod  # noqa: E402
from repro_torch.models.common import embed_tokens, rms_norm  # noqa: E402
from repro_torch.plan import AttentionSpec, LaunchPlan, Planner  # noqa: E402
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
from repro_torch.serving.scheduler import Scheduler  # noqa: E402
from repro_torch.shard import ShardedServingEngine, ShardSpec  # noqa: E402
from repro_torch.launch.mesh import make_engine_mesh  # noqa: E402
from repro_torch.serving.decode_step import (  # noqa: E402
    build_mesh_decode_step,
    build_prefill_step,
    join_caches,
)
from repro_torch.sharding import place as place_mod  # noqa: E402
from repro_torch.sharding import activation_mesh, device_coords, \
    local_slices  # noqa: E402
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
    # K3b replaces no Pallas kernel: it is the gradient of the function
    # the reference trains through, ref.flash_attention_xla, which XLA
    # differentiates
    "flash_prefill_bwd": "src/repro/kernels/ref.py:97",
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
# K3b's parity shapes, drawn from a generator of their own (seeded
# BWD_PARITY_SEED) after every other parity case, so the cases before
# them keep their inputs: b, lq, lk, hq, hkv, d, dv, window, q_offset,
# causal.  The training cell (several chunks a key block), every width,
# a window, q_offset, cross attention's Lq != Lk; float32 too where the
# forward takes the widths
BWD_PARITY_SEED = 28
BWD_PARITY_CASES = [
    (2, 1024, 1024, 16, 2, 128, 128, None, 0, True),
    (1, 37, 37, 16, 2, 128, 128, None, 0, True),
    (1, 256, 256, 4, 1, 64, 64, 100, 0, True),
    (2, 100, 356, 8, 1, 160, 160, None, 256, True),
    (1, 300, 300, 8, 1, 256, 256, 100, 0, True),
    (1, 256, 256, 8, 8, 96, 64, None, 0, True),
    (1, 200, 1500, 4, 4, 64, 64, None, 0, False),
]
# K3b's widths (D, Dv), and its --phase times shapes beside the training
# cell's: b, l, hq, hkv, d, dv (causal, bf16)
BWD_WIDTHS = ((64, 64), (128, 128), (160, 160), (256, 256), (96, 64))
BWD_TIME_SHAPES = [(2, 1024, 16, 2, 64, 64), (1, 1024, 40, 40, 96, 64)]


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


def tol_ratio(got, want, tol: float) -> float:
    """The largest share of the tolerance an output uses: max |got -
    want| / (tol + tol |want|), 1 at the limit ``max_err`` allows."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (tol + tol * w.abs())).max())


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
    print_bwd_attrs()
    return card, props.multi_processor_count


def print_bwd_attrs() -> None:
    """K3b's two launches at every width and dtype: the registers the
    runtime reports, the dynamic shared memory and threads each launches
    with, and the dk / dv launch's CTAs a chunk (column groups) and CTAs
    an SM.  A checkout without that query prints nothing."""
    if not hasattr(fprefill, "bwd_attrs"):
        return
    for dtype in (torch.bfloat16, torch.float32):
        for d, dv in BWD_WIDTHS:
            a = fprefill.bwd_attrs(d, dv, dtype)
            print(f"K3b {str(dtype)[6:]} ({d}, {dv}): dq {a['dq_registers']} "
                  f"registers {a['dq_shared_bytes']} B dynamic shared, dk / "
                  f"dv {a['dkdv_registers']} registers "
                  f"{a['dkdv_shared_bytes']} B dynamic shared, "
                  f"{a['dkdv_ctas_a_chunk']} CTA(s) a chunk, "
                  f"{a['dkdv_ctas_an_sm']} an SM, {a['threads']} threads a "
                  f"CTA")


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
    errs["flash_prefill_bwd"] = parity_bwd(digests)
    torch.cuda.synchronize()
    print(f"parity max abs errors: {json.dumps(errs)}")
    print(f"parity digests of the main path's {len(digests)} cases: "
          f"{json.dumps(digests)}")
    return errs


def parity_bwd(digests) -> float:
    """K3b at BWD_PARITY_CASES, bf16 and float32, on the forward kernel's
    output and LSE: dq, dk, dv against the float64 plain backward,
    normwise (TRAIN_GRAD_TOL in bf16, 1e-5 in float32), the same bits
    again, and a digest of the three outputs each appended to
    ``digests`` (float32's are the CUDA-core body's; bf16's the
    tensor-core bodies').  Returns the worst normwise error."""
    gen = torch.Generator(device=DEVICE).manual_seed(BWD_PARITY_SEED)
    worst = 0.0
    for b, lq, lk, hq, hkv, d, dv, window, off, causal in BWD_PARITY_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and d != dv:
                continue          # the f32 forward takes equal widths only
            q, k, _ = prefill_case(gen, b, lq, lk, hq, hkv, d, dtype)
            v = rand(gen, (b, lk, hkv, dv), dtype)
            do = rand(gen, (b, lq, hq, dv), dtype)
            kw = dict(causal=causal, window=window, q_offset=off)
            o, lse = fprefill.flash_prefill_lse(q, k, v, **kw)
            got = fprefill.flash_prefill_bwd(q, k, v, o, lse, do, **kw)
            want = fprefill.prefill_backward_plain(
                *(f64(t) for t in (q, k, v, o, lse, do)), **kw)
            tol = TRAIN_GRAD_TOL if dtype == torch.bfloat16 else 1e-5
            errs = [normwise(g, w) for g, w in zip(got, want)]
            label = (f"prefill_bwd {str(dtype)[6:]} B{b} Lq{lq} Lk{lk} "
                     f"heads {hq}/{hkv} D{d}/{dv} window {window} q_offset "
                     f"{off} causal {causal}")
            check(max(errs) <= tol, f"parity {label}: normwise {errs} "
                                    f"(tol {tol})")
            again = fprefill.flash_prefill_bwd(q, k, v, o, lse, do, **kw)
            check(all(torch.equal(a, g) for a, g in zip(again, got)),
                  f"parity {label}: same inputs, other bits")
            digests.append((label, bits(torch.cat([t.reshape(-1)
                                                   for t in got]))))
            worst = max(worst, max(errs))
            print(f"parity {label}: ok, normwise dq {errs[0]:.3e} dk "
                  f"{errs[1]:.3e} dv {errs[2]:.3e}")
    return worst


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


def f64(x):
    """A float tensor in float64, anything else as it is."""
    return x.double() if x.is_floating_point() and x.element_size() > 1 \
        else x


def save_failed(name: str, args, kw) -> None:
    """Save a failed check's inputs to ``chiprun_out/failed_check.pt``."""
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    torch.save({"name": name, "args": [a.cpu() if isinstance(
        a, torch.Tensor) else a for a in args], "kw": kw},
        out / "failed_check.pt")


@contextlib.contextmanager
def checked_kernels(acc):
    """Within the block, every prefill-kernel launch and every decode-
    kernel launch (bf16 or quantized cache) is held against its plain
    version on the same inputs, evaluated in float64: prefill at
    PREFILL_TOL, decode at DECODE_TOL and QUANT_TOL.  float64, because on
    a random model whose K entries reach a few hundred (paligemma-3b's:
    one KV head, so ``wk``'s fan-in rule gives it std 1) scores reach
    thousands, and the float32 plain version's own rounding then moves an
    output past the tolerance of the exact result, while the kernels stay
    inside it.  ``acc`` gathers the largest errors, the largest share of
    the tolerance an output used (``max_tol_ratio``: |got - want| / (tol
    + tol |want|), 1 at the limit) and the number of checks by kernel
    name.  A failing check prints the launch (shapes, kv_len, splits, the
    inputs' largest magnitudes) and the float32 plain version's share of
    the tolerance on the same inputs, and saves the inputs to
    ``chiprun_out/failed_check.pt``.  Each wrapper launches its kernel
    once, so the launch counts are the unchecked path's."""
    for name in ("flash_prefill", "flash_decode", "flash_decode_quant"):
        acc.setdefault(name, {"max_abs_err": 0.0, "max_tol_ratio": 0.0,
                              "checks": 0})

    def note(name, got, want, tol, plain, args, kw):
        try:
            err = max_err(got, want, tol)
        except SmokeFailure:
            f32 = plain(*(x.float() if isinstance(x, torch.Tensor)
                          and x.is_floating_point() and x.element_size() > 1
                          else x for x in args), **kw)
            mags = {i: float(x.float().abs().max()) for i, x in
                    enumerate(args) if isinstance(x, torch.Tensor)
                    and x.is_floating_point()}
            print(f"failed check {name}: shapes "
                  f"{[tuple(x.shape) for x in args if hasattr(x, 'shape')]}"
                  f" {kw}, kv_len "
                  f"{args[-1].tolist() if name != 'flash_prefill' else '-'}"
                  f", largest |input| by argument {mags}; share of the "
                  f"tolerance: kernel {tol_ratio(got, want, tol):.4g}, "
                  f"float32 plain {tol_ratio(f32, want, tol):.4g}")
            save_failed(name, args, kw)
            raise
        acc[name]["max_abs_err"] = max(acc[name]["max_abs_err"], err)
        acc[name]["max_tol_ratio"] = max(acc[name]["max_tol_ratio"],
                                         tol_ratio(got, want, tol))
        acc[name]["checks"] += 1
        return got

    def prefill(q, k, v, **kw):
        return note("flash_prefill", flash_prefill(q, k, v, **kw),
                    prefill_plain(f64(q), f64(k), f64(v), **kw),
                    PREFILL_TOL, prefill_plain, (q, k, v), kw)

    def decode(q, k, v, kv_len, *, num_splits, out_dtype):
        return note("flash_decode", fdec.flash_decode(
            q, k, v, kv_len, num_splits=num_splits, out_dtype=out_dtype),
            fdec.decode_plain(f64(q), f64(k), f64(v), kv_len,
                              num_splits=num_splits), DECODE_TOL,
            fdec.decode_plain, (q, k, v, kv_len),
            {"num_splits": num_splits})

    def decode_quant(q, k, v, k_scale, v_scale, kv_len, *, num_splits,
                     out_dtype):
        return note("flash_decode_quant", fdq.flash_decode_quant(
            q, k, v, k_scale, v_scale, kv_len, num_splits=num_splits,
            out_dtype=out_dtype), fdq.decode_quant_plain(
                f64(q), k, v, f64(k_scale), f64(v_scale), kv_len,
                num_splits=num_splits), QUANT_TOL, fdq.decode_quant_plain,
            (q, k, v, k_scale, v_scale, kv_len), {"num_splits": num_splits})

    with ops_route("flash_prefill", prefill), \
            ops_route("flash_decode", decode), \
            ops_route("flash_decode_quant", decode_quant):
        yield acc


def arch_run(model, params, cfg, prompts, kv_quant=None, new=ARCH_NEW,
             phase="archs", trace=False, layout="dense", checked_run=True):
    """One config's serving cell: the requests (``new`` tokens each)
    through 2 slots with a bf16 cache or under ``kv_quant``, in the
    ``layout`` cache layout, twice on fresh engines, the launch counts
    zeroed just before each run and read just after.  The first run holds
    every layer's prefill attention against ``prefill_plain`` and every
    layer's decode attention against ``decode_plain`` (a quantized cache:
    ``decode_quant_plain``) on the model's own inputs; the second, which
    is timed, must take the same path and give the same streams.  In both
    the decode launches by (view, S) must be what the run's plan keys
    imply.  A model without fused prefill (vlm) admits through the loop:
    no prefill launch, every prompt token a decode step.  Under
    ``kv_quant`` an mla model's latent stays bf16 (no scales), so K1
    decodes it under the int8-keyed plans.  With ``trace`` the timed run
    writes the trace and metrics artifacts (``ServeConfig.trace_path`` /
    ``metrics_path``, under ``chiprun_out/obs/``), which must pass
    ``check_obs_artifacts``.  Without ``checked_run`` (a model that
    launches no kernel, so nothing to check) only the timed run runs."""
    label = (f"{phase} {cfg.name} {kv_quant or 'bf16'}"
             + ("" if layout == "dense" else f" {layout}"))
    layers, side = decode_layers(cfg)
    per_step = layers + sum(side.values())
    # prefill launches an admission: an encdec decoder layer's self and
    # cross attention (its encoder does not run in serving)
    prefills = cfg.num_layers * (2 if cfg.family == "encdec" else 1)
    quant_cache = kv_quant is not None and "k_s" in model.cache_shapes(
        1, 1, kv_quant)
    decode = "flash_decode_quant" if quant_cache else "flash_decode"
    fused = model.supports_fused_prefill
    runs, acc = [], {}
    paths = {}
    if trace:
        OBS_DIR.mkdir(parents=True, exist_ok=True)
        stem = OBS_DIR / f"{cfg.name}_{kv_quant or 'bf16'}"
        paths = dict(trace_path=f"{stem}_trace.json",
                     metrics_path=f"{stem}_metrics.json")
    for name in ("flash_prefill", "flash_decode", "flash_decode_quant"):
        acc[name] = {"max_abs_err": 0.0, "max_tol_ratio": 0.0, "checks": 0}
    for checked in (True, False) if checked_run else (False,):
        sampler = CheckedGreedy()
        engine = ServingEngine(model, ServeConfig(
            model=cfg, kv_quant=kv_quant, cache_layout=layout,
            **({} if checked else paths)),
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
               engine.planned_splits(), "side_splits": {
                   name: p.num_splits
                   for name, p in engine.sched.side_plans().items()},
               "decode_ms": decode_ms,
               "admits": admits, "stats": st.to_json()}
        counts = run["counts"]
        check(bool(sampler.finite.item()), f"{label}: non-finite logits")
        check(counts[decode] == per_step * run["steps"],
              f"{label}: {counts[decode]} {decode} launches over "
              f"{run['steps']} decode steps")
        want = expected_decode_launches(
            engine, layers, kv_quant if quant_cache else None)[decode]
        check(run["by_key"][decode] == want, f"{label}: {decode} launches "
              f"by (view, S) {run['by_key'][decode]}, plan keys imply "
              f"{want}")
        check(counts["flash_prefill"] == prefills * run["admissions"]
              == (prefills * len(prompts) if fused else 0),
              f"{label}: prefill launches")
        other = "flash_decode" if quant_cache else "flash_decode_quant"
        check(counts[other] == 0 and counts["flash_combine"] == 0,
              f"{label}: launches {counts}")
        check(run["evals"] == 0, f"{label}: policy evaluated")
        check(st.misses == st.distinct_buckets, f"{label}: plan misses != "
              f"buckets")
        check([len(c.tokens) for c in done] == [new] * len(prompts)
              and all(c.finish_reason == "length" for c in done),
              f"{label}: completions")
        runs.append(run)
    first, timed_run = runs if checked_run else runs * 2
    counts = first["counts"]
    check(acc[decode]["checks"] == counts[decode]
          and acc["flash_prefill"]["checks"] == counts["flash_prefill"],
          f"{label}: {acc} checks against {first['counts']}")
    for key in ("streams", "counts", "by_key", "splits", "side_splits",
                "stats"):
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
    side_desc = "".join(f", {name} side plan S{s}" for name, s in
                        first["side_splits"].items())
    print(f"{label}: {first['admissions']} admissions, "
          f"{first['steps']} decode steps, launches "
          f"{json.dumps(first['counts'])}, splits {first['splits']}"
          f"{side_desc}, 0 policy evaluations; prefill attention of "
          f"{acc['flash_prefill']['checks']} layer prompts against "
          f"prefill_plain: max abs err "
          f"{acc['flash_prefill']['max_abs_err']:.4g}; decode attention of "
          f"{acc[decode]['checks']} layer steps against "
          f"{'decode_quant_plain' if quant_cache else 'decode_plain'} on the "
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
            "side_splits": first["side_splits"],
            "admission_steps": [{"buckets": bk, "ms": ms}
                                for bk, ms in timed_run["admits"]],
            "decode_step_ms": step_ms, "obs": obs}


def serve_configs(phase: str, cfgs, seed: int, new: int = ARCH_NEW,
                  extra=None, trace=False,
                  runs=((None, "dense"), ("int8", "dense")),
                  prompt_lens=SERVING_PROMPTS, checked_run=True):
    """Each config at its widths, bf16, seeded random weights, one at a
    time: it serves prompts of ``prompt_lens`` tokens (the serving cell's
    37, 300, 450, 1000 unless cut), ``new`` tokens each, 2 slots, once
    per (kv_quant, layout) of ``runs``, by default with a dense bf16 cache
    and under int8 (``arch_run``, its timed runs traced with ``trace``),
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
        if cfg.mla is not None:
            moe_desc += (f" mla {vars(cfg.mla)} (latent decode at H_KV 1: "
                         f"K {mla_mod.latent_width(cfg)}, V "
                         f"{cfg.mla.kv_lora_rank})")
        if cfg.frontend.kind != "none":
            moe_desc += f" frontend {vars(cfg.frontend)} mlp {cfg.mlp_kind}"
        print(f"{phase} model {cfg.name}: {cfg.num_layers} layers d_model "
              f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} "
              f"(G {cfg.q_group_size}) head_dim {cfg.resolved_head_dim} "
              f"d_ff {cfg.d_ff} vocab {cfg.vocab_size} qkv_bias "
              f"{cfg.qkv_bias}{moe_desc} {cfg.param_dtype}: {n_params} "
              f"params, init {time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in prompt_lens]
        res = {"params": n_params, "layers": cfg.num_layers,
               "heads": (cfg.num_heads, cfg.num_kv_heads,
                         cfg.resolved_head_dim)}
        for kv_quant, layout in runs:
            key = (kv_quant or "bf16") + ("" if layout == "dense"
                                          else f"_{layout}")
            res[key] = arch_run(model, params, cfg, prompts, kv_quant, new,
                                phase, trace, layout, checked_run)
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


def phase_archs(seed: int, layers=None):
    """codeqwen1.5-7b and stablelm-12b at full width (``serve_configs``),
    at most ``layers`` deep."""
    return serve_configs("archs", [cut_depth(get_arch(a), layers)
                                   for a in ARCHS], seed)


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


def phase_moe(seed: int, layers=None):
    """The MoE family through ``serve_configs``: granite-moe-3b-a800m at
    full width and depth (16 new tokens a request, its timed runs with
    tracing and metrics on, and the dispatch check), then
    qwen3-moe-235b-a22b at full width with its depth cut to 4 layers (8
    new tokens).  ``layers`` cuts granite's depth too."""
    out = {}
    for arch, cut, new in MOE_ARCHS:
        full = cut is None
        cfg = cut_depth(get_arch(arch), layers if full else cut)
        out.update(serve_configs(
            "moe", [cfg], seed, new, moe_dispatch_check if full else None,
            trace=full))
    return out


# ---------------------------------------------------------------------------
# the single-KV-head families: minicpm3-4b (mla: latent decode at H_KV 1,
# K 288 / V 256, prefill at q / k 96, v 64) and paligemma-3b (vlm: MQA at
# G 8, D 256), both at full width and depth
# ---------------------------------------------------------------------------

MLA_ARCH, VLM_ARCH = "minicpm3-4b", "paligemma-3b"
# the depth the default run serves each path after the main path's at,
# every width kept, so that the whole run stays well inside its 1200 s
# call on a slow host (a phase run alone serves every layer): qwen2.5-3b
# 12 of 36 in the paged, prefix, tune and obs paths; the configs' phases
# as named (recurrentgemma-9b 11 layers: 3 windowed)
DEFAULT_RUN_LAYERS = {"qwen": 12, "archs": 12, "moe": 12, "mla": 12,
                      "vlm": 9, "encdec": 16, "hybrid": 11}


def cut_depth(cfg, layers):
    """``cfg`` with at most ``layers`` layers (an encdec config: decoder
    and encoder), every width kept; ``None`` keeps it whole."""
    if layers is None or layers >= cfg.num_layers:
        return cfg
    kw = {"num_layers": layers}
    if cfg.num_encoder_layers:
        kw["num_encoder_layers"] = min(layers, cfg.num_encoder_layers)
    print(f"{cfg.name}: depth cut from {cfg.num_layers} to {layers} layers "
          f"(every width kept)")
    return cfg.replace(**kw)
VLM_PATCHES, VLM_TEXT, VLM_STEPS = 256, 128, 8   # Model.prefill's check
# paligemma-3b admits through the loop, one decode step a prompt token:
# the serving cell's prompts take 1330 steps a run, four runs about 2.5
# minutes, past the phase's minute; the first two prompts take 315
VLM_PROMPTS = SERVING_PROMPTS[:2]


def policy_splits(label: str, cfg, sms: int, buckets):
    """``paper``'s and ``fa3_baseline``'s splits for the serving cell's
    decode buckets (B 2, ``sms`` SMs) at the plan keys' heads: H_KV 1 for
    both families (MLA's one latent stream, paligemma's MQA), and
    ``resolved_head_dim`` (64 for minicpm3-4b, whose launch reads 288),
    as the reference's plan keys have it."""
    out = {}
    for bucket in sorted(buckets):
        spec = AttentionSpec.decode(2, bucket, cfg.num_heads, 1,
                                    cfg.resolved_head_dim)
        out[bucket] = {pol: Planner(policy=pol, num_cores=sms).plan(
            spec).num_splits for pol in ("paper", "fa3_baseline")}
    print(f"{label}: splits at H_KV 1, B 2, {cfg.num_heads} query heads, "
          "by decode bucket (paper / fa3_baseline): "
          + ", ".join(f"{b}: {v['paper']} / {v['fa3_baseline']}"
                      for b, v in out.items()))
    return out


def phase_mla(seed: int, sms: int, layers=None):
    """minicpm3-4b at full width and depth (62 layers; ``layers`` cuts
    the depth) through ``serve_configs``: bf16 dense, int8 (plans keyed
    int8, the latent bf16, K1 decoding it) and bf16 paged, fused
    admission, every layer's prefill (96 / 64) and latent decode (288 /
    256) attention checked, a profiled decode step at the cell's B 2,
    bucket 1024 shape, then the H_KV 1 splits of ``paper`` beside
    ``fa3_baseline``'s."""
    cfg = cut_depth(get_arch(MLA_ARCH), layers)

    def profile(model, params, cfg):
        return {"profile": phase_profile(model, params, cfg, seed,
                                         lens=(1000, 450))}

    out = serve_configs("mla", [cfg], seed, extra=profile, runs=(
        (None, "dense"), ("int8", "dense"), (None, "paged")))
    res = out[cfg.name]
    res["policy_splits"] = policy_splits(f"mla {cfg.name}", cfg, sms,
                                         res["bf16"]["splits"])
    return out


def vlm_prefill_check(sms: int, seed: int):
    """``extra`` of the vlm phase: ``Model.prefill`` of VLM_PATCHES patch
    embeddings (normal, 0.1) and VLM_TEXT tokens at B 2, then VLM_STEPS
    greedy decode steps from t = L_total under a frozen ``paper`` plan of
    bucket 512, every layer's prefill and decode attention held against
    the plain versions on the model's own inputs; then the same once
    more, unchecked and timed, which must give the same tokens; then
    profiled steps of loop admission (B 2, bucket 128)."""
    def extra(model, params, cfg):
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        b, total = 2, VLM_PATCHES + VLM_TEXT
        (shape, dt), = model.frontend_inputs(b, total).values()
        check(shape == (b, VLM_PATCHES, cfg.frontend.embed_dim)
              and model.text_len(total) == VLM_TEXT, "vlm frontend inputs")
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, VLM_TEXT),
                                         generator=gen, device=DEVICE),
                 "patches": (torch.randn(shape, generator=gen,
                                         device=DEVICE) * 0.1).to(
                     getattr(torch, dt))}
        plan = Planner(policy="paper", num_cores=sms).plan(
            AttentionSpec.decode(b, 512, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.resolved_head_dim), bucket=512)
        runs, acc = [], {}
        for checked in (True, False):
            ops.reset_launch_counts()
            ops.reset_policy_eval_count()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with checked_kernels(acc) if checked \
                    else contextlib.nullcontext():
                logits, caches = model.prefill(params, batch, 512)
                torch.cuda.synchronize()
                prefill_ms = (time.perf_counter() - t0) * 1e3
                toks, finite = [], torch.isfinite(logits).all()
                for i in range(VLM_STEPS):
                    nxt = logits.argmax(-1)
                    toks.append(nxt)
                    logits = model.decode_step(
                        params, caches, nxt, torch.full(
                            (b,), total + i, device=DEVICE,
                            dtype=torch.long), plan=plan)
                    finite &= torch.isfinite(logits).all()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            counts = ops.launch_counts()
            check(bool(finite) and logits.shape == (b, cfg.vocab_size),
                  "vlm prefill: logits")
            check(counts["flash_prefill"] == cfg.num_layers
                  and ops.launch_counts_by_key("flash_prefill")
                  == {("bfloat16", total): cfg.num_layers}
                  and counts["flash_decode"] == cfg.num_layers * VLM_STEPS
                  and ops.policy_eval_count() == 0,
                  f"vlm prefill: launches {counts}")
            runs.append({"tokens": torch.stack(toks).tolist(),
                         "prefill_ms": prefill_ms,
                         "decode_ms": (wall_ms - prefill_ms) / VLM_STEPS,
                         "counts": counts})
        check(runs[0]["tokens"] == runs[1]["tokens"],
              "vlm prefill: the checked and the timed run differ")
        check(acc["flash_prefill"]["checks"] == cfg.num_layers and
              acc["flash_decode"]["checks"] == cfg.num_layers * VLM_STEPS,
              f"vlm prefill: checks {acc}")
        print(f"vlm {cfg.name} Model.prefill: {VLM_PATCHES} patches + "
              f"{VLM_TEXT} tokens at B {b} (Lq {total}, {cfg.num_heads}/"
              f"{cfg.num_kv_heads} heads, D {cfg.resolved_head_dim}), then "
              f"{VLM_STEPS} decode steps (S {plan.num_splits} over bucket "
              f"512): prefill attention of {cfg.num_layers} layers against "
              f"prefill_plain max abs err "
              f"{acc['flash_prefill']['max_abs_err']:.4g}, decode attention "
              f"of {acc['flash_decode']['checks']} layer steps against "
              f"decode_plain max abs err "
              f"{acc['flash_decode']['max_abs_err']:.4g}; the timed run: "
              f"prefill {runs[1]['prefill_ms']:.3f} ms wall, "
              f"{runs[1]['decode_ms']:.3f} ms a decode step")
        # two short prompts: the profiled steps are loop admission's, and
        # the drain after them stays short
        prof = phase_profile(model, params, cfg, seed, lens=(37, 37))
        return {"profile": prof,
                "prefill_check": {"checks": acc, "splits": plan.num_splits,
                                  "prefill_launches": {
                                      f"bfloat16 {total}": cfg.num_layers},
                                  "decode_launches": {
                                      f"{v} S{sp}": n for (v, sp), n in
                                      ops.launch_counts_by_key(
                                          "flash_decode").items()},
                                  "prefill_ms": runs[1]["prefill_ms"],
                                  "decode_step_ms": runs[1]["decode_ms"]}}
    return extra


def phase_vlm(seed: int, sms: int, layers=None):
    """paligemma-3b at full width and depth (18 layers) through
    ``serve_configs``: loop admission (every prompt token a decode step)
    of the serving cell's first two prompts (``VLM_PROMPTS``), bf16 and
    int8, every layer's decode attention checked; then
    ``Model.prefill`` with the patch prefix and decode, and a profiled
    step (``vlm_prefill_check``); then the H_KV 1 splits.  ``layers``
    cuts the depth."""
    cfg = cut_depth(get_arch(VLM_ARCH), layers)
    out = serve_configs("vlm", [cfg], seed,
                        extra=vlm_prefill_check(sms, seed),
                        prompt_lens=VLM_PROMPTS)
    res = out[cfg.name]
    res["policy_splits"] = policy_splits(f"vlm {cfg.name}", cfg, sms,
                                         res["bf16"]["splits"])
    return out


# ---------------------------------------------------------------------------
# decode launches over a length that is not the frozen plan's:
# whisper-large-v3 (encdec: cross attention over a 1500-frame memory) and
# recurrentgemma-9b (hybrid: local attention over a 2048-row ring), both
# at full width and depth
# ---------------------------------------------------------------------------

ENCDEC_ARCH, HYBRID_ARCH = "whisper-large-v3", "recurrentgemma-9b"
SIDE_STEPS = 8                # decode steps after each Model.prefill check
ENCDEC_TEXT = 128             # Model.prefill's tokens beside 1500 frames
HYBRID_TEXT = 2100            # past the 2048-row ring, so the ring wraps
# recurrentgemma-9b admits through the loop, a decode step a prompt token,
# as paligemma-3b does: the serving cell's first two prompts
HYBRID_PROMPTS = SERVING_PROMPTS[:2]


def side_prefill_check(label: str, make_batch, max_len: int, sms: int,
                       prefill_keys, decode_keys):
    """``extra`` of the encdec and hybrid phases: ``Model.prefill`` of
    ``make_batch(model, cfg, gen)`` at B 2 into ``max_len``-row caches,
    then SIDE_STEPS greedy decode steps under the scheduler's frozen
    ``paper`` plans at ``sms`` SMs (the bucket's and the side plans: the
    decode launches over another length take those, and the policy runs
    in none of them), every layer's prefill and decode attention held
    against the plain versions in float64; then the same once more,
    unchecked and timed, which must give the same tokens.  The launches
    by key must be ``prefill_keys(cfg, side)`` and ``decode_keys(cfg,
    side, plan)``; then profiled steps of serving (B 2, two 37-token
    prompts)."""
    def extra(model, params, cfg):
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        b = 2
        batch = make_batch(model, cfg, gen)
        total = batch["tokens"].shape[1]
        sched = Scheduler(cfg, batch_slots=b, max_len=max_len,
                          policy="paper", num_cores=sms)
        plan = sched.decode_plan(total + SIDE_STEPS - 1)
        side = sched.side_plans()
        want_prefill = prefill_keys(cfg)
        want_decode = decode_keys(cfg, side, plan)
        runs, acc = [], {}
        for checked in (True, False):
            ops.reset_launch_counts()
            ops.reset_policy_eval_count()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with checked_kernels(acc) if checked \
                    else contextlib.nullcontext():
                logits, caches = model.prefill(params, batch, max_len)
                torch.cuda.synchronize()
                prefill_ms = (time.perf_counter() - t0) * 1e3
                toks, finite = [], torch.isfinite(logits).all()
                for i in range(SIDE_STEPS):
                    nxt = logits.argmax(-1)
                    toks.append(nxt)
                    logits = model.decode_step(
                        params, caches, nxt, torch.full(
                            (b,), total + i, device=DEVICE,
                            dtype=torch.long), plan=plan, side_plans=side)
                    finite &= torch.isfinite(logits).all()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            by_prefill = ops.launch_counts_by_key("flash_prefill")
            by_decode = ops.launch_counts_by_key("flash_decode")
            check(bool(finite) and logits.shape == (b, cfg.vocab_size),
                  f"{label} prefill: logits")
            check(by_prefill == want_prefill and by_decode == want_decode
                  and ops.launch_counts()["flash_decode_quant"] == 0
                  and ops.policy_eval_count() == 0,
                  f"{label} prefill: launches {by_prefill} / {by_decode}, "
                  f"want {want_prefill} / {want_decode}, "
                  f"{ops.policy_eval_count()} policy evaluations")
            runs.append({"tokens": torch.stack(toks).tolist(),
                         "prefill_ms": prefill_ms,
                         "decode_ms": (wall_ms - prefill_ms) / SIDE_STEPS})
        check(runs[0]["tokens"] == runs[1]["tokens"],
              f"{label} prefill: the checked and the timed run differ")
        check(acc["flash_prefill"]["checks"] == sum(want_prefill.values())
              and acc["flash_decode"]["checks"] == sum(want_decode.values()),
              f"{label} prefill: checks {acc}")
        side_desc = ", ".join(f"{name} S{p.num_splits} over "
                              f"{p.spec.seqlen_k} rows"
                              for name, p in side.items())
        print(f"{label} {cfg.name} Model.prefill: {total} tokens at B {b}, "
              f"then {SIDE_STEPS} decode steps (bucket {plan.bucket} S"
              f"{plan.num_splits}, {side_desc}): prefill attention of "
              f"{acc['flash_prefill']['checks']} launches against "
              f"prefill_plain (float64) max abs err "
              f"{acc['flash_prefill']['max_abs_err']:.4g}, decode attention "
              f"of {acc['flash_decode']['checks']} launches against "
              f"decode_plain (float64) max abs err "
              f"{acc['flash_decode']['max_abs_err']:.4g}; launches by key "
              f"prefill {by_prefill}, decode {by_decode}; 0 policy "
              f"evaluations; the timed run: prefill "
              f"{runs[1]['prefill_ms']:.3f} ms wall, "
              f"{runs[1]['decode_ms']:.3f} ms a decode step")
        prof = phase_profile(model, params, cfg, 0, lens=(37, 37))
        return {"profile": prof,
                "prefill_check": {
                    "checks": acc, "splits": plan.num_splits,
                    "side_splits": {n: p.num_splits
                                    for n, p in side.items()},
                    "prefill_launches": {f"{dt} {lq}": n for (dt, lq), n
                                         in by_prefill.items()},
                    "decode_launches": {f"{v} S{sp}": n for (v, sp), n
                                        in by_decode.items()},
                    "prefill_ms": runs[1]["prefill_ms"],
                    "decode_step_ms": runs[1]["decode_ms"]}}
    return extra


def encdec_batch(model, cfg, gen):
    """ENCDEC_TEXT tokens and 1500 frame embeddings (normal, 0.1) at B
    2, the audio stub's frames."""
    (shape, dt), = model.frontend_inputs(2, ENCDEC_TEXT).values()
    check(shape == (2, cfg.encoder_positions, cfg.d_model),
          "encdec frontend inputs")
    return {"tokens": torch.randint(0, cfg.vocab_size, (2, ENCDEC_TEXT),
                                    generator=gen, device=DEVICE),
            "frames": (torch.randn(shape, generator=gen, device=DEVICE)
                       * 0.1).to(getattr(torch, dt))}


def phase_encdec(seed: int, sms: int, layers=None):
    """whisper-large-v3 at full width and depth (32 + 32 layers) through
    ``serve_configs``: the serving cell's prompts with fused admission,
    bf16, dense and paged (page 64); the cross cache is zero there, as
    in the reference (admission resets the slot), and each decode step
    launches K1 twice a layer, over the self cache at the bucket's plan
    and over the 1500-row cross cache at the cross side plan.  Then
    ``Model.prefill`` of 1500 frames and ENCDEC_TEXT tokens at B 2 and
    SIDE_STEPS decode steps, where the cross launches read the encoder's
    K / V: the encoder's K3 (non-causal, Lq = Lk = 1500), the decoder's
    self and cross K3 and both K1 launches checked layer by layer.
    ``layers`` cuts the depth of the encoder and of the decoder."""
    cfg = cut_depth(get_arch(ENCDEC_ARCH), layers)
    layers = cfg.num_layers

    def prefill_keys(cfg):
        return {("bfloat16", cfg.encoder_positions): cfg.num_encoder_layers,
                ("bfloat16", ENCDEC_TEXT): 2 * layers}

    def decode_keys(cfg, side, plan):
        cross = side["cross"]
        return {(plan.bucket, plan.num_splits): layers * SIDE_STEPS,
                (cross.spec.seqlen_k, cross.num_splits): layers * SIDE_STEPS}

    out = serve_configs("encdec", [cfg], seed, extra=side_prefill_check(
        "encdec", encdec_batch, 256, sms, prefill_keys, decode_keys),
        runs=((None, "dense"), (None, "paged")))
    res = out[cfg.name]
    res["policy_splits"] = side_splits(f"encdec {cfg.name}", cfg, sms,
                                       res["bf16"]["splits"])
    return out


def hybrid_batch(model, cfg, gen):
    """HYBRID_TEXT tokens at B 2: past the 2048-row ring."""
    return {"tokens": torch.randint(0, cfg.vocab_size, (2, HYBRID_TEXT),
                                    generator=gen, device=DEVICE)}


def phase_hybrid(seed: int, sms: int, layers=None):
    """recurrentgemma-9b at full width and depth (38 layers: 26 RG-LRU,
    12 local attention over a 2048-row ring) through ``serve_configs``:
    loop admission (every prompt token a decode step) of the serving
    cell's first two prompts (``HYBRID_PROMPTS``), bf16 and int8 (the
    ring quantized, read by K4); each decode step launches the decode
    kernel once a windowed layer, over the whole ring at the ring side
    plan.  Then ``Model.prefill`` of HYBRID_TEXT tokens at B 2 (windowed
    K3 at Lq 2100, the ring wrapped) and SIDE_STEPS decode steps over the
    wrapped ring, every windowed layer's K3 and K1 checked.  ``layers``
    cuts the depth (the pattern kept: 11 layers hold 3 windowed ones)."""
    cfg = cut_depth(get_arch(HYBRID_ARCH), layers)
    n_attn = lm_mod.layer_kinds(cfg).count("attn_window")

    def prefill_keys(cfg):
        return {("bfloat16", HYBRID_TEXT): n_attn}

    def decode_keys(cfg, side, plan):
        ring = side["ring"]
        return {(ring.spec.seqlen_k, ring.num_splits): n_attn * SIDE_STEPS}

    out = serve_configs("hybrid", [cfg], seed, extra=side_prefill_check(
        "hybrid", hybrid_batch, 4096, sms, prefill_keys, decode_keys),
        prompt_lens=HYBRID_PROMPTS)
    res = out[cfg.name]
    res["policy_splits"] = side_splits(f"hybrid {cfg.name}", cfg, sms,
                                       res["bf16"]["splits"])
    return out


def side_splits(label: str, cfg, sms: int, buckets):
    """``paper``'s and ``fa3_baseline``'s splits at ``sms`` SMs for the
    launches over another length (B 1 and 2: encdec's cross attention
    over the encoder length, a hybrid's windowed layers over the 2048-row
    ring), beside the self-attention buckets' (B 2) a run planned; a
    hybrid has no full-attention layer, so its bucket plans launch
    nothing."""
    out = {"side": {}, "buckets": {}}
    for b in (1, 2):
        for pol in ("paper", "fa3_baseline"):
            sched = Scheduler(cfg, batch_slots=b, max_len=2048, policy=pol,
                              num_cores=sms)
            for name, plan in sched.side_plans().items():
                out["side"].setdefault(f"{name} B{b}", {})[pol] = \
                    plan.num_splits
    for bucket in sorted(buckets):
        spec = AttentionSpec.decode(2, bucket, cfg.num_heads,
                                    cfg.num_kv_heads, cfg.resolved_head_dim)
        out["buckets"][bucket] = {pol: Planner(policy=pol,
                                               num_cores=sms).plan(
            spec).num_splits for pol in ("paper", "fa3_baseline")}
    print(f"{label}: side plans (paper / fa3_baseline): "
          + ", ".join(f"{k}: {v['paper']} / {v['fa3_baseline']}"
                      for k, v in out["side"].items())
          + "; decode buckets at B 2: "
          + ", ".join(f"{k}: {v['paper']} / {v['fa3_baseline']}"
                      for k, v in out["buckets"].items()))
    return out


def library_call(label: str, fn):
    """``fn`` (a PyTorch call computing a row's function) if it runs on
    these inputs, else None, printing why."""
    try:
        fn()
    except RuntimeError as e:
        print(f"library call for {label}: none ({str(e).splitlines()[0]})")
        return None
    return fn


def single_kv_head_rows(gen, sms: int, mla, vlm):
    """The kernels line's rows at the single-KV-head families' shapes,
    each with the launches its serving run counted there: K1 at MLA's
    latent widths (G 40, K 288, V its first 256 columns, B 2, view 1024,
    kv_len [1000, 450], NaN tail, under the plan key's ``paper`` split)
    and K3 at MLA's prefill widths (40 heads, q / k 96, v 64, Lq = Lk =
    1024); paligemma's K1 and K4 at G 8, D 256, H_KV 1 at its serving
    runs' last decode shape (B 2, view 384, kv_len [315, 53], S 1), K1
    at ``Model.prefill``'s decode (view 512, S 3) and K3 at its prefill
    (B 2, Lq = Lk = 384, 8 / 1 heads, D 256).  The MLA decode row's bytes count
    the latent once: V is part of it."""
    rows = []
    cfg = get_arch(MLA_ARCH)
    res = mla[MLA_ARCH]
    hq, w, r = cfg.num_heads, mla_mod.latent_width(cfg), \
        cfg.mla.kv_lora_rank
    s = Planner(policy="paper", num_cores=sms).plan(AttentionSpec.decode(
        2, 1024, hq, 1, cfg.resolved_head_dim)).num_splits
    lat = rand(gen, (2, 2048, 1, w))
    lens = torch.tensor([1000, 450], device=DEVICE, dtype=torch.int32)
    q = (rand(gen, (2, 1, hq, w), torch.float32) * w ** -0.5).to(
        torch.bfloat16)
    kp = poison_tail(lat, lens, float("nan"))[:, :1024]
    k, v = lat[:, :1024], lat[:, :1024, :, :r]
    n = int(lens.sum())
    mask = (torch.arange(1024, device=DEVICE)[None]
            < lens[:, None])[:, None, None]
    rows.append(dict(
        name="flash_decode",
        shape=f"{MLA_ARCH} latent G{hq} K{w} V{r} (a column view) B2 "
              f"view1024 of 2048 kv_len [1000, 450] S{s} fused combine",
        fn=functools.partial(fdec.flash_decode, q, kp, kp[..., :r], lens,
                             num_splits=s),
        plain=functools.partial(fdec.decode_plain, q, k, v, lens,
                                num_splits=s),
        lib=library_call("the MLA latent decode", functools.partial(
            F.scaled_dot_product_attention, q.transpose(1, 2),
            k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            scale=1.0, enable_gqa=True)),
        nbytes=n * w * 2 + q.numel() * 2 + 2 * hq * r * 2,
        flops=2 * n * hq * (w + r),
        err=max_err(fdec.flash_decode(q, kp, kp[..., :r], lens,
                                      num_splits=s),
                    fdec.decode_plain(q, k, v, lens, num_splits=s),
                    DECODE_TOL),
        launches=res["bf16"]["decode_launches"].get(f"1024 S{s}", 0)))
    dqk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
    dv = cfg.mla.v_head_dim
    pq = (rand(gen, (1, 1024, hq, dqk), torch.float32) * dqk ** -0.5).to(
        torch.bfloat16)
    pk, pv = rand(gen, (1, 1024, hq, dqk)), rand(gen, (1, 1024, hq, dv))
    rows.append(dict(
        name="flash_prefill",
        shape=f"{MLA_ARCH} B1 Lq=Lk=1024 Hq{hq} Hkv{hq} Dqk{dqk} Dv{dv} "
              f"causal bf16",
        fn=functools.partial(flash_prefill, pq, pk, pv, causal=True),
        plain=functools.partial(prefill_plain, pq, pk, pv, causal=True),
        lib=library_call("the MLA prefill", functools.partial(
            F.scaled_dot_product_attention,
            *(t.transpose(1, 2) for t in (pq, pk, pv)), is_causal=True,
            scale=1.0)),
        nbytes=2 * (pq.numel() + pk.numel() + 2 * pv.numel()),
        flops=2 * hq * (dqk + dv) * 1024 * 1025 / 2,
        err=max_err(flash_prefill(pq, pk, pv, causal=True),
                    prefill_plain(pq, pk, pv, causal=True), PREFILL_TOL),
        launches=res["bf16"]["prefill_launches"].get("bfloat16 1024", 0)))
    vcfg = get_arch(VLM_ARCH)
    vres = vlm[VLM_ARCH]
    hq, hkv, d = vcfg.num_heads, vcfg.num_kv_heads, vcfg.resolved_head_dim
    lq = VLM_PATCHES + VLM_TEXT
    k, v = (rand(gen, (2, 2048, hkv, d)) for _ in range(2))
    q = rand(gen, (2, hq, d))
    # the serving runs' last decode shape (the 300-token prompt's slot at
    # its last step beside the finished slot's stale 53 rows) and
    # Model.prefill's decode (S3 over bucket 512)
    pre = vres["prefill_check"]
    for bucket, kv_len, s, launches, label in (
            (384, (315, 53), 1, vres["bf16"]["decode_launches"], "serving"),
            (512, (lq + VLM_STEPS,) * 2, pre["splits"],
             pre["decode_launches"], "Model.prefill's decode")):
        c = decode_case(q, k, v, bucket, kv_len, s)
        n = int(c["lens"].sum())
        err, _ = check_decode(c)
        rows.append(dict(
            name="flash_decode",
            shape=f"{VLM_ARCH} {label} G{hq // hkv} D{d} {c['label']} "
                  f"fused combine",
            fn=functools.partial(fdec.flash_decode, c["qp"], c["kp"],
                                 c["vp"], c["lens"], num_splits=s),
            plain=functools.partial(fdec.decode_plain, c["qp"], c["kv"],
                                    c["vv"], c["lens"], num_splits=s),
            lib=c["sdpa"],
            nbytes=2 * n * hkv * d * 2 + 2 * c["qp"].numel() * 2,
            flops=4 * n * hq * d, err=err,
            launches=launches.get(f"{bucket} S{s}", 0)))
    art = Quantizer.from_kv_dtype("int8").quantized_kv(k.float(), v.float())
    qc = quant_case(q, art, 384, (315, 53), 1, "int8")
    n = int(qc["lens"].sum())
    qerr, _ = check_decode_quant(qc)
    rows.append(dict(
        name="flash_decode_quant",
        shape=f"{VLM_ARCH} serving G{hq // hkv} D{d} {qc['label']} fused "
              f"combine",
        fn=functools.partial(fdq.flash_decode_quant, qc["qp"], *qc["pview"],
                             qc["lens"], num_splits=1),
        plain=functools.partial(fdq.decode_quant_plain, qc["qp"],
                                *qc["view"], qc["lens"], num_splits=1),
        lib=None, nbytes=2 * n * hkv * (d + 4) + 2 * qc["qp"].numel() * 2,
        flops=4 * n * hq * d + 2 * n * hkv * d, peak=INT8_OPS_PER_S,
        err=qerr, launches=vres["int8"]["decode_launches"].get("384 S1", 0)))
    pq, pk, pv = prefill_case(gen, 2, lq, lq, hq, hkv, d)
    rows.append(dict(
        name="flash_prefill",
        shape=f"{VLM_ARCH} Model.prefill B2 Lq=Lk={lq} Hq{hq} Hkv{hkv} D{d} "
              f"causal bf16",
        fn=functools.partial(flash_prefill, pq, pk, pv, causal=True),
        plain=functools.partial(prefill_plain, pq, pk, pv, causal=True),
        lib=functools.partial(F.scaled_dot_product_attention,
                              *(t.transpose(1, 2) for t in (pq, pk, pv)),
                              is_causal=True, scale=1.0, enable_gqa=True),
        nbytes=2 * (2 * pq.numel() + pk.numel() + pv.numel()),
        flops=2 * 4 * hq * d * lq * (lq + 1) / 2,
        err=max_err(flash_prefill(pq, pk, pv, causal=True),
                    prefill_plain(pq, pk, pv, causal=True), PREFILL_TOL),
        launches=vres["prefill_check"]["prefill_launches"].get(
            f"bfloat16 {lq}", 0)))
    return rows


def side_shape_rows(gen, sms: int, encdec, hybrid):
    """The kernels line's rows at the shapes of the encdec and hybrid
    phases, each with the launches its runs counted there.  whisper-large-
    v3 (20 / 20 heads, D 64): K1 over the self cache at the serving runs'
    second wave (B 2, view 1024, kv_len [1000, 450]) at its plan's split;
    K1 over the 1500-row cross cache (12 blocks, the last 92 rows: B 2,
    kv_len 1500 each, the cross side plan's S); K3 as the encoder runs it
    (B 2, Lq = Lk = 1500, non-causal); K3 as the decoder's self (causal)
    and cross (Lk 1500, non-causal) prefill run a 1024-token bucket (the
    serving runs count both under Lq 1024, half each).  recurrentgemma-9b
    (16 / 1 heads, D 256): K1 and K4 over the 2048-row ring at the
    serving runs' last decode shape (kv_len [315, 53], the ring side
    plan's S), K1 over the wrapped ring (kv_len 2048 each, the Model.prefill
    check's decode), and K3 windowed (B 2, Lq = Lk = 2100, window 2048,
    causal).  Bytes count each K / V row below kv_len once; the
    windowed K3's operations count the keys each query row attends."""
    rows = []
    cfg = get_arch(ENCDEC_ARCH)
    res = encdec[ENCDEC_ARCH]
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    enc_len = cfg.encoder_positions
    s_self = Planner(policy="paper", num_cores=sms).plan(
        AttentionSpec.decode(2, 1024, hq, hkv, d)).num_splits
    s_cross = res["bf16"]["side_splits"]["cross"]
    k, v = (rand(gen, (2, 2048, hkv, d)) for _ in range(2))
    q = rand(gen, (2, hq, d))
    xk, xv = (rand(gen, (2, enc_len, hkv, d)) for _ in range(2))
    pre = res["prefill_check"]
    for kk, vv, bucket, kv_len, s, launches, label in (
            (k, v, 1024, (1000, 450), s_self,
             res["bf16"]["decode_launches"].get(f"1024 S{s_self}", 0),
             "self"),
            (xk, xv, enc_len, (enc_len, enc_len), s_cross,
             res["bf16"]["decode_launches"].get(f"{enc_len} S{s_cross}", 0)
             + pre["decode_launches"].get(f"{enc_len} S{s_cross}", 0),
             "cross (the 12th KV block holds 92 rows)")):
        c = decode_case(q, kk, vv, bucket, kv_len, s)
        n = int(c["lens"].sum())
        err, _ = check_decode(c)
        rows.append(dict(
            name="flash_decode",
            shape=f"{ENCDEC_ARCH} {label} G{hq // hkv} D{d} Hkv{hkv} "
                  f"{c['label']} fused combine",
            fn=functools.partial(fdec.flash_decode, c["qp"], c["kp"][
                :, :bucket], c["vp"][:, :bucket], c["lens"], num_splits=s),
            plain=functools.partial(fdec.decode_plain, c["qp"], c["kv"],
                                    c["vv"], c["lens"], num_splits=s),
            lib=c["sdpa"],
            nbytes=2 * n * hkv * d * 2 + 2 * c["qp"].numel() * 2,
            flops=4 * n * hq * d, err=err, launches=launches))
    served = res["bf16"]["prefill_launches"].get("bfloat16 1024", 0) // 2
    for b, lq, lk, causal, launches, label in (
            (2, enc_len, enc_len, False,
             pre["prefill_launches"].get(f"bfloat16 {enc_len}", 0),
             "encoder"),
            (1, 1024, 1024, True, served, "decoder self prefill"),
            (1, 1024, enc_len, False, served, "decoder cross prefill")):
        pq, pk, pv = prefill_case(gen, b, lq, lk, hq, hkv, d)
        rows.append(dict(
            name="flash_prefill",
            shape=f"{ENCDEC_ARCH} {label} B{b} Lq={lq} Lk={lk} Hq{hq} "
                  f"Hkv{hkv} D{d} {'causal' if causal else 'non-causal'} "
                  f"bf16",
            fn=functools.partial(flash_prefill, pq, pk, pv, causal=causal),
            plain=functools.partial(prefill_plain, pq, pk, pv,
                                    causal=causal),
            lib=functools.partial(F.scaled_dot_product_attention,
                                  *(t.transpose(1, 2) for t in (pq, pk, pv)),
                                  is_causal=causal, scale=1.0),
            nbytes=2 * (2 * pq.numel() + pk.numel() + pv.numel()),
            flops=4 * b * hq * d * (lq * (lq + 1) / 2 if causal
                                    else lq * lk),
            err=max_err(flash_prefill(pq, pk, pv, causal=causal),
                        prefill_plain(pq, pk, pv, causal=causal),
                        PREFILL_TOL),
            launches=launches))
    cfg = get_arch(HYBRID_ARCH)
    res = hybrid[HYBRID_ARCH]
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    ring = cfg.hybrid.window
    s = res["bf16"]["side_splits"]["ring"]
    pre = res["prefill_check"]
    k, v = (rand(gen, (2, ring, hkv, d)) for _ in range(2))
    q = rand(gen, (2, hq, d))
    for kv_len, launches, label in (
            ((315, 53), res["bf16"]["decode_launches"].get(
                f"{ring} S{s}", 0), "serving"),
            ((ring, ring), pre["decode_launches"].get(f"{ring} S{s}", 0),
             "wrapped ring")):
        c = decode_case(q, k, v, ring, kv_len, s)
        n = int(c["lens"].sum())
        err, _ = check_decode(c)
        rows.append(dict(
            name="flash_decode",
            shape=f"{HYBRID_ARCH} {label} G{hq // hkv} D{d} Hkv{hkv} "
                  f"ring {c['label']} fused combine",
            fn=functools.partial(fdec.flash_decode, c["qp"], c["kp"],
                                 c["vp"], c["lens"], num_splits=s),
            plain=functools.partial(fdec.decode_plain, c["qp"], c["kv"],
                                    c["vv"], c["lens"], num_splits=s),
            lib=c["sdpa"],
            nbytes=2 * n * hkv * d * 2 + 2 * c["qp"].numel() * 2,
            flops=4 * n * hq * d, err=err, launches=launches))
    art = Quantizer.from_kv_dtype("int8").quantized_kv(k.float(), v.float())
    qc = quant_case(q, art, ring, (315, 53), s, "int8")
    n = int(qc["lens"].sum())
    qerr, _ = check_decode_quant(qc)
    rows.append(dict(
        name="flash_decode_quant",
        shape=f"{HYBRID_ARCH} serving G{hq // hkv} D{d} Hkv{hkv} ring "
              f"{qc['label']} fused combine",
        fn=functools.partial(fdq.flash_decode_quant, qc["qp"], *qc["pview"],
                             qc["lens"], num_splits=s),
        plain=functools.partial(fdq.decode_quant_plain, qc["qp"],
                                *qc["view"], qc["lens"], num_splits=s),
        lib=None, nbytes=2 * n * hkv * (d + 4) + 2 * qc["qp"].numel() * 2,
        flops=4 * n * hq * d + 2 * n * hkv * d, peak=INT8_OPS_PER_S,
        err=qerr,
        launches=res["int8"]["decode_launches"].get(f"{ring} S{s}", 0)))
    lq = HYBRID_TEXT
    pq, pk, pv = prefill_case(gen, 2, lq, lq, hq, hkv, d)
    pos = torch.arange(lq, device=DEVICE)
    mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - ring)
    kw = dict(causal=True, window=ring)
    rows.append(dict(
        name="flash_prefill",
        shape=f"{HYBRID_ARCH} Model.prefill B2 Lq=Lk={lq} window {ring} "
              f"Hq{hq} Hkv{hkv} D{d} causal bf16",
        fn=functools.partial(flash_prefill, pq, pk, pv, **kw),
        plain=functools.partial(prefill_plain, pq, pk, pv, **kw),
        lib=functools.partial(F.scaled_dot_product_attention,
                              *(t.transpose(1, 2) for t in (pq, pk, pv)),
                              attn_mask=mask, scale=1.0, enable_gqa=True),
        nbytes=2 * (2 * pq.numel() + pk.numel() + pv.numel()),
        flops=2 * 4 * hq * d * sum(min(i + 1, ring) for i in range(lq)),
        err=max_err(flash_prefill(pq, pk, pv, **kw),
                    prefill_plain(pq, pk, pv, **kw), PREFILL_TOL),
        launches=pre["prefill_launches"].get(f"bfloat16 {lq}", 0)))
    return rows


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


def decode_layers(cfg):
    """A plain decode step's decode launches: (the layers that attend at
    the bucket's plan, {side plan name: the layers that attend under
    it}): encdec's cross attention over its encoder memory, a hybrid's
    windowed layers over their ring (its only attention layers); an ssm
    model attends nowhere."""
    if cfg.family == "hybrid":
        return 0, {"ring": lm_mod.layer_kinds(cfg).count("attn_window")}
    if cfg.family == "encdec":
        return cfg.num_layers, {"cross": cfg.num_layers}
    if cfg.family == "ssm":
        return 0, {}
    return cfg.num_layers, {}


def expected_decode_launches(engine, layers: int, kv_quant=None):
    """The decode-kernel launches a run's plan keys imply, by kernel and
    (view, S): a plain step launches the decode kernel (the quantized
    cache's under ``kv_quant``) once a layer at its bucket's plan, and
    once a layer of ``decode_layers``' side plans at the side plan's
    length and split (encdec's cross cache is bf16 always, so the bf16
    kernel); a verify step of k drafts launches the bf16 decode kernel k
    + 1 times a layer (one per row), at its ("verify", k, bucket)
    plan."""
    plans = dict(engine.sched.plans.items())
    plain = "flash_decode_quant" if kv_quant else "flash_decode"
    want = {plain: {}, "flash_decode": {}}
    side = [(("flash_decode" if name == "cross" else plain), n,
             engine.sched.side_plans()[name])
            for name, n in decode_layers(engine.cfg)[1].items()]

    def add(name, view, s, n):
        by = want[name]
        by[(view, s)] = by.get((view, s), 0) + n

    for key, n in engine.stats.launches.items():
        if isinstance(key, int):
            name, bucket, rows = plain, key, 1
            for kernel, per, plan in side:
                view = plan.spec.seqlen_k
                add(kernel, view, max(1, min(plan.num_splits, view)),
                    per * n)
        elif key[0] == "verify":
            name, bucket, rows = "flash_decode", key[2], key[1] + 1
        else:
            continue
        if layers:
            add(name, bucket, max(1, min(plans[key].plan.num_splits,
                                         bucket)), layers * rows * n)
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
    return kernel_line(out, flush, counts, errs)


def kernel_line(out, flush, counts=None, errs=None):
    """The kernels line's entries of rows ``out`` (each timed here, its
    plain version and library call too, beside its bound); a row without
    ``launches`` / ``err`` / ``tol`` takes ``counts`` / ``errs`` /
    ``TOLS`` by its kernel's name."""
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
            "launches": (row["launches"] if "launches" in row
                         else counts[name]),
            "max_abs_err": row["err"] if "err" in row else errs[name],
            "tol": row["tol"] if "tol" in row else TOLS[name],
            "ms": time_ms(row["fn"], 100, flush),
            "plain_ms": time_ms(row["plain"], 10, flush),
            "bound_ms": bms, "bound_by": by,
            "library_ms": (row["library_ms"] if "library_ms" in row
                           else time_ms(lib, 100, flush) if lib else None),
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
    for b, lq, hq, hkv, d, dv in BWD_TIME_SHAPES:
        label = f"prefill_bwd B{b} Lq=Lk={lq} Hq{hq} Hkv{hkv} D{d}/{dv}"
        out[label] = time_bwd(gen, flush, b, lq, hq, hkv, d, dv, label)
    return out


def time_bwd(gen, flush, b, lq, hq, hkv, d, dv, label, iters: int = 100):
    """K3b at one shape (causal, bf16, the forward kernel's output and
    LSE), its plain version, SDPA's backward (its forward and backward
    less its forward, K / V expanded to the query heads; None where SDPA
    refuses the widths) and the bound, beside K3b's normwise errors
    against float64."""
    q, k, _ = prefill_case(gen, b, lq, lq, hq, hkv, d)
    v = rand(gen, (b, lq, hkv, dv))
    do = rand(gen, (b, lq, hq, dv))
    o, lse = fprefill.flash_prefill_lse(q, k, v, causal=True)
    run = functools.partial(fprefill.flash_prefill_bwd, q, k, v, o, lse, do,
                            causal=True)
    want = fprefill.prefill_backward_plain(
        *(f64(t) for t in (q, k, v, o, lse, do)), causal=True)
    errs = [normwise(g, w) for g, w in zip(run(), want)]
    check(max(errs) <= TRAIN_GRAD_TOL, f"K3b {label}: normwise {errs}")
    leaves = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (
        q, k.repeat_interleave(hq // hkv, dim=2),
        v.repeat_interleave(hq // hkv, dim=2))]
    dos = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(*leaves, is_causal=True,
                                              scale=1.0)
    try:
        sdpa_bwd = (time_ms(lambda: torch.autograd.grad(sdpa(), leaves, dos),
                            iters, flush) - time_ms(sdpa, iters, flush))
    except RuntimeError:
        sdpa_bwd = None
    # five products of 2 * (3 d + 2 dv) flops a visible (query, key)
    # pair; q, k, v, o, do and the LSE read once, dq, dk, dv written once
    flops = 2 * (3 * d + 2 * dv) * b * hq * lq * (lq + 1) / 2
    nbytes = 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                  + 2 * o.numel()) + 4 * lse.numel()
    bms, by = bound(nbytes, flops)
    res = {"kernel_ms": time_ms(run, iters, flush),
           "plain_ms": time_ms(functools.partial(
               fprefill.prefill_backward_plain, q, k, v, o, lse, do,
               causal=True), 10, flush),
           "sdpa_bwd_ms": sdpa_bwd, "bound_ms": bms, "bound_by": by,
           "normwise": errs}
    print(f"{label}: kernel {res['kernel_ms']:.6f} ms, plain "
          f"{res['plain_ms']:.6f} ms, SDPA backward {sdpa_bwd} ms, bound "
          f"{bms:.6f} ms ({by}); normwise dq {errs[0]:.3e} dk {errs[1]:.3e} "
          f"dv {errs[2]:.3e}")
    return res


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


# ---------------------------------------------------------------------------
# the ssm family: mamba2-780m at full width and depth
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-780m"
SSM_PROMPTS = SERVING_PROMPTS[:2]
SSM_CHECK_LEN = 512           # two 256-row chunks: the carry between them
SSM_SCAN_TOL = 1e-3           # chunked f32 scan vs the float64 recurrence
SSM_STATE_TOL = 2e-2          # bf16 prefill's state vs 512 decode steps


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def ssm_numerics(model, params, cfg, seed: int):
    """On the model's own inputs (SSM_CHECK_LEN seeded tokens, B 1): at
    the first and the last SSD layer, ``ssd_chunked`` (f32, two chunks)
    against ``ssd_recurrent`` in float64 on the same operands, y and the
    final state each within SSM_SCAN_TOL of the recurrence's largest
    entry; and ``Model.prefill``'s final state of layer 0 against
    SSM_CHECK_LEN ``apply_ssd_decode`` steps of that layer from a zero
    cache, within SSM_STATE_TOL of its largest entry.  No kernel
    launches."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    tokens = torch.randint(0, cfg.vocab_size, (1, SSM_CHECK_LEN),
                           generator=gen, device=DEVICE)
    s = cfg.ssm
    heads = s.expand * cfg.d_model // s.head_dim
    ops.reset_launch_counts()
    out = {"scan": {}}
    with torch.no_grad():
        x = embed_tokens(params.embed, tokens)
        last = cfg.num_layers - 1
        for li, block in enumerate(params.layers):
            if li in (0, last):
                h = rms_norm(x, block.ln1.scale, cfg.norm_eps)
                _, _, xs, dt, A, B_, C_ = ssd_mod.scan_inputs(block.mix,
                                                              cfg, h)
                xh = xs.float().reshape(1, SSM_CHECK_LEN, heads, s.head_dim)
                y, st = ssd_mod.ssd_chunked(xh, dt, A, B_, C_,
                                            chunk=s.chunk_size)
                y64, st64 = ssd_mod.ssd_recurrent(
                    xh.double(), dt.double(), A.double(), B_.double(),
                    C_.double())
                errs = {"y": rel_err(y, y64), "state": rel_err(st, st64)}
                if max(errs.values()) >= SSM_SCAN_TOL:
                    save_failed("ssd_chunked", (xh, dt, A, B_, C_),
                                {"chunk": s.chunk_size, "layer": li})
                check(max(errs.values()) < SSM_SCAN_TOL,
                      f"ssm layer {li}: chunked scan against the float64 "
                      f"recurrence {errs}")
                out["scan"][li] = errs
            if li < last:
                x, _ = lm_mod.block_prefill(block, cfg, x, None, "bfloat16")
        _, caches = model.prefill(params, {"tokens": tokens},
                                  SSM_CHECK_LEN + 1)
        block = params.layers[0]
        h = rms_norm(embed_tokens(params.embed, tokens), block.ln1.scale,
                     cfg.norm_eps)
        rec = ssd_mod.init_ssd_cache(cfg, 1, torch.bfloat16, DEVICE)
        for i in range(SSM_CHECK_LEN):
            ssd_mod.apply_ssd_decode(block.mix, cfg, h[:, i:i + 1], rec)
        out["state_prefill_vs_decode"] = rel_err(caches["state"][0],
                                                 rec["state"])
    check(out["state_prefill_vs_decode"] < SSM_STATE_TOL,
          f"ssm: Model.prefill's layer-0 state against {SSM_CHECK_LEN} "
          f"decode steps: {out['state_prefill_vs_decode']}")
    check(sum(ops.launch_counts().values()) == 0,
          f"ssm numerics launched {ops.launch_counts()}")
    print(f"ssm {cfg.name}: chunked scan over {SSM_CHECK_LEN} rows "
          f"({SSM_CHECK_LEN // s.chunk_size} chunks) against the float64 "
          f"recurrence (share of the largest entry, tolerance "
          f"{SSM_SCAN_TOL}): {json.dumps(out['scan'])}; Model.prefill's "
          f"layer-0 state against {SSM_CHECK_LEN} decode steps: "
          f"{out['state_prefill_vs_decode']:.4g} (tolerance "
          f"{SSM_STATE_TOL})")
    return {"ssm_numerics": out}


def phase_ssm(seed: int, sms: int):
    """mamba2-780m at full width and depth (48 SSD layers, d_model 1536,
    48 heads of P 64, N 128; bf16) through ``serve_configs``: loop
    admission of the serving cell's first two prompts (SSM_PROMPTS), 2
    slots, ARCH_NEW new tokens, with no kernel launch and no policy
    evaluation in any step (it has no attention, so the serving run runs
    once: no kernel to check); then ``ssm_numerics``."""
    cfg = get_arch(SSM_ARCH)
    out = serve_configs("ssm", [cfg], seed, runs=((None, "dense"),),
                        prompt_lens=SSM_PROMPTS, checked_run=False,
                        extra=functools.partial(ssm_numerics, seed=seed))
    res = out[cfg.name]["bf16"]
    check(sum(res["launches"].values()) == 0,
          f"ssm serving launched {res['launches']}")
    return out


# ---------------------------------------------------------------------------
# mesh-native serving: dp 4 x sp 1 and dp 1 x sp 4 on one card
# ---------------------------------------------------------------------------

SHARD_NEW = 16                # new tokens a request at dp 4
SHARD_SP_LEN = 4000           # the sp 4 prompt
SHARD_SP_MAX = 4096           # its cache: 4 chunks of 1024 rows
SHARD_SP_NEW = 8


def shard_prompts(vocab: int, seed: int):
    """The serving cell's 4 prompts and 4 more seeded ones (20 to 400
    tokens)."""
    rng = np.random.default_rng(seed)
    lens = list(SERVING_PROMPTS) + rng.integers(20, 400, 4).tolist()
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def timed_steps(engine):
    """Step ``engine`` to completion: (the drained completions, the wall
    ms of each step)."""
    ms = []
    while engine.has_work():
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return engine.drain(), ms


@contextlib.contextmanager
def checked_seqsharded(acc):
    """Within the block, every sequence-sharded decode
    (``ops.decode_seqsharded``: one partials launch a shard, then the
    combine) is held against ``decode_plain`` (``decode_quant_plain``)
    over the chunks joined into the whole view, in float64, at
    DECODE_TOL (QUANT_TOL), and its bits against one fused launch of the
    decode kernel at S = shards over that view; the comparison launches
    leave the launch counts as they were."""
    run = ops.decode_seqsharded
    acc.update(checks=0, max_abs_err=0.0, max_tol_ratio=0.0,
               bits_equal=0)

    def checked(q, k, v, kv_len, *, k_scale=None, v_scale=None,
                scale=None):
        out = run(q, k, v, kv_len, k_scale=k_scale, v_scale=v_scale,
                  scale=scale)
        saved = build.LAUNCHES.copy()
        B, Hq, D = q.shape
        n, dev = len(k.chunks), q.device
        kv, vv = k.join(dev), v.join(dev)
        hkv = kv.shape[2]
        sc = D ** -0.5 if scale is None else scale
        qp = (q.float() * sc).to(q.dtype).reshape(B, hkv, Hq // hkv, D)
        if k_scale is None:
            fused = fdec.flash_decode(qp, kv, vv, kv_len, num_splits=n,
                                      out_dtype=q.dtype)
            want = fdec.decode_plain(f64(qp), f64(kv), f64(vv), kv_len,
                                     num_splits=n)
            tol = DECODE_TOL
        else:
            ks, vs = k_scale.join(dev), v_scale.join(dev)
            fused = fdq.flash_decode_quant(qp, kv, vv, ks, vs, kv_len,
                                           num_splits=n, out_dtype=q.dtype)
            want = fdq.decode_quant_plain(f64(qp), kv, vv, f64(ks), f64(vs),
                                          kv_len, num_splits=n)
            tol = QUANT_TOL
        build.LAUNCHES.clear()
        build.LAUNCHES.update(saved)
        got = out.reshape(fused.shape)
        same = torch.equal(got, fused)
        try:
            acc["max_abs_err"] = max(acc["max_abs_err"],
                                     max_err(got, want, tol))
            check(same, "the sharded decode's bits differ from the fused "
                  f"kernel's at S {n}")
        except SmokeFailure:
            save_failed("decode_seqsharded", (q, kv, vv, kv_len) + (
                () if k_scale is None else (ks, vs)), {"shards": n})
            raise
        acc["max_tol_ratio"] = max(acc["max_tol_ratio"],
                                   tol_ratio(got, want, tol))
        acc["bits_equal"] += int(same)
        acc["checks"] += 1
        return out

    ops.decode_seqsharded = checked
    try:
        yield acc
    finally:
        ops.decode_seqsharded = run


def shard_dp4(model, params, cfg, seed: int):
    """dp 4 x sp 1, 2 slots a shard, every shard on the card
    (``devices=[cuda:0] * 4``): the serving cell's 4 prompts and 4 seeded
    ones route [2, 2, 2, 2], and each shard's streams are, bit for bit,
    those of a single-device 2-slot engine fed the requests routed to it
    (same code, shapes and card).  No combine launch (sp 1)."""
    prompts = shard_prompts(cfg.vocab_size, seed)
    reqs = [Request(i, p, max_new_tokens=SHARD_NEW)
            for i, p in enumerate(prompts)]
    eng = ShardedServingEngine(
        model, ServeConfig(model=cfg), spec=ShardSpec(dp=4,
                                                      slots_per_shard=2),
        max_len=2048, sampler=GreedySampler(),
        devices=[torch.device(DEVICE, 0)] * 4)
    eng.load(params)
    for r in reqs:
        eng.submit(r)
    routes = [eng.routed(d) for d in range(4)]
    check([len(r) for r in routes] == [2, 2, 2, 2],
          f"shard dp4: routing {routes}")
    ops.reset_launch_counts()
    ops.reset_policy_eval_count()
    done, ms = timed_steps(eng)
    counts = ops.launch_counts()
    streams = {c.request_id: c.tokens for c in done}
    check(ops.policy_eval_count() == 0, "shard dp4: policy evaluated")
    check(counts["flash_combine"] == 0, f"shard dp4: launches {counts}")
    check(all(len(t) == SHARD_NEW for t in streams.values()),
          "shard dp4: completions")
    for d in range(4):
        oracle = ServingEngine(model, ServeConfig(model=cfg), max_len=2048,
                               batch_slots=2, sampler=GreedySampler(),
                               device=DEVICE)
        oracle.load(params)
        for i in routes[d]:
            oracle.submit(reqs[i])
        want = {c.request_id: c.tokens for c in oracle.drain()}
        check(all(streams[i] == want[i] for i in routes[d]),
              f"shard dp4: shard {d}'s streams differ from its "
              f"single-device oracle's")
        check(eng.cores[d].planned_splits() == oracle.planned_splits(),
              f"shard dp4: shard {d}'s splits")
    agg = eng.aggregate_stats()
    res = {"routes": routes, "launches": counts,
           "step_ms": median(ms), "steps": len(ms),
           "total_launches": agg["total_launches"],
           "splits": eng.planned_splits()}
    print(f"shard dp4 x sp1 {cfg.name}: routes {routes}, every shard's "
          f"streams equal its single-device oracle's bit for bit, "
          f"launches {json.dumps(counts)}, splits {res['splits']}; median "
          f"step (all 4 shards) {res['step_ms']:.3f} ms over {len(ms)} "
          f"steps")
    return res


def shard_sp4(model, params, cfg, seed: int, kv_quant=None):
    """dp 1 x sp 4 (``devices=[cuda:0] * 4``), max_len SHARD_SP_MAX, one
    SHARD_SP_LEN-token prompt, SHARD_SP_NEW new tokens, with a bf16 cache
    or under ``kv_quant``: every decode plan carries mesh_splits 4 and
    the grid; each layer of each decode step launches the decode kernel's
    partials (the quantized one's under int8) 4 times at (1024, 1) and
    the combine once (``checked_seqsharded``: each against the plain
    version in float64 and bit for bit against the fused kernel at S 4);
    the prefill launches are checked as ``checked_kernels`` does."""
    label = f"shard dp1 x sp4 {cfg.name} {kv_quant or 'bf16'}"
    rng = np.random.default_rng(seed + 4)
    prompt = rng.integers(0, cfg.vocab_size, SHARD_SP_LEN).tolist()
    eng = ShardedServingEngine(
        model, ServeConfig(model=cfg, kv_quant=kv_quant),
        spec=ShardSpec(sp=4, slots_per_shard=1), max_len=SHARD_SP_MAX,
        sampler=GreedySampler(), devices=[torch.device(DEVICE, 0)] * 4)
    eng.load(params)
    core = eng.cores[0]
    part = "flash_decode_quant" if kv_quant else "flash_decode"
    acc, kacc = {}, {}
    eng.submit(Request(0, prompt, max_new_tokens=SHARD_SP_NEW))
    ops.reset_launch_counts()
    ops.reset_policy_eval_count()
    with checked_seqsharded(acc), checked_kernels(kacc):
        done, ms = timed_steps(eng)
    counts = ops.launch_counts()
    by_key = ops.launch_counts_by_key(part)
    plans = {k: e.plan for k, e in core.sched.plans.items()
             if isinstance(k, int)}
    steps = sum(core.stats.launches[k] for k in plans)
    L = cfg.num_layers
    check(plans and all(p.mesh_splits == 4 and p.seq_shard_mesh is not None
                        for p in plans.values()),
          f"{label}: decode plans {[p.describe() for p in plans.values()]}")
    check(by_key == {(SHARD_SP_MAX // 4, 1): 4 * L * steps}
          and counts[part] == 4 * L * steps,
          f"{label}: {part} launches {by_key} over {steps} steps")
    check(counts["flash_combine"] == L * steps,
          f"{label}: {counts['flash_combine']} combine launches over "
          f"{steps} steps")
    check(acc["checks"] == L * steps and acc["bits_equal"] == acc["checks"],
          f"{label}: sharded decode checks {acc}")
    check(kacc["flash_prefill"]["checks"] == counts["flash_prefill"] == L,
          f"{label}: prefill checks {kacc}")
    check(ops.policy_eval_count() == 0, f"{label}: policy evaluated")
    check(len(done[0].tokens) == SHARD_SP_NEW, f"{label}: completion")
    decode_ms = ms[1:]               # the first step admits the prompt
    res = {"steps": steps, "launches": counts,
           "partials_launches": {f"{v} S{s}": n
                                 for (v, s), n in by_key.items()},
           "plans": {k: p.describe() for k, p in plans.items()},
           "checks": acc, "prefill_checks": kacc["flash_prefill"],
           "admission_ms": ms[0], "decode_step_ms": median(decode_ms)}
    keys = [(k, p.mesh_splits, p.num_splits) for k, p in plans.items()]
    print(f"{label}: plans {keys} (bucket, mesh_splits, num_splits); "
          f"{steps} decode steps, "
          f"launches {json.dumps(counts)}, {part} by (view, S) "
          f"{res['partials_launches']}; {acc['checks']} layer steps "
          f"against the float64 plain version: max abs err "
          f"{acc['max_abs_err']:.4g} (share of the tolerance "
          f"{acc['max_tol_ratio']:.4g}), {acc['bits_equal']} bit for bit "
          f"the fused kernel's at S 4; prefill max abs err "
          f"{kacc['flash_prefill']['max_abs_err']:.4g}; admission "
          f"{ms[0]:.3f} ms, median decode step {res['decode_step_ms']:.3f}"
          f" ms over {len(decode_ms)} steps")
    return res


def shard_kernel_rows(gen, sms: int, shard):
    """The kernels line's rows of the sequence-sharded path, at its shape
    (B 1, H_KV 2, G 8, D 128, 4 shards of 1024 rows, kv_len 4000): the
    combine kernel over 4 partials, the decode kernel's and the quantized
    one's partials-only epilogue over one 1024-row chunk at one split,
    each with its launches of the sp 4 runs (bf16; int8)."""
    hkv, g, d, n, c = 2, 8, 128, 4, SHARD_SP_MAX // 4
    hq = hkv * g
    q = rand(gen, (1, hkv, g, d))
    k = rand(gen, (1, SHARD_SP_MAX, hkv, d))
    v = rand(gen, (1, SHARD_SP_MAX, hkv, d))
    lens = torch.tensor([SHARD_SP_LEN], device=DEVICE, dtype=torch.int32)
    parts = [flash_decode_partials(q, k[:, i * c:(i + 1) * c],
                                   v[:, i * c:(i + 1) * c],
                                   (lens - i * c).clamp(0, c), num_splits=1)
             for i in range(n)]
    acc, l, m = (torch.cat(x) for x in zip(*parts))
    want = fdec.decode_plain(f64(q), f64(k), f64(v), lens, num_splits=n)
    qz = Quantizer.from_kv_dtype("int8")
    kq, ks = qz.quantize(k)
    vq, vs = qz.quantize(v)
    k0, v0 = k[:, :c], v[:, :c]
    rows = [dict(
        name="flash_combine",
        shape=f"S{n} B1 Hkv{hkv} G{g} D{d} sequence-sharded merge",
        fn=lambda: flash_combine(acc, l, m, out_dtype=torch.bfloat16),
        plain=lambda: combine_plain(acc, l, m, out_dtype=torch.bfloat16),
        lib=None, nbytes=n * hkv * g * (d + 2) * 4 + hq * d * 2,
        flops=6 * n * hq * d,
        err=max_err(flash_combine(acc, l, m, out_dtype=torch.bfloat16),
                    want, DECODE_TOL),
        launches=shard["sp4_bf16"]["launches"]["flash_combine"]), dict(
        name="flash_decode",
        shape=f"B1 view {c} S1 Hkv{hkv} G{g} D{d} partials only, one "
              f"shard of 4",
        fn=functools.partial(flash_decode_partials, q, k0, v0, lens.clamp(
            max=c), num_splits=1),
        plain=functools.partial(fdec.decode_partials_plain, q, k0, v0,
                                lens.clamp(max=c), num_splits=1),
        lib=None, nbytes=2 * c * hkv * d * 2 + q.numel() * 2
        + hkv * g * (d + 2) * 4, flops=4 * c * hkv * g * d,
        err=max_err(combine_plain(acc, l, m, out_dtype=torch.float32),
                    want, DECODE_TOL),
        launches=shard["sp4_bf16"]["launches"]["flash_decode"]), dict(
        name="flash_decode_quant",
        shape=f"B1 view {c} S1 Hkv{hkv} G{g} D{d} int8 partials only, "
              f"one shard of 4",
        fn=functools.partial(flash_decode_quant_partials, q, kq[:, :c],
                             vq[:, :c], ks[:, :c], vs[:, :c],
                             lens.clamp(max=c), num_splits=1),
        plain=functools.partial(decode_quant_partials_plain, q, kq[:, :c],
                                vq[:, :c], ks[:, :c], vs[:, :c],
                                lens.clamp(max=c), num_splits=1),
        lib=None, nbytes=2 * c * hkv * (d + 4) + q.numel() * 2
        + hkv * g * (d + 2) * 4,
        flops=4 * c * hkv * g * d + 2 * c * hkv * d, peak=INT8_OPS_PER_S,
        err=max_err(combine_plain(*flash_decode_quant_partials(
            q, kq, vq, ks, vs, lens, num_splits=n),
            out_dtype=torch.float32), fdq.decode_quant_plain(
            f64(q), kq, vq, f64(ks), f64(vs), lens, num_splits=n),
            QUANT_TOL),
        launches=shard["sp4_int8"]["launches"]["flash_decode_quant"])]
    return rows


def phase_shard(model, params, cfg, seed: int):
    """Mesh-native serving of qwen2.5-3b at full width and depth on the
    card: ``shard_dp4`` (bf16), then ``shard_sp4`` with a bf16 cache and
    under int8."""
    return {"dp4": shard_dp4(model, params, cfg, seed),
            "sp4_bf16": shard_sp4(model, params, cfg, seed),
            "sp4_int8": shard_sp4(model, params, cfg, seed,
                                  kv_quant="int8")}


# ---------------------------------------------------------------------------
# tensor- and expert-parallel serving, the frozen mesh step builders
# ---------------------------------------------------------------------------


TP_NEW = 16                    # new tokens a request in (a) and (b)
TP_PROMPTS = (300, 1000)       # (a): the serving cell's prompts
EP_PROMPTS = (300, 450)        # (b): buckets 384 and 512, both / 4
CELL_PROMPT, CELL_SEQ, CELL_STEPS = 480, 512, 32   # (c)
CELL_MARGIN = 0.1              # (c): streams agree while top-2 logits
                               # stay this far apart in every arm
SEQPAR_LEN, SEQPAR_AXIS = 384, 3   # (d): 16 heads do not divide 3
PREFILL_ROW_TILE = 64          # the prefill kernel's query rows a CTA


def tp_devices(n: int):
    """A grid of ``n`` devices on the one card."""
    return [torch.device(DEVICE, 0)] * n


def copy_leaf(leaf):
    """A copy of a cache leaf (a tensor or a sequence / head chunking)."""
    if isinstance(leaf, ops.Shards):
        return type(leaf)([c.clone() for c in leaf.chunks], leaf.dim)
    return leaf.clone()


def spec_param_bytes(params, mesh):
    """Each device's weight bytes by ``spec_for``'s slices over ``mesh``:
    its slice of every cut dim, the whole of every other."""
    specs = place_mod.param_specs(params, mesh)
    n = mesh.shape["model"]
    out = [0] * n
    for name, t in params.state_dict().items():
        for s in range(n):
            sl = local_slices(tuple(t.shape), specs[name], mesh,
                              device_coords(mesh, s))
            out[s] += int(np.prod([ln for _, ln in sl])) * t.element_size()
    return out


F32_UNIT = 2.0 ** -24           # f32 unit roundoff


@contextlib.contextmanager
def checked_tp_layers(tp, params, acc, dense: bool = False):
    """Within the block, every piece of the placed tree ``tp`` that runs
    is held against the same piece of the replicated weights ``params``
    on the same input: the embedding bit for bit (a masked lookup a
    device, the parts summed with zeros); each block (prefill or decode)
    on a copy of the same cache, max |got - want| within DECODE_TOL of
    the block output's largest magnitude (normwise: the residual stream
    sums bf16 terms of tens, so an output near zero carries their
    rounding, which an elementwise relative bound would charge to it);
    the unembedding's f32 logits within 2 d u (|x| |W|) elementwise,
    twice the worst case of an f32 sum of d products (u = 2^-24).  With
    ``dense``, the replicated block decodes a dense copy of the cache
    (sharded leaves joined) under a one-launch plan, so that a step over
    a head- or sequence-sharded cache is held against the unsharded one.
    The comparison's launches leave the counts as they were (its kernel
    calls are still held to their plain versions by any enclosing
    check)."""
    ref = {id(b): o for b, o in zip(tp.layers, params.layers)}
    dec, pre = lm_mod.block_decode, lm_mod.block_prefill
    emb, unemb = lm_mod.embed_tokens, lm_mod.unembed
    acc.update(checks=0, max_abs_err=0.0, max_tol_ratio=0.0,
               embed_checks=0, unembed_checks=0, unembed_max_tol_ratio=0.0)

    def quiet(fn, *a, **kw):
        saved = build.LAUNCHES.copy()
        out = fn(*a, **kw)
        build.LAUNCHES.clear()
        build.LAUNCHES.update(saved)
        return out

    def note(got, want):
        g, w = got.float(), want.float()
        check(bool(torch.isfinite(g).all()), "non-finite layer output")
        err = float((g - w).abs().max())
        limit = DECODE_TOL * max(1.0, float(w.abs().max()))
        check(err <= limit, f"layer output max abs err {err:.4g} over "
              f"{limit:.4g}")
        acc["max_abs_err"] = max(acc["max_abs_err"], err)
        acc["max_tol_ratio"] = max(acc["max_tol_ratio"], err / limit)
        acc["checks"] += 1

    def block_decode(block, cfg, x, cache, t, rope, **kw):
        other = ref.get(id(block))
        if other is None:
            return dec(block, cfg, x, cache, t, rope, **kw)
        rkw = kw
        if dense:
            copy = {n: leaf.join(x.device) if isinstance(leaf, ops.Shards)
                    else leaf.clone() for n, leaf in cache.items()}
            rkw = dict(kw, plan=LaunchPlan(num_splits=1))
        else:
            copy = {n: copy_leaf(leaf) for n, leaf in cache.items()}
        out = dec(block, cfg, x, cache, t, rope, **kw)
        note(out, quiet(dec, other, cfg, x, copy, t, rope, **rkw))
        return out

    def block_prefill(block, cfg, x, rope, kv_dtype, ring=None):
        other = ref.get(id(block))
        out = pre(block, cfg, x, rope, kv_dtype, ring)
        if other is not None:
            note(out[0], quiet(pre, other, cfg, x, rope, kv_dtype,
                               ring)[0])
        return out

    def embed_tokens_checked(p, tokens):
        out = emb(p, tokens)
        if p is tp.embed:
            check(torch.equal(out, emb(params.embed, tokens)),
                  "the placed embedding differs from the replicated one")
            acc["embed_checks"] += 1
        return out

    def unembed_checked(p, x):
        out = unemb(p, x)
        if p is tp.embed:
            e = params.embed
            w = e.unembed if "unembed" in e.specs else e.tok.T
            want = unemb(e, x)
            bound = 2 * x.shape[-1] * F32_UNIT * (x.float().abs()
                                                 @ w.float().abs())
            ratio = float(((out - want).abs() / bound.clamp_min(
                torch.finfo(torch.float32).tiny)).max())
            check(ratio <= 1.0, f"unembedding off the replicated one by "
                  f"{ratio:.4g} of twice the f32 sum's bound")
            acc["unembed_checks"] += 1
            acc["unembed_max_tol_ratio"] = max(
                acc["unembed_max_tol_ratio"], ratio)
        return out

    lm_mod.block_decode, lm_mod.block_prefill = block_decode, block_prefill
    lm_mod.embed_tokens, lm_mod.unembed = embed_tokens_checked, \
        unembed_checked
    try:
        yield acc
    finally:
        lm_mod.block_decode, lm_mod.block_prefill = dec, pre
        lm_mod.embed_tokens, lm_mod.unembed = emb, unemb


class RecordingSampler(GreedySampler):
    """Greedy sampling that keeps every call's logits and tokens in
    ``calls``; with ``forced`` (another run's ``calls``), call j returns
    that run's call-j tokens instead of its own argmax: teacher forcing,
    so an engine scores another engine's token streams step for step
    (the schedule, which follows the token counts alone, is the same)."""

    def __init__(self, forced=None):
        self.calls, self.forced = [], forced

    def sample(self, logits, state, pos):
        tok = super().sample(logits, state, pos)
        if self.forced is not None:
            tok = self.forced[len(self.calls)][1].to(tok.device)
        self.calls.append((logits, tok))
        return tok


def tp_engine(model, cfg, params, sp: int, policy: str, kv_quant=None,
              max_len: int = 2048, sampler=None):
    eng = ShardedServingEngine(
        model, ServeConfig(model=cfg, kv_quant=kv_quant),
        spec=ShardSpec(sp=sp, slots_per_shard=2, params=policy),
        max_len=max_len, sampler=sampler or GreedySampler(),
        devices=tp_devices(sp))
    eng.load(params)
    return eng


def depth_divergence(model, tp, params, tokens, max_len: int):
    """How far the placed tree ``tp``'s prefill of ``tokens`` (1, L) lies
    from the replicated weights' after each layer: ||got - want|| /
    ||want|| of the layer output (measured, not held): where each layer
    on the same input lies within DECODE_TOL, the gap a layer passes on
    grows with the depth on random weights."""
    outs, pre = {}, lm_mod.block_prefill
    for key, p in (("tp", tp), ("replicated", params)):
        got = []

        def block_prefill(*a, **kw):
            out = pre(*a, **kw)
            got.append(out[0].float())
            return out

        lm_mod.block_prefill = block_prefill
        try:
            model.prefill(p, {"tokens": tokens}, max_len)
        finally:
            lm_mod.block_prefill = pre
        outs[key] = got
    return [float((g - w).norm() / w.norm())
            for g, w in zip(outs["tp"], outs["replicated"])]


def tp_serving(model, params, cfg, seed: int, kv_quant=None):
    """(a) qwen2.5-3b at dp 1 x sp 2, ``params="tp"``, max_len 2048, the
    serving cell's 300- and 1000-token prompts, TP_NEW new tokens: each
    device's weight bytes against ``spec_for``'s slices; a checked run
    fed the replicated sp 2 engine's greedy streams (so that it runs the
    same admissions and steps on the same tokens), in which the
    embedding, every layer and the unembedding of every admission and
    step are held against the replicated weights' on the same input
    (``checked_tp_layers``), every sequence-sharded decode against the
    float64 plain version and the fused kernel's bits at S 2, every
    other decode and prefill launch against its plain version; whose
    decode launches follow its plans (a plan with ``mesh_splits`` 2: 2
    partials at (1024, S1) and 1 combine a layer and step; one with 1:
    one launch a layer over the chunks joined on the lead, at the plan's
    (bucket, S)) and whose policy evaluations are 0; how far its logits
    lie from the replicated engine's (``logits_apart``); then one
    unchecked run each of the TP and the replicated sp 2 engines, timed
    step by step."""
    label = f"tp dp1 x sp2 {cfg.name} {kv_quant or 'bf16'}"
    rng = np.random.default_rng(seed + 26)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in TP_PROMPTS]
    reqs = [Request(i, p, max_new_tokens=TP_NEW)
            for i, p in enumerate(prompts)]
    rec = RecordingSampler()
    rep = tp_engine(model, cfg, params, 2, "replicated", kv_quant,
                    sampler=rec)
    for r in reqs:
        rep.submit(r)
    timed_steps(rep)
    del rep
    forced = RecordingSampler(forced=rec.calls)
    eng = tp_engine(model, cfg, params, 2, "tp", kv_quant, sampler=forced)
    core = eng.cores[0]
    tp = core._params
    held = place_mod.device_param_bytes(tp)
    want_bytes = spec_param_bytes(params, core.mesh)
    check(held == want_bytes, f"{label}: device weight bytes {held}, "
          f"spec_for's slices {want_bytes}")
    part = "flash_decode_quant" if kv_quant else "flash_decode"
    lacc, sacc, kacc = {}, {}, {}
    for r in reqs:
        eng.submit(r)
    ops.reset_launch_counts()
    ops.reset_policy_eval_count()
    with checked_tp_layers(tp, params, lacc), checked_seqsharded(sacc), \
            checked_kernels(kacc):
        done, _ = timed_steps(eng)
    counts = ops.launch_counts()
    by_key = ops.launch_counts_by_key(part)
    plans = {k: e.plan for k, e in core.sched.plans.items()
             if isinstance(k, int)}
    steps = sum(core.stats.launches[k] for k in plans)
    sharded = sum(core.stats.launches[k] for k, p in plans.items()
                  if p.mesh_splits > 1)
    L = cfg.num_layers
    want = {}
    for k, p in plans.items():
        key = (1024, 1) if p.mesh_splits > 1 else (p.bucket, p.num_splits)
        n = core.stats.launches[k] * L * (2 if p.mesh_splits > 1 else 1)
        if n:
            want[key] = want.get(key, 0) + n
    # the whole-view launches by (bucket, S): the kernels line times them
    whole = {}
    for k, p in plans.items():
        if p.mesh_splits == 1:
            key = f"{p.bucket} S{p.num_splits}"
            whole[key] = whole.get(key, 0) + core.stats.launches[k] * L
    check(by_key == want and counts["flash_combine"] == L * sharded,
          f"{label}: {part} launches {by_key} (want {want}), combine "
          f"{counts['flash_combine']} over {steps} steps, plans "
          f"{[p.describe() for p in plans.values()]}")
    check(ops.policy_eval_count() == 0, f"{label}: policy evaluated")
    admissions = len(reqs)
    check(lacc["checks"] == L * (steps + admissions)
          and lacc["embed_checks"] == steps + admissions
          and lacc["unembed_checks"] == steps + admissions,
          f"{label}: layer checks {lacc}")
    # the layer checks' replicated runs are checked too: twice each
    check(sacc["checks"] == 2 * L * sharded
          and sacc["bits_equal"] == sacc["checks"]
          and kacc[part]["checks"] == 2 * L * (steps - sharded),
          f"{label}: decode checks {sacc} {kacc[part]}")
    check(all(len(c.tokens) == TP_NEW for c in done),
          f"{label}: completions")
    apart = logits_apart([w for w, _ in rec.calls],
                         [g for g, _ in forced.calls], label)
    del rec, forced
    with activation_mesh(core.mesh):
        depth = depth_divergence(model, tp, params, torch.tensor(
            [prompts[0]], device=DEVICE), 512)
    runs = {}
    for policy in ("tp", "replicated"):
        e = tp_engine(model, cfg, params, 2, policy, kv_quant)
        for r in reqs:
            e.submit(r)
        got, ms = timed_steps(e)
        runs[policy] = {"streams": {c.request_id: c.tokens for c in got},
                        "admission_ms": ms[:admissions],
                        "decode_step_ms": median(ms[admissions:])}
    same = sum(runs["tp"]["streams"][i] == runs["replicated"]["streams"][i]
               for i in range(len(reqs)))
    res = {"device_param_bytes": held, "steps": steps,
           "sharded_steps": sharded, "launches": counts,
           "whole_launches": whole,
           "plans": {k: p.describe() for k, p in plans.items()},
           "partials_launches": {f"{v} S{s}": n
                                 for (v, s), n in by_key.items()},
           "layer_checks": lacc, "logits_apart": apart,
           "depth_divergence": depth,
           "seqsharded_checks": sacc,
           "prefill_checks": kacc["flash_prefill"],
           "decode_step_ms": runs["tp"]["decode_step_ms"],
           "replicated_decode_step_ms":
               runs["replicated"]["decode_step_ms"],
           "admission_ms": runs["tp"]["admission_ms"],
           "replicated_admission_ms": runs["replicated"]["admission_ms"],
           "streams_equal_replicated": same}
    whole = sum(t.numel() * t.element_size() for t in params.parameters())
    keys = [(k, p.mesh_splits, p.num_splits) for k, p in plans.items()]
    print(f"{label}: weight bytes a device {held} (spec_for's slices; the "
          f"unplaced weights {whole}); plans {keys} (bucket, mesh_splits, "
          f"num_splits); {steps} decode steps "
          f"({sharded} sequence-sharded), launches {json.dumps(counts)}, "
          f"{part} by (view, S) {res['partials_launches']}; "
          f"{lacc['checks']} "
          f"layers against the replicated weights' on the same input: max "
          f"abs err {lacc['max_abs_err']:.4g} (share of {DECODE_TOL}: "
          f"{lacc['max_tol_ratio']:.4g}); {sacc['checks']} sharded decodes"
          f" (max abs err {sacc['max_abs_err']:.4g}, bit for bit the "
          f"fused kernel's at S 2) and {kacc[part]['checks']} whole-view "
          f"decodes (max abs err {kacc[part]['max_abs_err']:.4g}) against"
          f" the float64 plain version; {lacc['embed_checks']} "
          f"embeddings bit for bit and {lacc['unembed_checks']} "
          f"unembeddings within {lacc['unembed_max_tol_ratio']:.4g} of "
          f"the f32 bound; fed the replicated engine's streams, its "
          f"logits {apart['max_rel']:.4g} of the largest apart at worst, "
          f"argmax equal on {apart['argmax_equal']} of {apart['rows']} "
          f"rows (not held: the depth multiplies rounding; a "
          f"{TP_PROMPTS[0]}-token prefill's layer outputs lie apart by "
          f"{', '.join(f'{x:.3g}' for x in depth[:3])} ... "
          f"{depth[-1]:.3g} of their norm after layers 1, 2, 3 ... "
          f"{len(depth)}); "
          f"median decode step "
          f"{res['decode_step_ms']:.3f} ms (the "
          f"replicated sp 2 engine's {res['replicated_decode_step_ms']:.3f}"
          f" ms); {same} of {len(reqs)} streams equal the replicated "
          f"engine's")
    return res


def ep_serving(seed: int, layers=None):
    """(b) granite-moe-3b-a800m at full width (``layers`` deep) at dp 1 x
    sp 4, ``params="tp"`` (10 experts a device), the serving cell's first
    two prompts (buckets 384 and 512, both divisible by 4), TP_NEW new
    tokens: every MoE layer's expert-parallel output at admission against
    the float64 plain EP on the same input at PREFILL_TOL (and the rows
    gather would have given differently counted); every decode step's
    gather over the sharded experts bit for bit the replicated gather's."""
    cfg = cut_depth(get_arch("granite-moe-3b-a800m"), layers)
    model = build_model(cfg, device=DEVICE)
    params = model.init_params(seed)
    label = f"ep dp1 x sp4 {cfg.name}"
    rng = np.random.default_rng(seed + 27)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=TP_NEW)
            for i, n in enumerate(EP_PROMPTS)]
    eng = tp_engine(model, cfg, params, 4, "tp")
    tp = eng.cores[0]._params
    ref = {id(b.ffn): o.ffn for b, o in zip(tp.layers, params.layers)}
    ep_run, gather_run = moe_mod._moe_ep_shard_map, moe_mod._moe_gather
    acc = {"ep_checks": 0, "ep_max_abs_err": 0.0, "ep_max_tol_ratio": 0.0,
           "rows": 0, "rows_gather_differs": 0, "gather_checks": 0,
           "gather_bits_equal": 0}

    def ep(p, cfg_, x, mesh, axis="model"):
        out = ep_run(p, cfg_, x, mesh, axis)
        saved = build.LAUNCHES.copy()
        plain = types.SimpleNamespace(**{
            n: moe_mod.whole(p, n).double()
            for n in ("router", "wi_gate", "wi_up", "wo")})
        want = ep_run(plain, cfg_, x.double(), mesh, axis)
        cap = moe_mod._capacity(x.shape[1], cfg_.moe.num_experts,
                                cfg_.moe.top_k, cfg_.moe.capacity_factor)
        gathered = gather_run(p, cfg_, x, cap)[0]
        build.LAUNCHES.clear()
        build.LAUNCHES.update(saved)
        acc["ep_max_abs_err"] = max(acc["ep_max_abs_err"],
                                    max_err(out, want, PREFILL_TOL))
        acc["ep_max_tol_ratio"] = max(acc["ep_max_tol_ratio"],
                                      tol_ratio(out, want, PREFILL_TOL))
        diff = (gathered.float() - out.float()).abs()
        rows = diff.amax(-1) > PREFILL_TOL * (1 + out.float().abs().amax(-1))
        acc["rows"] += rows.numel()
        acc["rows_gather_differs"] += int(rows.sum())
        acc["ep_checks"] += 1
        return out

    def gather(p, cfg_, x, capacity):
        out, aux = gather_run(p, cfg_, x, capacity)
        other = ref.get(id(p))
        if other is not None:
            same = torch.equal(out, gather_run(other, cfg_, x, capacity)[0])
            acc["gather_checks"] += 1
            acc["gather_bits_equal"] += int(same)
        return out, aux

    for r in reqs:
        eng.submit(r)
    ops.reset_launch_counts()
    moe_mod._moe_ep_shard_map, moe_mod._moe_gather = ep, gather
    try:
        done, ms = timed_steps(eng)
    finally:
        moe_mod._moe_ep_shard_map, moe_mod._moe_gather = ep_run, gather_run
    counts = ops.launch_counts()
    L = cfg.num_layers
    decode_steps = len(ms) - 1
    check(acc["ep_checks"] == L * len(reqs), f"{label}: EP checks {acc}")
    check(acc["gather_checks"] >= L * decode_steps
          and acc["gather_bits_equal"] == acc["gather_checks"],
          f"{label}: decode gather over sharded experts {acc}")
    check(all(len(c.tokens) == TP_NEW for c in done),
          f"{label}: completions")
    res = dict(acc, launches=counts, steps=len(ms),
               device_param_bytes=place_mod.device_param_bytes(tp),
               admission_ms=ms[0], decode_step_ms=median(ms[1:]))
    print(f"{label}: {acc['ep_checks']} MoE layers ran expert parallel at "
          f"admission, against the float64 plain EP: max abs err "
          f"{acc['ep_max_abs_err']:.4g} (share of {PREFILL_TOL}: "
          f"{acc['ep_max_tol_ratio']:.4g}); gather would have given "
          f"{acc['rows_gather_differs']} of {acc['rows']} rows "
          f"differently; {acc['gather_bits_equal']} of "
          f"{acc['gather_checks']} decode gathers over the sharded experts "
          f"bit for bit the replicated gather's; weight bytes a device "
          f"{res['device_param_bytes']}; launches {json.dumps(counts)}; "
          f"median decode step {res['decode_step_ms']:.3f} ms")
    del model, params, eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def cell_arm(model, params, cfg, toks, policy: str, impl: str,
             forced=None):
    """One arm of (c): ``build_prefill_step`` of the CELL_PROMPT-token
    prompt, then CELL_STEPS steps of ``build_mesh_decode_step`` (B 1,
    seq_len CELL_SEQ, model 2), checked (the prefill's and every step's
    embedding, layers and unembedding against the replicated weights' on
    the same input, each step's layers over a dense copy of the cache,
    ``checked_tp_layers``; every decode launch against its plain version
    in float64, every sequence-sharded decode also bit for bit the fused
    kernel's) and then timed from the same caches.  The checked run
    keeps the prefill's and every step's logits; with ``forced``
    (another arm's ``stream``) step i is fed that stream's token i
    instead of the arm's own (teacher forcing: the arms run one token
    stream).  The timed run decodes the arm's own greedy stream."""
    mesh = make_engine_mesh(1, 2, tp_devices(2))[0]
    pcfg = ServeConfig(model=cfg, shape=ShapeConfig(
        "p", CELL_PROMPT, 1, "prefill"), split_policy=policy,
        decode_impl=impl)
    dcfg = dataclasses.replace(pcfg, shape=ShapeConfig(
        "d", CELL_SEQ, 1, "decode"))
    pb = build_prefill_step(model, pcfg, mesh)
    db = build_mesh_decode_step(model, dcfg, mesh)
    placed = db.place_params(params)
    logits, prefill, decode = [], model.prefill, model.decode_step

    def prefill_logged(*a, **kw):
        out = prefill(*a, **kw)
        logits.append(out[0])
        return out

    def decode_logged(*a, **kw):
        out = decode(*a, **kw)
        logits.append(out)
        return out

    pacc, lacc = {}, {}
    model.prefill = prefill_logged
    try:
        with checked_tp_layers(placed[0], params, pacc, dense=True):
            first, caches = pb.step(placed, {"tokens": toks})
    finally:
        del model.prefill
    dense = join_caches(caches, torch.device(DEVICE, 0))
    full = model.init_cache(1, db.max_len)
    for name, c in dense.items():
        full[name][:, :, :c.shape[2]] = c

    def run(feed=None):
        c = db.place_caches({n: t.clone() for n, t in full.items()})
        tok, out, ms = first, [int(first[0])], []
        for i in range(CELL_STEPS):
            if feed is not None:
                tok = torch.tensor([feed[i]], device=first.device)
            t0 = time.perf_counter()
            tok, c = db.step(placed, c, tok, CELL_PROMPT + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(int(tok[0]))
        return out, ms

    kacc, sacc = {}, {}
    ops.reset_launch_counts()
    ops.reset_policy_eval_count()
    model.decode_step = decode_logged
    try:
        with checked_tp_layers(placed[0], params, lacc, dense=True), \
                checked_kernels(kacc), checked_seqsharded(sacc):
            stream, _ = run(forced)
    finally:
        del model.decode_step
    counts = ops.launch_counts()
    by_key = {f"{v} S{s}": n for (v, s), n in
              ops.launch_counts_by_key("flash_decode").items()}
    free, ms = run()
    L = cfg.num_layers
    return {"plan": db.plan.describe() | {"min_splits": db.plan.min_splits},
            "mesh_splits": db.mesh_splits, "stream": stream,
            "free_stream": free, "logits": logits, "launches": counts,
            "by_key": by_key, "policy_evals": ops.policy_eval_count(),
            "decode_checks": kacc["flash_decode"],
            "seqsharded_checks": sacc, "prefill_layer_checks": pacc,
            "layer_checks": lacc, "layers": L,
            "step_ms": median(ms)}


def margins(logits) -> list:
    """Each step's smallest top-2 logit margin over its rows."""
    out = []
    for x in logits:
        top = x.float().topk(2, dim=-1).values
        out.append(float((top[..., 0] - top[..., 1]).min()))
    return out


def logits_apart(want, got, label: str):
    """Two runs fed one token stream (teacher forcing), step by step: the
    same number of steps, the same logits shapes and the same finite
    rows (checked), and how far apart the logits are (measured: max
    |got - want| over the step's largest |want|, and the rows whose
    argmax agree).  Not held to a bound: on random weights each layer
    multiplies a difference in rounding, so two orders of summation that
    each layer holds within DECODE_TOL part completely within the
    depth; ``checked_tp_layers`` holds every piece on the same input."""
    check(len(got) == len(want), f"{label}: {len(got)} steps against "
          f"{len(want)}")
    acc = {"steps": 0, "rows": 0, "argmax_equal": 0, "max_rel": 0.0}
    for j, (w, g) in enumerate(zip(want, got)):
        w, g = w.float().reshape(-1, w.shape[-1]), \
            g.float().reshape(-1, g.shape[-1])
        check(w.shape == g.shape, f"{label}: step {j} logits {g.shape} "
              f"against {w.shape}")
        live = torch.isfinite(w).all(-1)
        check(torch.equal(live, torch.isfinite(g).all(-1)) and
              bool(live.any()), f"{label}: step {j} finite rows differ")
        w, g = w[live], g[live]
        acc["steps"] += 1
        acc["rows"] += w.shape[0]
        acc["argmax_equal"] += int((w.argmax(-1) == g.argmax(-1)).sum())
        acc["max_rel"] = max(acc["max_rel"], float(
            (g - w).abs().max() / w.abs().max().clamp_min(1.0)))
    return acc


def mesh_cell(model, params, cfg, seed: int):
    """(c) The paper's cell over a model axis of 2 (qwen2.5-3b at full
    depth, B 1, seq_len CELL_SEQ): ``fa3_baseline`` head-shards (2 K1
    launches a layer and step, each over one device's KV head: 1 CTA),
    ``paper`` fused sequence-shards (2 partials over 256-row chunks + 1
    combine), ``paper`` auto runs one K1 on the lead at S 4.  The two
    ``paper`` arms are fed ``fa3_baseline``'s greedy stream, so the three
    run one token stream, and in each arm the prefill's and every one of
    the CELL_STEPS steps' pieces are held against the replicated weights'
    over a dense cache (``cell_arm``); how far the ``paper`` arms' logits
    lie from ``fa3_baseline``'s is measured (``logits_apart``); the three
    arms' own greedy streams agree up to the first step where an arm's
    top-2 logit margin falls under CELL_MARGIN."""
    rng = np.random.default_rng(seed + 28)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, CELL_PROMPT)),
                        device=DEVICE)
    L, n = cfg.num_layers, CELL_STEPS
    want = {("fa3_baseline", "fused"): ({"512 S1": 2 * L * n}, 0),
            ("paper", "fused"): ({"256 S1": 2 * L * n}, L * n),
            ("paper", "auto"): ({"512 S4": L * n}, 0)}
    arms, base = {}, None
    for (policy, impl), (keys, combines) in want.items():
        label = f"mesh cell {policy} {impl}"
        a = cell_arm(model, params, cfg, toks, policy, impl,
                     forced=None if base is None else base["stream"])
        arms[f"{policy}_{impl}"] = a
        check(a["by_key"] == keys
              and a["launches"]["flash_combine"] == combines,
              f"{label}: launches {a['by_key']} {a['launches']}")
        check(a["policy_evals"] == 0, f"{label}: policy evaluated")
        fused = a["seqsharded_checks"]["checks"]
        # the layer checks' dense references add one K1 a layer and step
        check(a["decode_checks"]["checks"] == sum(keys.values())
              - (2 * L * n if combines else 0) + L * n and fused == (
                  L * n if combines else 0)
              and a["seqsharded_checks"]["bits_equal"] == fused,
              f"{label}: checks {a['decode_checks']} "
              f"{a['seqsharded_checks']}")
        pl, dl = a["prefill_layer_checks"], a["layer_checks"]
        check(pl["checks"] == L and pl["embed_checks"] == 1
              and pl["unembed_checks"] == 1 and dl["checks"] == L * n
              and dl["embed_checks"] == n and dl["unembed_checks"] == n,
              f"{label}: layer checks {pl} {dl}")
        apart = ""
        if base is None:
            base = a
        else:
            a["logits_apart"] = h = logits_apart(base["logits"],
                                                 a["logits"], label)
            apart = (f"; fed fa3_baseline's stream, its logits "
                     f"{h['max_rel']:.4g} of the largest from "
                     f"fa3_baseline's at worst, argmax equal on "
                     f"{h['argmax_equal']} of {h['rows']} steps")
        unembed = max(pl["unembed_max_tol_ratio"],
                      dl["unembed_max_tol_ratio"])
        print(f"{label}: plan {a['plan']}, launches {a['by_key']} + "
              f"{combines} combine, {a['decode_checks']['checks']} K1 "
              f"launches against the float64 plain version (max abs err "
              f"{a['decode_checks']['max_abs_err']:.4g}), {fused} "
              f"sequence-sharded decodes (max abs err "
              f"{a['seqsharded_checks'].get('max_abs_err', 0.0):.4g}); "
              f"{pl['checks'] + dl['checks']} layers against the "
              f"replicated weights' over a dense cache (share of "
              f"{DECODE_TOL}: "
              f"{max(pl['max_tol_ratio'], dl['max_tol_ratio']):.4g}), "
              f"{pl['unembed_checks'] + dl['unembed_checks']} "
              f"embeddings bit for bit and unembeddings within "
              f"{unembed:.4g} of the f32 bound; median step "
              f"{a['step_ms']:.3f} ms"
              f"{apart}")
    names = list(arms)
    # token i comes from logits i (the prefill's, the same launches in
    # every arm, then step i - 1's); an arm's checked-run logits are its
    # own greedy run's while the tokens fed so far are its own, that is,
    # up to where the streams may part
    gaps = {k: margins(arms[k]["logits"]) for k in names}
    agree = 0
    for i in range(CELL_STEPS + 1):
        if i and min(gaps[k][i] for k in names) < CELL_MARGIN:
            break
        toks_i = {arms[k]["free_stream"][i] for k in names}
        check(len(toks_i) == 1, f"mesh cell: streams part at token {i} "
              f"with margins {[gaps[k][i] for k in names]}"
              if i else "mesh cell: the prefill tokens differ")
        agree = i + 1
    for a in arms.values():
        del a["logits"]
    print(f"mesh cell: the three streams agree on their first {agree} "
          f"tokens (up to the first margin under {CELL_MARGIN})")
    return {"arms": arms, "tokens_agreed": agree}


def seqpar_prefill(model, params, cfg, seed: int):
    """(d) ``build_prefill_step`` of qwen2.5-3b over a model axis of 3
    (its 16 query heads do not divide), SEQPAR_LEN rows at B 1: each
    layer's attention runs sequence-parallel, 3 prefill launches over
    128-row chunks at q_offset 0 / 128 / 256, and their joined output is
    held bit for bit against one whole-sequence launch where every chunk
    starts on a multiple of the kernel's row tile, and against the
    float64 plain version in every case."""
    mesh = make_engine_mesh(1, SEQPAR_AXIS, tp_devices(SEQPAR_AXIS))[0]
    scfg = ServeConfig(model=cfg, shape=ShapeConfig(
        "p", SEQPAR_LEN, 1, "prefill"))
    pb = build_prefill_step(model, scfg, mesh)
    check(pb.plan.seq_shard_mesh is not None, "seqpar: no sequence-"
          "parallel plan")
    rng = np.random.default_rng(seed + 29)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, SEQPAR_LEN)),
                        device=DEVICE)
    run, prefill = ops._attention_seqpar, ops.flash_prefill
    acc = {"checks": 0, "bits_equal": 0, "aligned": 0, "max_abs_err": 0.0,
           "offsets": []}

    def launch(q, k, v, **kw):
        acc["offsets"].append((q.shape[1], kw.get("q_offset", 0)))
        return prefill(q, k, v, **kw)

    def seqpar(q, k, v, *, causal, window, q_offset, mesh):
        out = run(q, k, v, causal=causal, window=window, q_offset=q_offset,
                  mesh=mesh)
        saved = build.LAUNCHES.copy()
        qs = (q.float() * q.shape[-1] ** -0.5).to(q.dtype)
        whole = prefill(qs, k, v, causal=causal, window=window,
                        q_offset=q_offset)
        want = prefill_plain(f64(qs), f64(k), f64(v), causal=causal,
                             window=window, q_offset=q_offset)
        build.LAUNCHES.clear()
        build.LAUNCHES.update(saved)
        chunk = q.shape[1] // mesh.shape["model"]
        aligned = chunk % PREFILL_ROW_TILE == 0
        same = torch.equal(out, whole)
        check(same or not aligned, "seqpar: tile-aligned chunks differ "
              "from one whole launch")
        acc["max_abs_err"] = max(acc["max_abs_err"],
                                 max_err(out, want, PREFILL_TOL))
        acc["checks"] += 1
        acc["bits_equal"] += int(same)
        acc["aligned"] += int(aligned)
        return out

    placed = pb.place_params(params)
    ops.reset_launch_counts()
    ops._attention_seqpar, ops.flash_prefill = seqpar, launch
    try:
        t0 = time.perf_counter()
        tok, caches = pb.step(placed, {"tokens": toks})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        ops._attention_seqpar, ops.flash_prefill = run, prefill
    L, c = cfg.num_layers, SEQPAR_LEN // SEQPAR_AXIS
    by_key = ops.launch_counts_by_key("flash_prefill")
    check(acc["checks"] == L and acc["bits_equal"] == L,
          f"seqpar: checks {acc['checks']}, bits equal {acc['bits_equal']}")
    check(acc["offsets"] == [(c, i * c) for i in range(SEQPAR_AXIS)] * L,
          f"seqpar: launches (Lq, q_offset) {acc['offsets'][:6]}")
    check(by_key == {("bfloat16", c): SEQPAR_AXIS * L},
          f"seqpar: prefill launches by key {by_key}")
    check(bool(torch.isfinite(join_caches(caches, toks.device)["k"].float()
                              ).all()), "seqpar: caches")
    res = {"checks": acc["checks"], "bits_equal": acc["bits_equal"],
           "max_abs_err": acc["max_abs_err"],
           "launches": {f"{d} {lq}": n for (d, lq), n in by_key.items()},
           "step_ms": ms}
    print(f"seqpar prefill {cfg.name} over {SEQPAR_AXIS} devices: "
          f"{SEQPAR_AXIS} prefill launches a layer over {c}-row chunks at "
          f"q_offset {[i * c for i in range(SEQPAR_AXIS)]}, launches "
          f"{res['launches']}; {acc['bits_equal']} of {acc['checks']} "
          f"layers bit for bit one whole launch; max abs err against the "
          f"float64 plain version {acc['max_abs_err']:.4g}; step {ms:.3f} "
          f"ms (first call, unwarmed)")
    return res


def phase_tp(model, params, cfg, seed: int, moe_layers=None):
    """Tensor- and expert-parallel serving and the frozen mesh step
    builders on ``[cuda:0] * n``: (a) ``tp_serving`` bf16 and int8, (b)
    ``ep_serving``, (c) ``mesh_cell``, (d) ``seqpar_prefill``."""
    res = {"tp_bf16": tp_serving(model, params, cfg, seed),
           "tp_int8": tp_serving(model, params, cfg, seed,
                                 kv_quant="int8")}
    gc.collect()
    torch.cuda.empty_cache()
    res["cell"] = mesh_cell(model, params, cfg, seed)
    res["seqpar"] = seqpar_prefill(model, params, cfg, seed)
    gc.collect()
    torch.cuda.empty_cache()
    res["ep"] = ep_serving(seed, moe_layers)
    res["layers"] = cfg.num_layers
    return res


def tp_kernel_rows(gen, sms: int, tp):
    """The kernels line's rows of this slice's launch shapes, each with
    its launches in ``phase_tp``: K1 over one device's KV head (H_KV 1, G
    8, view 512, S1: the mesh cell's head-sharded arm) and over both
    heads at S 4 (its ``auto`` arm, the chunks joined on the lead), with
    SDPA; K1's partials over a 256-row chunk of both heads and K2
    merging 2 of them (its fused arm); K2 merging 2 partials at B 2 and
    K4's partials over a 1024-row int8 chunk where the TP serving runs'
    plans shard the sequence, else K1 (with SDPA) and K4 fused over the
    joined chunks at the plans' (bucket, S); K3 over a 128-row chunk
    against 384 keys at q_offset 0, 128 and 256 (the sequence-parallel
    prefill), with SDPA."""
    g, d = 8, 128
    arms = tp["cell"]["arms"]
    lens = torch.tensor([CELL_PROMPT + 1], device=DEVICE, dtype=torch.int32)
    kv_rows = CELL_PROMPT + 1
    mask = torch.arange(CELL_SEQ, device=DEVICE)[None] < lens[:, None]

    def case(hkv):
        q = rand(gen, (1, hkv, g, d))
        k = rand(gen, (1, CELL_SEQ, hkv, d))
        v = rand(gen, (1, CELL_SEQ, hkv, d))
        sdpa = functools.partial(
            F.scaled_dot_product_attention, q.reshape(1, hkv * g, 1, d),
            k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None, None, :], scale=1.0, enable_gqa=True)
        return q, k, v, sdpa

    rows = []
    for hkv, s, arm, what in (
            (1, 1, "fa3_baseline_fused", "one device's KV head of 2, "
             "head-sharded"),
            (2, 4, "paper_auto", "auto: the chunks joined, S rounded up "
             "to the axis")):
        q, k, v, sdpa = case(hkv)
        rows.append(dict(
            name="flash_decode",
            shape=f"B1 view {CELL_SEQ} S{s} Hkv{hkv} G{g} D{d} {what}",
            fn=functools.partial(fdec.flash_decode, q, k, v, lens,
                                 num_splits=s),
            plain=functools.partial(fdec.decode_plain, q, k, v, lens,
                                    num_splits=s),
            lib=sdpa, nbytes=2 * kv_rows * hkv * d * 2 + 2 * q.numel() * 2,
            flops=4 * kv_rows * hkv * g * d,
            err=max_err(fdec.flash_decode(q, k, v, lens, num_splits=s),
                        fdec.decode_plain(f64(q), f64(k), f64(v), lens,
                                          num_splits=s), DECODE_TOL),
            launches=arms[arm]["by_key"].get(f"{CELL_SEQ} S{s}", 0)))
    hkv, c = 2, CELL_SEQ // 2
    q, k, v, _ = case(hkv)
    parts = [flash_decode_partials(q, k[:, i * c:(i + 1) * c],
                                   v[:, i * c:(i + 1) * c],
                                   (lens - i * c).clamp(0, c), num_splits=1)
             for i in range(2)]
    acc, l, m = (torch.cat(x) for x in zip(*parts))
    want = fdec.decode_plain(f64(q), f64(k), f64(v), lens, num_splits=2)
    fused = arms["paper_fused"]
    rows.append(dict(
        name="flash_decode",
        shape=f"B1 view {c} S1 Hkv{hkv} G{g} D{d} partials only, one "
              f"sequence shard of 2",
        fn=functools.partial(flash_decode_partials, q, k[:, :c], v[:, :c],
                             lens.clamp(max=c), num_splits=1),
        plain=functools.partial(fdec.decode_partials_plain, q, k[:, :c],
                                v[:, :c], lens.clamp(max=c), num_splits=1),
        lib=None, nbytes=2 * c * hkv * d * 2 + q.numel() * 2
        + hkv * g * (d + 2) * 4, flops=4 * c * hkv * g * d,
        err=max_err(combine_plain(acc, l, m, out_dtype=torch.float32),
                    want, DECODE_TOL),
        launches=fused["by_key"].get(f"{c} S1", 0)))
    rows.append(dict(
        name="flash_combine",
        shape=f"S2 B1 Hkv{hkv} G{g} D{d} sequence-sharded merge (mesh "
              f"cell)",
        fn=lambda: flash_combine(acc, l, m, out_dtype=torch.bfloat16),
        plain=lambda: combine_plain(acc, l, m, out_dtype=torch.bfloat16),
        lib=None, nbytes=2 * hkv * g * (d + 2) * 4 + hkv * g * d * 2,
        flops=6 * 2 * hkv * g * d,
        err=max_err(flash_combine(acc, l, m, out_dtype=torch.bfloat16),
                    want, DECODE_TOL),
        launches=fused["launches"]["flash_combine"]))
    # the TP serving run's shapes: B 2, H_KV 2, G 8, two 1024-row chunks
    hkv2, b, cc = 2, 2, 1024
    q2 = rand(gen, (b, hkv2, g, d))
    k2 = rand(gen, (b, 2 * cc, hkv2, d))
    v2 = rand(gen, (b, 2 * cc, hkv2, d))
    lens2 = torch.tensor([n + TP_NEW for n in TP_PROMPTS], device=DEVICE,
                         dtype=torch.int32)
    p2 = [flash_decode_partials(q2, k2[:, i * cc:(i + 1) * cc],
                                v2[:, i * cc:(i + 1) * cc],
                                (lens2 - i * cc).clamp(0, cc),
                                num_splits=1) for i in range(2)]
    a2, l2, m2 = (torch.cat(x) for x in zip(*p2))
    tp_rows = []
    tp_rows.append(dict(
        name="flash_combine",
        shape=f"S2 B{b} Hkv{hkv2} G{g} D{d} sequence-sharded merge (TP "
              f"serving)",
        fn=lambda: flash_combine(a2, l2, m2, out_dtype=torch.bfloat16),
        plain=lambda: combine_plain(a2, l2, m2, out_dtype=torch.bfloat16),
        lib=None, nbytes=2 * b * hkv2 * g * (d + 2) * 4
        + b * hkv2 * g * d * 2, flops=6 * 2 * b * hkv2 * g * d,
        err=max_err(flash_combine(a2, l2, m2, out_dtype=torch.bfloat16),
                    fdec.decode_plain(f64(q2), f64(k2), f64(v2), lens2,
                                      num_splits=2), DECODE_TOL),
        launches=tp["tp_bf16"]["launches"]["flash_combine"]))
    qz = Quantizer.from_kv_dtype("int8")
    kq, ks = qz.quantize(k2[:, cc:])
    vq, vs = qz.quantize(v2[:, cc:])
    l1 = (lens2 - cc).clamp(0, cc)
    tp_rows.append(dict(
        name="flash_decode_quant",
        shape=f"B{b} view {cc} S1 Hkv{hkv2} G{g} D{d} int8 partials only, "
              f"one sequence shard of 2 (TP serving)",
        fn=functools.partial(flash_decode_quant_partials, q2, kq, vq, ks,
                             vs, l1, num_splits=1),
        plain=functools.partial(decode_quant_partials_plain, q2, kq, vq,
                                ks, vs, l1, num_splits=1),
        lib=None, nbytes=2 * int(l1.sum()) * hkv2 * (d + 4)
        + q2.numel() * 2 + b * hkv2 * g * (d + 2) * 4,
        flops=4 * int(l1.sum()) * hkv2 * g * d
        + 2 * int(l1.sum()) * hkv2 * d, peak=INT8_OPS_PER_S,
        err=max_err(combine_plain(*flash_decode_quant_partials(
            q2, kq, vq, ks, vs, l1, num_splits=1),
            out_dtype=torch.float32), fdq.decode_quant_plain(
            f64(q2), kq, vq, f64(ks), f64(vs), l1, num_splits=1),
            QUANT_TOL),
        launches=tp["tp_int8"]["sharded_steps"] * 2 * tp["layers"]))
    # the TP serving runs' whole-view launches (plans whose mesh_splits
    # is 1: the chunks joined on the lead, one fused launch a layer at the
    # plan's split)
    kq2, ks2 = qz.quantize(k2)
    vq2, vs2 = qz.quantize(v2)
    for run, name in (("tp_bf16", "flash_decode"),
                      ("tp_int8", "flash_decode_quant")):
        for key, n in tp[run]["whole_launches"].items():
            view, s = (int(x) for x in key.split(" S"))
            lens = lens2.clamp(max=view)
            rows_kv = int(lens.sum())
            if name == "flash_decode":
                args = (q2, k2[:, :view], v2[:, :view], lens)
                plain = fdec.decode_plain
                want = fdec.decode_plain(*(f64(x) for x in args[:3]), lens,
                                         num_splits=s)
                mask = (torch.arange(view, device=DEVICE)[None]
                        < lens[:, None])
                lib = functools.partial(
                    F.scaled_dot_product_attention,
                    q2.reshape(b, hkv2 * g, 1, d),
                    k2[:, :view].transpose(1, 2),
                    v2[:, :view].transpose(1, 2),
                    attn_mask=mask[:, None, None, :], scale=1.0,
                    enable_gqa=True)
                nbytes, flops, peak, tol = (
                    2 * rows_kv * hkv2 * d * 2 + 2 * q2.numel() * 2,
                    4 * rows_kv * hkv2 * g * d, BF16_FLOPS_PER_S,
                    DECODE_TOL)
            else:
                args = (q2, kq2[:, :view], vq2[:, :view], ks2[:, :view],
                        vs2[:, :view], lens)
                plain = fdq.decode_quant_plain
                want = fdq.decode_quant_plain(
                    f64(q2), args[1], args[2], f64(args[3]), f64(args[4]),
                    lens, num_splits=s)
                lib = None
                nbytes, flops, peak, tol = (
                    2 * rows_kv * hkv2 * (d + 4) + 2 * q2.numel() * 2,
                    4 * rows_kv * hkv2 * g * d + 2 * rows_kv * hkv2 * d,
                    INT8_OPS_PER_S, QUANT_TOL)
            fn = fdec.flash_decode if name == "flash_decode" \
                else fdq.flash_decode_quant
            rows.append(dict(
                name=name,
                shape=f"B{b} view {view} kv_len {lens.tolist()} S{s} "
                      f"Hkv{hkv2} G{g} D{d} fused combine, over the "
                      f"chunks joined (TP serving, mesh_splits 1)",
                fn=functools.partial(fn, *args, num_splits=s),
                plain=functools.partial(plain, *args, num_splits=s),
                lib=lib, nbytes=nbytes, flops=flops, peak=peak,
                err=max_err(fn(*args, num_splits=s), want, tol),
                tol=tol, launches=n))
    # the sequence-sharded shapes, where the TP serving runs' plans shard
    # the sequence
    rows += [r for r in tp_rows if r["launches"]]
    # K3 as the sequence-parallel prefill runs it: a 128-row chunk of 16
    # heads against 384 keys at each chunk's offset
    c3 = SEQPAR_LEN // SEQPAR_AXIS
    for off in range(0, SEQPAR_LEN, c3):
        pq, pk, pv = prefill_case(gen, 1, c3, SEQPAR_LEN, 16, 2, d)
        kw = dict(causal=True, q_offset=off)
        mask3 = (torch.arange(SEQPAR_LEN, device=DEVICE)[None]
                 <= off + torch.arange(c3, device=DEVICE)[:, None])
        rows.append(dict(
            name="flash_prefill",
            shape=f"B1 Lq={c3} Lk={SEQPAR_LEN} q_offset={off} Hq16 Hkv2 "
                  f"D{d} causal bf16, sequence-parallel chunk",
            fn=functools.partial(flash_prefill, pq, pk, pv, **kw),
            plain=functools.partial(prefill_plain, pq, pk, pv, **kw),
            lib=functools.partial(
                F.scaled_dot_product_attention,
                *(t.transpose(1, 2) for t in (pq, pk, pv)),
                attn_mask=mask3, scale=1.0, enable_gqa=True),
            # the causal frontier: K / V rows [0, off + c3) are read,
            # as the flops count them
            nbytes=2 * (2 * pq.numel() + (pk.numel() + pv.numel())
                        * min(off + c3, SEQPAR_LEN) // SEQPAR_LEN),
            flops=4 * 16 * d * sum(min(off + i + 1, SEQPAR_LEN)
                                   for i in range(c3)),
            err=max_err(flash_prefill(pq, pk, pv, **kw),
                        prefill_plain(f64(pq), f64(pk), f64(pv), **kw),
                        PREFILL_TOL),
            launches=tp["seqpar"]["launches"].get(f"bfloat16 {c3}", 0)
            // SEQPAR_AXIS))
    return rows


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


# ---------------------------------------------------------------------------
# phase train: qwen2.5-3b trained at full width, attention on K3 and K3b
# ---------------------------------------------------------------------------

# the training cell: B 2 x 1024 tokens, 6 AdamW steps (constant lr 1e-4
# after one warmup step), remat nothing_saveable
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 1024, 2, 6, 1e-4
# normwise tolerances against the float64 plain versions, on the model's
# own inputs: K3's output and K3b's dq, dk, dv are bf16 (one rounding is
# 2^-9 of a value), K3's LSE is f32 from scores summed in f32
TRAIN_OUT_TOL, TRAIN_LSE_TOL, TRAIN_GRAD_TOL = 1e-2, 1e-5, 1e-2
# the whole gradient at cut depth against the same model with attention
# in float64, each leaf normwise (floored at 1e-3 of the whole
# gradient's norm): within TRAIN_LEAF_TOL, or, upstream of a softmax,
# within TRAIN_COND_RATIO times the distance of the plain float32
# attention's gradient from float64.  On these random weights the rows
# are nearly one-hot, so dS = P (dP - delta) cancels to a small fraction
# of its terms, and every leaf upstream of the scores (the q and k paths
# and all lower layers) moves by 25-35% under a change of attention's
# rounding alone (a CPU run at full width, vocabulary cut to 4096: plain
# float32 against float64 attention).  Microbatches 2 against 1: bf16
# products over 1024 rows against 2048 round apart, normwise.
TRAIN_LEAF_TOL, TRAIN_COND_RATIO, TRAIN_MICRO_TOL = 5e-2, 2.0, 2e-2
TRAIN_CUT_LAYERS = 2


def normwise(got, want) -> float:
    """||got - want|| / ||want||, in float64."""
    w = want.double()
    return float((got.double() - w).norm() / w.norm().clamp_min(1e-300))


def train_config(cfg, remat: str = "nothing_saveable", micro: int = 1):
    return TrainConfig(
        model=cfg, shape=ShapeConfig("train_1k", TRAIN_SEQ, TRAIN_BATCH,
                                     "train"),
        optimizer=OptimizerConfig(lr=TRAIN_LR, warmup_steps=1,
                                  total_steps=TRAIN_STEPS,
                                  schedule="constant"),
        microbatches=micro, remat_policy=remat)


@contextlib.contextmanager
def train_attention(lse_fn, bwd_fn):
    """Within the block, the prefill kernel's autograd form
    (``FlashPrefillFn``) calls ``lse_fn`` for its forward and ``bwd_fn``
    for its backward, in place of ``flash_prefill_lse`` and
    ``flash_prefill_bwd`` (same signatures)."""
    saved = fprefill.flash_prefill_lse, fprefill.flash_prefill_bwd
    fprefill.flash_prefill_lse, fprefill.flash_prefill_bwd = lse_fn, bwd_fn
    try:
        yield
    finally:
        fprefill.flash_prefill_lse, fprefill.flash_prefill_bwd = saved


def checked_train_attention(acc):
    """(lse_fn, bwd_fn) for ``train_attention`` that run the kernels and
    hold each call against the float64 plain versions on the same inputs
    (normwise, TRAIN_*_TOL), keeping the worst ratios in ``acc``."""
    lse_k, bwd_k = fprefill.flash_prefill_lse, fprefill.flash_prefill_bwd

    def lse_fn(q, k, v, **kw):
        out, lse = lse_k(q, k, v, **kw)
        e_out = normwise(out, fprefill.prefill_plain(f64(q), f64(k), f64(v),
                                                     **kw))
        e_lse = normwise(lse, fprefill.prefill_lse_plain(f64(q), f64(k),
                                                         **kw))
        acc["out"] = max(acc["out"], e_out)
        acc["lse"] = max(acc["lse"], e_lse)
        acc["forward_checks"] += 1
        check(e_out <= TRAIN_OUT_TOL and e_lse <= TRAIN_LSE_TOL,
              f"training forward attention: output {e_out:.3e} "
              f"(tol {TRAIN_OUT_TOL}), LSE {e_lse:.3e} (tol "
              f"{TRAIN_LSE_TOL})")
        return out, lse

    def bwd_fn(q, k, v, o, lse, do, **kw):
        got = bwd_k(q, k, v, o, lse, do, **kw)
        want = fprefill.prefill_backward_plain(
            *(f64(t) for t in (q, k, v, o, lse, do)), **kw)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            e = normwise(g, w)
            acc[name] = max(acc[name], e)
            check(e <= TRAIN_GRAD_TOL, f"training backward attention: "
                  f"{name} {e:.3e} (tol {TRAIN_GRAD_TOL})")
        acc["backward_checks"] += 1
        return got

    return lse_fn, bwd_fn


def plain_attention(dtype):
    """(lse_fn, bwd_fn) for ``train_attention`` that compute on the plain
    versions in ``dtype`` (float64: the reference point of the
    whole-gradient check; float32: its conditioning floor) and round
    the outputs to the inputs' dtype."""
    def lse_fn(q, k, v, **kw):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        return (fprefill.prefill_plain(qd, kd, vd, **kw).to(q.dtype),
                fprefill.prefill_lse_plain(qd, kd, **kw).float())

    def bwd_fn(q, k, v, o, lse, do, **kw):
        return tuple(t.to(q.dtype) for t in fprefill.prefill_backward_plain(
            *(t.to(dtype) for t in (q, k, v, o, lse, do)), **kw))

    return lse_fn, bwd_fn


def train_counts(layers: int, forwards: int, backwards: int,
                 what: str) -> dict:
    """Check the launches of the run just driven: K3 ``forwards`` times a
    layer, K3b's call ``backwards`` times a layer (BWD_LAUNCHES_PER_CALL
    launches each), all at one (dtype, Lq), nothing else; returns the
    counts."""
    counts = ops.launch_counts()
    by = {k: ops.launch_counts_by_key(k) for k in
          ("flash_prefill", "flash_prefill_bwd")}
    want = {"flash_prefill": forwards * layers,
            "flash_prefill_bwd": BWD_LAUNCHES_PER_CALL * backwards * layers}
    check(all(counts[k] == want.get(k, 0) for k in counts),
          f"{what}: launches {counts}, want {want}")
    lq = {key[1] for key in by["flash_prefill"]}
    check(len(lq) == 1 and len(by["flash_prefill_bwd"]) == 1,
          f"{what}: launches by key {by}")
    return counts


def leafwise(got: dict, want: dict, label: str = "") -> tuple:
    """(the worst leaf's normwise error, floored at 1e-3 of the whole
    gradient's norm, its name; the whole tree's normwise error).  With a
    ``label``, prints the six worst leaves (error, |want|, |got - want|)."""
    whole = sum(float(w.double().square().sum()) for w in want.values())
    floor = 1e-3 * whole ** 0.5
    rows, diff = [], 0.0
    for n, w in want.items():
        d = float((got[n].double() - w.double()).norm())
        diff += d * d
        norm = float(w.double().norm())
        rows.append((d / max(norm, floor), n, norm, d))
    rows.sort(reverse=True)
    if label:
        print(f"{label}: whole gradient norm {whole ** 0.5:.4e}; worst "
              "leaves " + "; ".join(f"{n} {e:.3e} (|g| {norm:.3e}, "
                                    f"|diff| {d:.3e})"
                                    for e, n, norm, d in rows[:6]))
    return rows[0][0], rows[0][1], (diff / whole) ** 0.5


def phase_train(seed: int, flush):
    """Training at full width: qwen2.5-3b at its 36 layers, AdamW, remat
    nothing_saveable, TRAIN_STEPS steps on one repeated SyntheticLM batch
    of 2 x 1024 tokens, every step's launches checked (K3 72, K3b 72) and
    step 0's attention checked layer by layer against float64; then at 2
    layers (full width) the whole gradient against float64 attention,
    remat and microbatches, and a crash and resume; then K3 with its LSE
    and K3b timed at the training cell."""
    out = {}
    cfg = get_arch("qwen2.5-3b")
    L = cfg.num_layers
    model = build_model(cfg, device=DEVICE)
    bundle = build_train_step(model, train_config(cfg))
    t0 = time.perf_counter()
    params, opt_state = bundle.init(seed)
    torch.cuda.synchronize()
    tree = param_tree(params)
    wbytes = sum(p.numel() * p.element_size() for p in tree.values())
    mbytes = sum(m.numel() * 4 for m in opt_state["m"].values()) * 2
    print(f"train {cfg.name}: {L} layers d_model {cfg.d_model}, "
          f"{sum(p.numel() for p in tree.values())} params, {wbytes} B of "
          f"weights, {mbytes} B of f32 moments, init "
          f"{time.perf_counter() - t0:.1f} s; batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, lr {TRAIN_LR} constant, remat nothing_saveable")
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                  seed=seed))
    batch = bundle.to_device(data.batch_at(0))
    acc = {"out": 0.0, "lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0,
           "forward_checks": 0, "backward_checks": 0}
    steps, launches = [], {"flash_prefill": 0, "flash_prefill_bwd": 0}
    torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS):
        route = (train_attention(*checked_train_attention(acc)) if step == 0
                 else contextlib.nullcontext())
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t = time.perf_counter()
        with route:
            m = bundle.step(params, opt_state, batch)[2]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        counts = train_counts(L, 2, 1, f"train step {step}")
        for k in launches:
            launches[k] += counts[k]
        rec = {"step": step, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
               "ms": ms, "max_memory_allocated":
               torch.cuda.max_memory_allocated()}
        check(np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"]),
              f"train step {step}: non-finite {rec}")
        steps.append(rec)
        print(f"train step {step}: loss {rec['loss']:.6f} grad_norm "
              f"{rec['grad_norm']:.6f} lr {rec['lr']:.3g} {ms:.1f} ms"
              f"{' (with the layer checks)' if step == 0 else ''}, "
              f"max_memory_allocated {rec['max_memory_allocated']} B, "
              f"launches K3 {counts['flash_prefill']} K3b "
              f"{counts['flash_prefill_bwd']}")
    check(acc["forward_checks"] == 2 * L and acc["backward_checks"] == L,
          f"layer checks: {acc}")
    print(f"train layer checks at step 0 ({acc['forward_checks']} forward, "
          f"{acc['backward_checks']} backward calls) against float64, "
          f"normwise: output {acc['out']:.3e} lse {acc['lse']:.3e} dq "
          f"{acc['dq']:.3e} dk {acc['dk']:.3e} dv {acc['dv']:.3e}")
    with torch.no_grad():
        _, after = lm_loss(model, params, batch)
    loss_after = float(after["loss"])
    check(loss_after < steps[0]["loss"],
          f"loss after {TRAIN_STEPS} steps on the repeated batch "
          f"{loss_after} is not below step 0's {steps[0]['loss']}")
    print(f"train loss on the repeated batch: step 0 {steps[0]['loss']:.6f}"
          f", after {TRAIN_STEPS} steps {loss_after:.6f}")
    # where a step's time goes: one more step under torch.profiler
    with profiled() as (prof, wall):
        bundle.step(params, opt_state, batch)
    kernels, device_ops = device_kernels(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    profile = {"wall_ms": wall[0], "device_busy_ms": busy,
               "idle_share": 1 - busy / wall[0], "device_ops": device_ops,
               "top_kernels_ms": {k[:80]: v for k, v in top}}
    print(f"train step profiled: wall {wall[0]:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {profile['idle_share']:.3f}, "
          f"{device_ops} device ops (profiler on)")
    for name, ms in profile["top_kernels_ms"].items():
        print(f"  {ms:.3f} ms  {name}")
    out["full"] = {"steps": steps, "loss_after": loss_after,
                   "layer_checks": acc, "launches": launches,
                   "weight_bytes": wbytes, "moment_bytes": mbytes,
                   "step_ms_mean_1_on": sum(s["ms"] for s in steps[1:])
                   / (len(steps) - 1),
                   "peak_bytes": max(s["max_memory_allocated"]
                                     for s in steps), "profile": profile}
    del params, opt_state, tree, bundle, model, batch, prof
    gc.collect()
    torch.cuda.empty_cache()
    out["cut"] = phase_train_cut(cfg, seed, data)
    # the timed rows draw from a generator of their own, so the default
    # run's later phases see the inputs they saw before this phase
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 27)
    out["times"], rows = train_kernel_rows(gen, flush, launches)
    return out, rows


def phase_train_cut(cfg, seed: int, data):
    """At TRAIN_CUT_LAYERS layers and full width: (c) every gradient leaf
    against the same model whose attention runs the float64 plain forward
    and backward; (d) remat nothing_saveable against none, and 2
    microbatches against 1; (e) a crash at step 2 and the resume from the
    step-1 checkpoint against the uninterrupted run."""
    out = {}
    cut = cut_depth(cfg, TRAIN_CUT_LAYERS)
    n = cut.num_layers
    model = build_model(cut, device=DEVICE)
    b_none = build_train_step(model, train_config(cut, remat="none"))
    params = b_none.init(seed)[0]
    batch = b_none.to_device(data.batch_at(0))
    ops.reset_launch_counts()
    total, _, g_kernel = b_none.grads(params, batch)
    torch.cuda.synchronize()
    train_counts(n, 1, 1, "cut depth, remat none")
    plain = {}
    for dtype in (torch.float64, torch.float32):
        with train_attention(*plain_attention(dtype)):
            ops.reset_launch_counts()
            plain[dtype] = b_none.grads(params, batch)
            torch.cuda.synchronize()
            check(sum(ops.launch_counts().values()) == 0,
                  f"plain attention launched {ops.launch_counts()}")
    total64, _, g_plain = plain[torch.float64]
    g32 = plain[torch.float32][2]
    _, _, whole = leafwise(g_kernel, g_plain, "train cut: kernels against "
                           "float64 attention")
    _, _, whole32 = leafwise(g32, g_plain, "train cut: plain float32 "
                             "attention against float64")
    worst, leaf = 0.0, None
    floor = 1e-3 * sum(float(x.double().square().sum())
                       for x in g_plain.values()) ** 0.5
    for name, w in g_plain.items():
        norm = max(float(w.double().norm()), floor)
        e_k = float((g_kernel[name].double() - w.double()).norm()) / norm
        e_32 = float((g32[name].double() - w.double()).norm()) / norm
        ratio = e_k / max(TRAIN_LEAF_TOL, TRAIN_COND_RATIO * e_32)
        if ratio >= worst:
            worst, leaf = ratio, (name, e_k, e_32)
    check(worst <= 1.0, f"gradient leaf {leaf[0]}: {leaf[1]:.3e} from "
          f"float64 attention's, plain float32 attention {leaf[2]:.3e} "
          f"(tol max({TRAIN_LEAF_TOL}, {TRAIN_COND_RATIO} x that))")
    out["whole_gradient"] = {"worst_leaf": leaf[0], "worst_ratio": worst,
                             "leaf_kernel": leaf[1], "leaf_plain32": leaf[2],
                             "whole": whole, "whole_plain32": whole32,
                             "loss": float(total),
                             "loss_float64_attention": float(total64)}
    print(f"train cut {n} layers: gradient against float64 attention's, "
          f"whole tree {whole:.3e} (plain float32 attention {whole32:.3e});"
          f" the worst leaf against its tolerance {leaf[0]} {worst:.3f} "
          f"({leaf[1]:.3e}, plain float32 {leaf[2]:.3e}); loss "
          f"{float(total):.6f} / {float(total64):.6f}")
    b_ns = build_train_step(model, train_config(cut))
    ops.reset_launch_counts()
    t_ns, _, g_ns = b_ns.grads(params, batch)
    torch.cuda.synchronize()
    train_counts(n, 2, 1, "cut depth, remat nothing_saveable")
    same = [k for k in g_kernel if not torch.equal(g_kernel[k], g_ns[k])]
    worst_ns, leaf_ns, whole_ns = leafwise(g_ns, g_kernel,
                                           "train cut: nothing_saveable "
                                           "against none")
    check(torch.equal(t_ns, total) and not same,
          f"remat nothing_saveable against none: loss {float(t_ns)} / "
          f"{float(total)}, {len(same)} leaves differ ({same[:4]}), worst "
          f"{leaf_ns} {worst_ns:.3e}")
    b_m2 = build_train_step(model, train_config(cut, remat="none", micro=2))
    ops.reset_launch_counts()
    t_m2, _, g_m2 = b_m2.grads(params, batch)
    torch.cuda.synchronize()
    train_counts(n, 2, 2, "cut depth, 2 microbatches")
    _, _, whole_m2 = leafwise(g_m2, g_kernel, "train cut: 2 microbatches "
                              "against 1")
    rel_loss = abs(float(t_m2) / float(total) - 1)
    check(whole_m2 <= TRAIN_MICRO_TOL and rel_loss <= 1e-3,
          f"2 microbatches against 1: gradient {whole_m2:.3e} (tol "
          f"{TRAIN_MICRO_TOL}), loss {rel_loss:.3e} (tol 1e-3)")
    out["remat"] = {"bit_for_bit": True}
    out["microbatches"] = {"whole": whole_m2, "loss_rel": rel_loss}
    print(f"train cut: remat nothing_saveable gives none's loss and "
          f"gradients bit for bit; 2 microbatches against 1: gradient "
          f"{whole_m2:.3e} normwise (tol {TRAIN_MICRO_TOL}), loss "
          f"{rel_loss:.3e}")
    del params, g_kernel, g_plain, g32, plain, g_ns, g_m2
    gc.collect()
    torch.cuda.empty_cache()
    out["resume"] = phase_train_resume(b_ns, data)
    return out


def phase_train_resume(bundle, data):
    """(e) 3 steps with a checkpoint after step 1 (keep 1, synchronous),
    uninterrupted; then crashed at step 2 and resumed from that
    checkpoint: every step's loss and grad_norm against the uninterrupted
    run's, bit for bit (the same kernels on the same restored bits)."""
    rec = {}

    def recording(label):
        def step(p, o, b):
            p, o, m = bundle.step(p, o, b)
            rec.setdefault(label, []).append(
                (float(m["loss"]), float(m["grad_norm"])))
            return p, o, m
        return dataclasses.replace(bundle, step=step)

    root = Path(tempfile.mkdtemp(prefix="train_ckpt_"))
    kw = dict(total_steps=3, ckpt_every=2, keep=1, async_ckpt=False,
              log_fn=lambda line: None)
    t0 = time.perf_counter()
    try:
        resumable_train_loop(recording("whole"), data,
                             ckpt_dir=str(root / "whole"), **kw)
        shutil.rmtree(root / "whole")
        try:
            resumable_train_loop(recording("crash"), data,
                                 ckpt_dir=str(root / "crash"),
                                 fail_at_step=2, **kw)
            check(False, "the injected failure did not fire")
        except RuntimeError as e:
            check("injected failure at step 2" in str(e), str(e))
        lines = []
        resumable_train_loop(recording("resumed"), data,
                             ckpt_dir=str(root / "crash"),
                             **dict(kw, log_fn=lines.append))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(lines and lines[0].startswith("[elastic] resumed at step 2"),
          f"resume: {lines[:1]}")
    got = rec["crash"] + rec["resumed"]
    check(got == rec["whole"], f"crash and resume {got} against "
          f"uninterrupted {rec['whole']}")
    print(f"train cut: crashed at step 2, resumed from the step-1 "
          f"checkpoint: losses and grad norms {got} equal the "
          f"uninterrupted run's bit for bit "
          f"({time.perf_counter() - t0:.1f} s with the checkpoints)")
    return {"whole": rec["whole"], "crash_then_resumed": got,
            "bit_for_bit": True}


def train_kernel_rows(gen, flush, launches):
    """(g) K3 with its LSE and K3b at the training cell (B 2, Lq = Lk
    1024, Hq 16, Hkv 2, D 128, causal, bf16): the kernels line's rows,
    with their launches in the full-width run, and a check of each
    against float64.  K3b's library time is SDPA's forward and backward
    less its forward (K / V expanded to the query heads, a yardstick the
    port never calls)."""
    b, lq, hq, hkv, d = TRAIN_BATCH, TRAIN_SEQ, 16, 2, 128
    q, k, v = prefill_case(gen, b, lq, lq, hq, hkv, d)
    do = rand(gen, (b, lq, hq, d))
    o, lse = fprefill.flash_prefill_lse(q, k, v, causal=True)
    got = fprefill.flash_prefill_bwd(q, k, v, o, lse, do, causal=True)
    want = fprefill.prefill_backward_plain(
        *(f64(t) for t in (q, k, v, o, lse, do)), causal=True)
    errs = [normwise(g, w) for g, w in zip(got, want)]
    check(max(errs) <= TRAIN_GRAD_TOL, f"K3b at the training cell: {errs}")
    bwd_err = max(float((g.double() - w).abs().max())
                  for g, w in zip(got, want))
    fwd_err = max_err(o, fprefill.prefill_plain(f64(q), f64(k), f64(v),
                                                causal=True), PREFILL_TOL)
    fwd_flops = 4 * b * hq * d * lq * (lq + 1) / 2
    qs, ks, vs, dos = (t.transpose(1, 2).contiguous() for t in (
        q, k.repeat_interleave(hq // hkv, dim=2),
        v.repeat_interleave(hq // hkv, dim=2), do))
    leaves = [t.detach().requires_grad_(True) for t in (qs, ks, vs)]

    def sdpa_fwd():
        return F.scaled_dot_product_attention(*leaves, is_causal=True,
                                              scale=1.0)

    fb_ms = time_ms(lambda: torch.autograd.grad(sdpa_fwd(), leaves, dos),
                    100, flush)
    f_ms = time_ms(sdpa_fwd, 100, flush)
    shape = (f"B{b} Lq=Lk={lq} Hq{hq} Hkv{hkv} D{d} causal bf16, training "
             f"cell")
    rows = [dict(
        name="flash_prefill", shape=shape + ", with its LSE",
        fn=functools.partial(fprefill.flash_prefill_lse, q, k, v,
                             causal=True),
        plain=lambda: (prefill_plain(q, k, v, causal=True),
                       fprefill.prefill_lse_plain(q, k, causal=True)),
        lib=functools.partial(F.scaled_dot_product_attention,
                              *(t.transpose(1, 2) for t in (q, k, v)),
                              is_causal=True, scale=1.0, enable_gqa=True),
        nbytes=2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel(),
        flops=fwd_flops, err=fwd_err,
        launches=launches["flash_prefill"]), dict(
        name="flash_prefill_bwd", shape=shape,
        fn=functools.partial(fprefill.flash_prefill_bwd, q, k, v, o, lse, do,
                             causal=True),
        plain=functools.partial(fprefill.prefill_backward_plain, q, k, v, o,
                                lse, do, causal=True),
        lib=None, library_ms=fb_ms - f_ms,
        # q, k, v, o, do and the LSE read; dq, dk, dv written
        nbytes=2 * (3 * q.numel() + 2 * k.numel() + 2 * v.numel()
                    + do.numel()) + 4 * lse.numel(),
        flops=2.5 * fwd_flops, err=bwd_err, tol=TRAIN_GRAD_TOL,
        launches=launches["flash_prefill_bwd"])]
    print(f"K3b at the training cell against float64, normwise: dq "
          f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (tol "
          f"{TRAIN_GRAD_TOL}); SDPA forward+backward {fb_ms:.4f} ms, "
          f"forward {f_ms:.4f} ms")
    return {"k3b_normwise": errs, "sdpa_fwd_bwd_ms": fb_ms,
            "sdpa_fwd_ms": f_ms}, rows


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
                             "archs", "tune", "moe", "obs", "mla",
                             "vlm", "encdec", "hybrid", "ssm", "shard",
                             "tp", "train"),
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
                         "on and off and runs the CLI with them; 'mla' "
                         "builds, then serves minicpm3-4b; 'vlm' builds, "
                         "then serves paligemma-3b and runs its patch "
                         "prefill; 'encdec' builds, then serves "
                         "whisper-large-v3 and runs its frame prefill; "
                         "'hybrid' builds, then serves recurrentgemma-9b "
                         "and runs a prefill past its ring; 'ssm' builds, "
                         "then serves mamba2-780m and checks its scan; "
                         "'shard' builds, then serves qwen2.5-3b at dp 4 "
                         "and sequence-sharded at sp 4; 'tp' builds, then "
                         "serves qwen2.5-3b tensor-parallel and "
                         "granite-moe-3b-a800m expert-parallel and runs "
                         "the frozen mesh step builders; 'train' builds, "
                         "then trains qwen2.5-3b at full width on the "
                         "prefill kernel and its backward")
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
    if args.phase == "train":
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
        train, rows = timed("train", phase_train, args.seed, flush)
        print(json.dumps({"train": train, "card": card}))
        print(card)
        print(json.dumps({"kernels": kernel_line(rows, flush)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.phase in ("mla", "vlm", "encdec", "hybrid", "ssm"):
        fn = {"mla": phase_mla, "vlm": phase_vlm, "encdec": phase_encdec,
              "hybrid": phase_hybrid, "ssm": phase_ssm}[args.phase]
        res = timed(args.phase, fn, args.seed, sms)
        print(json.dumps({args.phase: res, "card": card}))
        return 0
    if args.phase not in ("paged", "spec", "tune", "obs", "shard", "tp"):
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
    if args.phase == "shard":
        shard = timed("shard", phase_shard, model, params, cfg, args.seed)
        print(json.dumps({"shard": shard, "card": card}))
        return 0
    if args.phase == "tp":
        tp = timed("tp", phase_tp, model, params, cfg, args.seed)
        print(json.dumps({"tp": tp, "card": card}))
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
    shard = timed("shard", phase_shard, model, params, cfg, args.seed)
    tp = timed("tp", phase_tp, model, params, cfg, args.seed,
               DEFAULT_RUN_LAYERS["moe"])
    # speculation keeps the full depth: how many verify steps its cell
    # takes depends on the streams, and its check counts 4 of them
    spec = timed("spec", phase_spec, model, params, cfg, args.seed)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    # training at full width and depth, once the serving model is freed
    train, train_rows = timed("train", phase_train, args.seed, flush)
    # the later qwen2.5-3b paths on a model cut in depth, from the seed
    cut = cut_depth(cfg, DEFAULT_RUN_LAYERS["qwen"])
    model = build_model(cut, device=DEVICE)
    params = model.init_params(args.seed)
    paged = phase_paged_all(model, params, cut, args.seed)
    tune = timed("tune", phase_tune, model, params, cut, args.seed, sms)
    obs = timed("obs", phase_obs, model, params, cut, args.seed)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    archs = timed("archs", phase_archs, args.seed,
                  DEFAULT_RUN_LAYERS["archs"])
    moe = timed("moe", phase_moe, args.seed, DEFAULT_RUN_LAYERS["moe"])
    mla = timed("mla", phase_mla, args.seed, sms,
                DEFAULT_RUN_LAYERS["mla"])
    vlm = timed("vlm", phase_vlm, args.seed, sms,
                DEFAULT_RUN_LAYERS["vlm"])
    encdec = timed("encdec", phase_encdec, args.seed, sms,
                   DEFAULT_RUN_LAYERS["encdec"])
    hybrid = timed("hybrid", phase_hybrid, args.seed, sms,
                   DEFAULT_RUN_LAYERS["hybrid"])
    ssm = timed("ssm", phase_ssm, args.seed, sms)
    table1, table1_rows = timed("table1", phase_table1, gen, sms, card,
                                flush)
    extra = [verify_kernel_row(gen, sms, spec)] + arch_kernel_rows(
        gen, sms, archs) + arch_kernel_rows(gen, sms, moe) + \
        single_kv_head_rows(gen, sms, mla, vlm) + \
        side_shape_rows(gen, sms, encdec, hybrid) + \
        shard_kernel_rows(gen, sms, shard) + tp_kernel_rows(gen, sms, tp) + \
        train_rows
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
                      "archs": archs, "moe": moe, "mla": mla,
                      "vlm": vlm, "encdec": encdec, "hybrid": hybrid,
                      "ssm": ssm, "shard": shard, "tp": tp,
                      "train": train, "table1": table1,
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
