#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Run from the repository root, on a machine with the card and nvcc:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phase kernels # build + kernel parity only

Phases, each fatal on failure:

1. Environment and build: the card's name and power limit, CUDA version,
   SM count; all kernels built from ``src/repro_torch/csrc`` (one nvcc per
   source, in parallel) with ptxas's registers, shared memory and spills.
2. Kernel parity: each kernel against its plain PyTorch version on the
   same CUDA tensors, at the main path's shapes, in bf16 (decode 2e-2,
   prefill 3e-2), plus a same-split-same-bits check.
3. Serving at full width: qwen2.5-3b (36 layers, d_model 2048, 16 query
   heads over 2 KV heads, bf16, seeded random weights) through
   ``ServingEngine`` submit/step/drain: 4 greedy requests, 2 slots.
   Launch counts are zeroed just before and read just after; logits must
   be finite.
4. The paper's cell: one 420-token prompt decoding 64 tokens (every step
   in the 512 bucket) under ``paper`` and ``fa3_baseline``, in turns
   (three runs each), plus the decode kernel alone at that shape; then a
   torch.profiler window over its decode steps (device busy and idle).
5. One JSON ``kernels`` line: per kernel its error, launches on the main
   path, its time (CUDA events, L2 flushed before each launch), the plain
   version's time, the yardstick library call's time, and its bound.

The last line of standard output is ``{"ok": true, "device": {...}}``.
The script exits non-zero, printing no result, without a CUDA device or
outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
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
from repro_torch.kernels.flash_combine import (  # noqa: E402
    combine_plain,
    flash_combine,
)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    decode_partials_plain,
    flash_decode_partials,
)
from repro_torch.kernels.flash_prefill import (  # noqa: E402
    flash_prefill,
    prefill_plain,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.plan import AttentionSpec, Planner  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    TOKEN,
    GreedySampler,
    Request,
    ServingEngine,
)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
DECODE_TOL, PREFILL_TOL = 2e-2, 3e-2
REPLACES = {
    "flash_decode": "src/repro/kernels/flash_decode.py:42",
    "flash_combine": "src/repro/kernels/flash_combine.py:28",
    "flash_prefill": "src/repro/kernels/flash_prefill.py:31",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
DEVICE = "cuda"


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


def time_ms(fn, iters: int, flush) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls, each timed by its
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
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
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
        for line in res.log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                print(f"  ptxas {line.strip()}")
    return card, props.multi_processor_count


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def rand(gen, shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def phase_parity(gen, sms: int):
    errs = {name: 0.0 for name in REPLACES}
    hkv, g, d, cap = 2, 8, 128, 2048
    for b in (1, 2):
        k = rand(gen, (b, cap, hkv, d))
        v = rand(gen, (b, cap, hkv, d))
        q = rand(gen, (b, hkv * g, d))
        for bucket in (128, 512, 2048):
            lens = torch.tensor([bucket - 17, bucket // 2 + 5][:b],
                                device=DEVICE, dtype=torch.int32)
            plan = Planner(policy="paper", num_cores=sms).plan(
                AttentionSpec.decode(b, bucket, hkv * g, hkv, d),
                bucket=bucket)
            kv, vv = k[:, :bucket], v[:, :bucket]       # strided views
            qp = (q.float() * d ** -0.5).to(q.dtype).reshape(b, hkv, g, d)
            for s in sorted({1, 3, plan.num_splits}):
                got = flash_decode_partials(qp, kv, vv, lens, num_splits=s)
                want = decode_partials_plain(qp, kv, vv, lens, num_splits=s)
                e = max_err(combine_plain(*got, out_dtype=q.dtype),
                            combine_plain(*want, out_dtype=q.dtype),
                            DECODE_TOL)
                errs["flash_decode"] = max(errs["flash_decode"], e)
                e = max_err(flash_combine(*got, out_dtype=q.dtype),
                            combine_plain(*got, out_dtype=q.dtype),
                            DECODE_TOL)
                errs["flash_combine"] = max(errs["flash_combine"], e)
                again = flash_combine(*flash_decode_partials(
                    qp, kv, vv, lens, num_splits=s), out_dtype=q.dtype)
                check(torch.equal(again, flash_combine(*got,
                                                       out_dtype=q.dtype)),
                      f"decode B{b} L{bucket} S{s}: same split, other bits")
                full = ops.decode_attention(
                    q, k, v, lens, plan=Planner(num_splits_override=s).plan(
                        AttentionSpec.decode(b, bucket, hkv * g, hkv, d),
                        bucket=bucket))
                max_err(full, ref.naive_decode_attention(q, kv, vv, lens),
                        DECODE_TOL)
                print(f"parity decode B{b} view{bucket} of {cap} S{s} "
                      f"kv_len {lens.tolist()}: ok")
    hq = 16
    for lq, lk, window, off in ((128, 128, None, 0), (200, 200, None, 0),
                                (1024, 1024, None, 0), (512, 512, 128, 0),
                                (64, 320, None, 256)):
        q = (rand(gen, (1, lq, hq, d)).float() * d ** -0.5).to(torch.bfloat16)
        k = rand(gen, (1, lk, hkv, d))
        v = rand(gen, (1, lk, hkv, d))
        got = flash_prefill(q, k, v, causal=True, window=window, q_offset=off)
        want = prefill_plain(q, k, v, causal=True, window=window,
                             q_offset=off)
        errs["flash_prefill"] = max(errs["flash_prefill"],
                                    max_err(got, want, PREFILL_TOL))
        print(f"parity prefill Lq{lq} Lk{lk} window {window} q_offset {off}:"
              f" ok")
    torch.cuda.synchronize()
    print(f"parity max abs errors: {json.dumps(errs)}")
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


def drive(engine, requests):
    """Submit everything, then step to completion.  Returns per-request
    TTFT ms, the ms of steps that only decoded, and the wall seconds."""
    t0 = time.perf_counter()
    submitted = {engine.submit(r): r.request_id for r in requests}
    first, decode_ms = {}, []
    while engine.has_work():
        prefills = sum(v for k, v in engine.stats.launches.items()
                       if isinstance(k, tuple))
        ts = time.perf_counter()
        events = engine.step()       # ends in a host copy of the tokens
        te = time.perf_counter()
        if sum(v for k, v in engine.stats.launches.items()
               if isinstance(k, tuple)) == prefills:
            decode_ms.append((te - ts) * 1e3)
        for ev in events:
            if ev.kind == TOKEN and ev.handle not in first:
                first[ev.handle] = (te - t0) * 1e3
    wall = time.perf_counter() - t0
    return ([first[h] for h in submitted], decode_ms, wall,
            engine.drain())


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def phase_serving(model, params, cfg, seed: int):
    rng = np.random.default_rng(seed)
    lens = (37, 300, 450, 1000)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=32) for i, n in enumerate(lens)]
    # warm-up on a throwaway engine: the same prompt buckets, 2 tokens
    # each, so one-time library set-up stays out of the measured run
    warm = ServingEngine(model, ServeConfig(model=cfg, seed=seed),
                         max_len=2048, batch_slots=2, policy="paper",
                         device=DEVICE)
    warm.load(params)
    drive(warm, [Request(r.request_id, r.prompt, max_new_tokens=2)
                 for r in reqs])
    del warm
    sampler = CheckedGreedy()
    engine = ServingEngine(model, ServeConfig(model=cfg, seed=seed),
                           max_len=2048, batch_slots=2, policy="paper",
                           sampler=sampler, device=DEVICE)
    engine.load(params)
    ops.reset_launch_counts()
    ops.reset_policy_eval_count()
    ttft, decode_ms, wall, done = drive(engine, reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    st = engine.stats
    admissions = sum(v for k, v in st.launches.items()
                     if isinstance(k, tuple))
    steps = sum(v for k, v in st.launches.items() if isinstance(k, int))
    layers = cfg.num_layers
    print(f"serving launches {json.dumps(counts)} admissions {admissions} "
          f"decode steps {steps} plan misses {st.misses} distinct buckets "
          f"{st.distinct_buckets} policy evals {ops.policy_eval_count()}")
    check(bool(sampler.finite.item()), "non-finite logits at full width")
    check(counts["flash_prefill"] == layers * admissions == layers * 4,
          "prefill launches != layers x admissions")
    check(counts["flash_decode"] == layers * steps,
          "decode launches != layers x decode steps")
    check(counts["flash_combine"] == layers * steps,
          "combine launches != layers x decode steps")
    check(ops.policy_eval_count() == 0, "policy evaluated inside a launch")
    check(st.misses == st.distinct_buckets, "plan misses != buckets")
    check([len(c.tokens) for c in done] == [32] * 4, "wrong token counts")
    check(all(c.finish_reason == "length" for c in done), "finish reasons")
    tokens = sum(len(c.tokens) for c in done)
    print(f"serving planned splits {engine.planned_splits()} prefill "
          f"buckets {engine.planned_prefill_buckets()}")
    print(f"serving ttft ms {[round(x, 3) for x in ttft]} median decode "
          f"step ms {median(decode_ms):.3f} over {len(decode_ms)} steps, "
          f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.3f} tokens/s")
    return counts, {"ttft_ms": ttft, "decode_step_ms": median(decode_ms),
                    "tokens_per_s": tokens / wall}


def phase_paper_cell(model, params, cfg, seed: int, flush, sms: int):
    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(0, cfg.vocab_size, 420).tolist()
    runs = {"paper": [], "fa3_baseline": []}
    for policy in ("paper", "fa3_baseline") * 3:
        sampler = CheckedGreedy()
        engine = ServingEngine(model, ServeConfig(model=cfg), max_len=2048,
                               batch_slots=1, policy=policy, sampler=sampler,
                               device=DEVICE)
        engine.load(params)
        _, decode_ms, _, done = drive(
            engine, [Request(0, prompt, max_new_tokens=64)])
        check(bool(sampler.finite.item()), "non-finite logits")
        runs[policy].append((engine.planned_splits(), decode_ms,
                             done[0].tokens,
                             torch.cat(sampler.margins).tolist()))
    out = {}
    for policy, rs in runs.items():
        splits = rs[0][0]
        per_run = [median(r[1]) for r in rs]
        ms = median([m for r in rs for m in r[1]])
        print(f"paper cell {policy}: planned splits {splits} median decode "
              f"step ms {ms:.3f} (per run {[round(x, 3) for x in per_run]})")
        out[policy] = {"splits": splits, "decode_step_ms": ms,
                       "per_run_ms": per_run}
    a, b = runs["paper"][0], runs["fa3_baseline"][0]
    if a[2] == b[2]:
        print("paper cell: token streams match")
    else:
        i = next(j for j, (x, y) in enumerate(zip(a[2], b[2])) if x != y)
        print(f"paper cell: streams differ at token {i}; top-2 logit margin "
              f"there {a[3][i]:.4g} (paper) {b[3][i]:.4g} (fa3_baseline)")
    # the decode kernel alone at this cell's shape: B=1, 512 view
    k = torch.randn((1, 2048, 2, 128), device=DEVICE).to(torch.bfloat16)
    qp = torch.randn((1, 2, 8, 128), device=DEVICE).to(torch.bfloat16)
    lens = torch.tensor([484], device=DEVICE, dtype=torch.int32)
    for s in (1, 3):
        ms = time_ms(lambda: flash_decode_partials(
            qp, k[:, :512], k[:, :512], lens, num_splits=s), 200, flush)
        print(f"paper cell decode kernel B1 view512 kv_len 484 S{s}: "
              f"{ms:.5f} ms")
        out[f"kernel_ms_s{s}"] = ms
    return out


def phase_profile(model, params, cfg, seed: int, steps: int = 8):
    """Where a decode step's time goes: torch.profiler over ``steps``
    decode steps of the paper cell (B=1, 512 bucket, ``paper``).  Reports
    the step's wall ms, the device's busy ms (sum of kernel durations),
    the idle share, and the kernels with the most device time."""
    from torch.autograd import DeviceType
    rng = np.random.default_rng(seed + 1)
    engine = ServingEngine(model, ServeConfig(model=cfg), max_len=2048,
                           batch_slots=1, policy="paper", device=DEVICE)
    engine.load(params)
    engine.submit(Request(0, rng.integers(0, cfg.vocab_size, 420).tolist(),
                          max_new_tokens=steps + 4))
    engine.step()
    engine.step()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy_ms = sum(kernels.values()) / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
           "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
           "top_kernels_ms_per_step": {k[:80]: v / steps for k, v in top}}
    print(f"profile decode step B1 bucket512 paper: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{out['idle_share']:.3f} (profiler on)")
    for name, ms in out["top_kernels_ms_per_step"].items():
        print(f"  {ms:.4f} ms/step  {name}")
    engine.drain()
    return out


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------


def phase_kernels_line(gen, sms: int, errs, counts, flush):
    hkv, g, d, b, cap, bucket = 2, 8, 128, 2, 2048, 1024
    hq = hkv * g
    k = rand(gen, (b, cap, hkv, d))
    v = rand(gen, (b, cap, hkv, d))
    q = rand(gen, (b, hq, d))
    lens = torch.tensor([1000, 450], device=DEVICE, dtype=torch.int32)
    s = Planner(policy="paper", num_cores=sms).plan(
        AttentionSpec.decode(b, bucket, hq, hkv, d)).num_splits
    kv, vv = k[:, :bucket], v[:, :bucket]
    qp = (q.float() * d ** -0.5).to(q.dtype).reshape(b, hkv, g, d)
    parts = flash_decode_partials(qp, kv, vv, lens, num_splits=s)
    rows = int(lens.sum())
    part_bytes = s * b * hkv * g * (d + 2) * 4
    mask = (torch.arange(bucket, device=DEVICE)[None]
            < lens[:, None])[:, None, None]
    qs, ks, vs = q[:, :, None], kv.transpose(1, 2), vv.transpose(1, 2)
    out = []

    dec_bytes = 2 * rows * hkv * d * 2 + qp.numel() * 2 + part_bytes
    dec_flops = 4 * rows * hkv * g * d
    out.append(("flash_decode", f"B{b} view{bucket} of {cap} kv_len "
                f"{lens.tolist()} S{s}",
                lambda: flash_decode_partials(qp, kv, vv, lens,
                                              num_splits=s),
                lambda: decode_partials_plain(qp, kv, vv, lens,
                                              num_splits=s),
                lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=True),
                dec_bytes, dec_flops))
    out.append(("flash_combine", f"S{s} B{b} Hkv{hkv} G{g} D{d}",
                lambda: flash_combine(*parts, out_dtype=torch.bfloat16),
                lambda: combine_plain(*parts, out_dtype=torch.bfloat16),
                None, part_bytes + b * hq * d * 2, 6 * s * b * hq * d))
    lq = 1024
    pq = (rand(gen, (1, lq, hq, d)).float() * d ** -0.5).to(torch.bfloat16)
    pk = rand(gen, (1, lq, hkv, d))
    pv = rand(gen, (1, lq, hkv, d))
    pqs, pks, pvs = (t.transpose(1, 2) for t in (pq, pk, pv))
    out.append(("flash_prefill", f"B1 Lq=Lk={lq} Hq{hq} Hkv{hkv} D{d} causal",
                lambda: flash_prefill(pq, pk, pv, causal=True),
                lambda: prefill_plain(pq, pk, pv, causal=True),
                lambda: F.scaled_dot_product_attention(
                    pqs, pks, pvs, is_causal=True, scale=1.0,
                    enable_gqa=True),
                2 * (pq.numel() + pk.numel() + pv.numel() + pq.numel()),
                4 * hq * d * lq * lq / 2))
    kernels = []
    for name, shape, fn, plain, lib, nbytes, flops in out:
        ms = time_ms(fn, 100, flush)
        plain_ms = time_ms(plain, 10, flush)
        lib_ms = time_ms(lib, 100, flush) if lib is not None else None
        bms, by = bound(nbytes, flops)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "shape": shape,
            "launches": counts[name], "max_abs_err": errs[name],
            "tol": PREFILL_TOL if name == "flash_prefill" else DECODE_TOL,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms})
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("all", "kernels"), default="all",
                    help="'kernels' stops after build and kernel parity")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    card, sms = phase_env_build()
    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
    errs = phase_parity(gen, sms)
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
    counts, serving = phase_serving(model, params, cfg, args.seed)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    paper = phase_paper_cell(model, params, cfg, args.seed, flush, sms)
    profile = phase_profile(model, params, cfg, args.seed)
    del params, model
    torch.cuda.empty_cache()
    kernels = phase_kernels_line(gen, sms, errs, counts, flush)
    print(json.dumps({"serving": serving, "paper_cell": paper,
                      "profile": profile, "card": card}))
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
