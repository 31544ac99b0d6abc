"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``

Counterpart of ``repro.launch.serve``.  Random-inits a reduced model from
a seed and drives :class:`~repro_torch.serving.ServingEngine` (submit /
step / drain) over the reference's synthetic request stream, printing
per-request completions and the reference's summary lines.  ``--policy``
A/Bs the paper's heuristic against FA3's baseline on the same requests;
``--stream`` prints TOKEN / FINISHED events as the engine emits them;
``--prefill`` switches between fused bucketed admission and the
teacher-forcing loop; ``--cache-layout paged`` and ``--share-prefix``
serve from the paged cache, sharing the system prompt's pages;
``--kv-quant`` stores the cache in int8 or fp8;
``--temperature`` / ``--top-k`` / ``--top-p`` select seeded sampling
(default greedy) through ``--sampler``; ``--speculate`` decodes through
verify launches with a registered drafter; ``--policy measured
--tune-table`` decides splits from a calibrated table (a file, or a
registry directory such as ``experiments/tune/h100/``) and
``--stats-path`` writes the plan-cache counters at drain; ``--trace``
writes the Chrome trace-event JSON of the serving timeline and
``--metrics`` the metrics snapshot (Prometheus text for a ``.prom`` /
``.txt`` suffix, else JSON) at drain.  ``--arch`` takes every ported
config, the moe ones (granite-moe-3b-a800m, qwen3-moe-235b-a22b)
included.  It runs on the card unless ``--device cpu`` is given.

One difference from the reference: the default ``d_model`` is 512, not
128.  The reduced config keeps 4 query heads, so the reference's default
gives head_dim 32, and the port's kernels take head_dim 64, 128, 160 or
256; 512 gives 128.  The reference's ``--mesh`` flag is not ported yet.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.split_policy import available_policies
from repro_torch.models import build_model
from repro_torch.serving import (
    FINISHED,
    TOKEN,
    Request,
    SamplingParams,
    ServingEngine,
    get_sampler,
)


def run_serving(arch: str, *, num_requests: int = 8, max_new: int = 16,
                policy: str = "paper", batch_slots: int = 4,
                max_len: int = 256, d_model: int = 512,
                num_layers: int = 2, seed: int = 0,
                num_splits_override: Optional[int] = None,
                temperature: float = 0.0, top_k: int = 0,
                top_p: float = 1.0, sampler: str = "categorical",
                prefill_mode: str = "auto", stream: bool = False,
                cache_layout: str = "dense", share_prefix: bool = False,
                speculate: Optional[str] = None, speculate_k: int = 4,
                speculate_max_rejects: Optional[int] = None,
                kv_quant: Optional[str] = None, tune_table=None,
                stats_path=None, trace_path=None, metrics_path=None,
                device=None, log_fn=print):
    """Serve the reference's request stream on a reduced ``arch`` and log
    the summary; returns the completions.  ``device=None`` is the card."""
    cfg = reduced_config(get_arch(arch), num_layers=num_layers,
                         d_model=d_model)
    model = build_model(cfg, device=device)
    params = model.init_params(seed)
    scfg = ServeConfig(model=cfg, split_policy=policy,
                       num_splits_override=num_splits_override,
                       prefill_mode=prefill_mode, cache_layout=cache_layout,
                       share_prefix=share_prefix, speculation=speculate,
                       speculation_k=speculate_k,
                       speculation_max_rejects=speculate_max_rejects,
                       kv_quant=kv_quant,
                       tune_table_path=(str(tune_table) if tune_table
                                        else None),
                       stats_path=(str(stats_path) if stats_path
                                   else None),
                       trace_path=(str(trace_path) if trace_path
                                   else None),
                       metrics_path=(str(metrics_path) if metrics_path
                                     else None))
    engine = ServingEngine(model, scfg, max_len=max_len,
                           batch_slots=batch_slots,
                           sampler=get_sampler(sampler), device=device)
    engine.load(params)

    rng = np.random.default_rng(seed)
    # --share-prefix traffic: every request opens with the same "system
    # prompt" (long enough to span full pages), then a short unique tail
    system = (rng.integers(0, cfg.vocab_size, size=96).tolist()
              if share_prefix else [])
    reqs: List[Request] = [
        Request(i, system
                + rng.integers(0, cfg.vocab_size,
                               size=rng.integers(4, 12)).tolist(),
                max_new_tokens=max_new,
                sampling=SamplingParams(temperature=temperature,
                                        top_k=top_k, top_p=top_p,
                                        seed=seed + i))
        for i in range(num_requests)]
    t0 = time.monotonic()
    handles = [engine.submit(r) for r in reqs]
    if stream:
        while engine.has_work():
            for ev in engine.step():
                if ev.kind == TOKEN:
                    log_fn(f"req {ev.request_id} token[{ev.index}] = "
                           f"{ev.token}")
                elif ev.kind == FINISHED:
                    log_fn(f"req {ev.request_id} finished "
                           f"({ev.finish_reason})")
    outs = engine.drain()
    dt = time.monotonic() - t0
    total_new = sum(len(c.tokens) for c in outs)
    for c in outs:
        log_fn(f"req {c.request_id}: prompt {len(c.prompt)} toks -> "
               f"{c.tokens[:8]}{'...' if len(c.tokens) > 8 else ''}")
    log_fn(f"policy={policy}: {len(outs)} requests, {total_new} tokens "
           f"in {dt:.2f}s ({1e3 * dt / max(1, total_new):.1f} ms/token)")
    log_fn("frozen plans (bucket -> num_splits): "
           f"{engine.planned_splits()}")
    if kv_quant:
        nbytes = engine.sched.decode_spec(128).workload().dtype_bytes
        log_fn(f"kv quant: {kv_quant} storage + f32 scales "
               f"(plans keyed on the {kv_quant} family, "
               f"dtype_bytes={nbytes})")
    if engine.tune_table is not None:
        st = engine.stats
        log_fn(f"measured policy: table {engine.tune_table.version}, "
               f"{st.measured_lookups} lookups, "
               f"{st.measured_fallbacks} fallbacks to "
               f"'{engine.tune_table.fallback_policy}'")
    if stats_path:
        log_fn(f"plan-cache stats snapshot: {stats_path}")
    if trace_path:
        log_fn(f"request-lifecycle trace (load at https://ui.perfetto.dev"
               f"): {trace_path}")
    if metrics_path:
        log_fn(f"serving metrics snapshot: {metrics_path}")
    if cache_layout == "paged":
        cs = engine.cache_stats()
        log_fn(f"paged cache: {cs['total_pages']} pages of "
               f"{cs['page_size']} ({cs['storage_bytes']} B vs dense "
               f"{cs['dense_bytes']} B), {cs['free_pages']} free")
        if share_prefix:
            log_fn(f"prefix sharing: {cs['prefix_hits']} hits, "
                   f"{cs['prefix_shared_rows']} prompt rows reused, "
                   f"{cs['pages_allocated_total']} pages allocated, "
                   f"{cs['prefix_copies']} page copies, "
                   f"{cs['prefix_anchored_pages']} anchored")
    if engine.prefill_mode == "fused":
        log_fn("fused prefill buckets: "
               f"{engine.planned_prefill_buckets()}")
    if speculate:
        st = engine.stats
        log_fn(f"speculation ({speculate}, k={speculate_k}): "
               f"{st.spec_steps} verify steps, acceptance "
               f"{st.spec_acceptance_rate:.2f} "
               f"({st.spec_accepted}/{st.spec_proposed} drafts), "
               f"{st.spec_tokens_per_step:.2f} tokens/step, "
               f"{st.spec_disabled} requests disabled; verify plans "
               f"{engine.sched.planned_verify_keys()}")
    assert len(handles) == len(outs)
    return outs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--policy", default="paper",
                    choices=available_policies())
    ap.add_argument("--tune-table", default=None,
                    help="calibrated repro_torch.tune SplitTable for "
                         "--policy measured: a JSON file or a registry "
                         "directory (write one with `python -m "
                         "repro_torch.launch.tune --h100`)")
    ap.add_argument("--stats-path", default=None,
                    help="write PlanCacheStats.to_json() here at drain")
    ap.add_argument("--trace", default=None, dest="trace_path",
                    help="write the Chrome trace-event JSON serving "
                         "timeline here at drain (load it at "
                         "https://ui.perfetto.dev)")
    ap.add_argument("--metrics", default=None, dest="metrics_path",
                    help="write the serving metrics snapshot here at drain "
                         "(a .prom / .txt suffix selects Prometheus text "
                         "exposition, else JSON)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--splits", type=int, default=None,
                    help="explicit num_splits override: the engine's "
                         "Planner bypasses the policy (FA3's explicit "
                         "num_splits argument)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus truncation (1.0 = off)")
    ap.add_argument("--sampler", default="categorical",
                    help="sampler registry name (greedy | categorical; "
                         "extensible via repro_torch.serving."
                         "register_sampler)")
    ap.add_argument("--prefill", default="auto",
                    choices=("auto", "fused", "loop"),
                    help="admission path: fused bucketed prefill vs the "
                         "teacher-forcing loop")
    ap.add_argument("--cache-layout", default="dense",
                    choices=["dense", "paged"],
                    help="cache storage layout (paged: resident-bucket "
                         "views + page-budget admission)")
    ap.add_argument("--share-prefix", action="store_true",
                    help="share identical prompt prefixes across requests "
                         "(refcounted copy-on-write pages; requires "
                         "--cache-layout paged)")
    ap.add_argument("--speculate", default=None,
                    help="speculative decoding: drafter registry name "
                         "(ngram | prompt_lookup; extensible via "
                         "repro_torch.spec.register_drafter)")
    ap.add_argument("--speculate-k", type=int, default=4,
                    help="draft tokens per verify step (with --speculate)")
    ap.add_argument("--speculate-max-rejects", type=int, default=None,
                    help="consecutive zero-accept verify steps before a "
                         "request stops speculating (default: never)")
    ap.add_argument("--kv-quant", default=None, choices=["int8", "fp8"],
                    help="quantized KV cache: int8 or fp8 storage + f32 "
                         "scales, read by the quantized decode kernel")
    ap.add_argument("--stream", action="store_true",
                    help="print TOKEN/FINISHED events as they happen")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    run_serving(args.arch, num_requests=args.requests,
                max_new=args.max_new, policy=args.policy,
                batch_slots=args.slots, num_splits_override=args.splits,
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, sampler=args.sampler,
                prefill_mode=args.prefill, stream=args.stream,
                cache_layout=args.cache_layout,
                share_prefix=args.share_prefix, speculate=args.speculate,
                speculate_k=args.speculate_k,
                speculate_max_rejects=args.speculate_max_rejects,
                kv_quant=args.kv_quant, tune_table=args.tune_table,
                stats_path=args.stats_path, trace_path=args.trace_path,
                metrics_path=args.metrics_path, device=args.device)


if __name__ == "__main__":
    main()
