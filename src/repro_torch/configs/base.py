"""Model and serving configs plus the architecture registry.

Counterpart of ``repro.configs.base``.  Configs are frozen dataclasses,
so they hash, print and diff cleanly and a config file is only data.
``ModelConfig`` keeps the reference's fields of the ported families
(dense, and moe through :class:`MoEConfig`); the attention
implementation is not a config knob here, because the kernel follows the
tensor's device (see ``repro_torch.kernels.ops``).  ``ServeConfig``
carries the serving fields: planning, admission, the KV-cache format,
its layout (dense or paged, with prefix sharing), speculation and the
observability artifacts (``trace_path``, ``metrics_path``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional


# the model families the port serves, and those of the reference it does
# not serve yet: reducing a config or building a model of one raises
PORTED_FAMILIES = ("dense", "moe")
UNPORTED_FAMILIES = ("mla", "encdec", "vlm", "ssm", "hybrid")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                      # per-expert FFN hidden dim
    capacity_factor: float = 1.25      # token-dropping capacity dispatch
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01      # load-balance loss
    # token dispatch: "gather" (slot buffers, no one-hot matmuls) |
    # "einsum" (Switch-style one-hot dispatch and combine) |
    # "ep_shard_map" (expert parallelism over a mesh; on one device it
    # runs as "gather", as the reference's does without a mesh)
    dispatch: str = "gather"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe (the ported families)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // num_heads
    mlp_kind: str = "swiglu"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    max_seq_len: int = 524_288
    dtype: str = "bfloat16"            # activations (the cache: ServeConfig)
    param_dtype: str = "bfloat16"
    moe: Optional[MoEConfig] = None    # family="moe": the FFN's experts

    @property
    def resolved_head_dim(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.d_model // self.num_heads)

    @property
    def q_group_size(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless the port serves ``cfg``'s family."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(
            f"the {cfg.family!r} family is not ported yet (ported: "
            f"{', '.join(PORTED_FAMILIES)}; not yet: "
            f"{', '.join(UNPORTED_FAMILIES)})")


@dataclass(frozen=True)
class ServeConfig:
    model: ModelConfig
    # fa3_baseline | paper | tpu_adaptive | measured (the policies in
    # repro_torch.core.split_policy)
    split_policy: str = "paper"
    # explicit split count (FA3's ``num_splits``): the planner freezes
    # it, clamped per shape to num_n_blocks.  None = the policy decides.
    num_splits_override: Optional[int] = None
    # split_policy="measured": the calibrated repro_torch.tune SplitTable
    # the engine's Planner decides from, a file or a registry directory
    # (experiments/tune/h100/; calibrate one with `python -m
    # repro_torch.launch.tune --h100`).  ServingEngine(tune_table=...)
    # takes a table object, which wins.
    tune_table_path: Optional[str] = None
    # when set, ServingEngine.drain() writes PlanCacheStats.to_json()
    # (with the policy and the table's version) here
    stats_path: Optional[str] = None
    # repro_torch.obs: when set, drain() writes the Chrome trace-event
    # JSON of the serving timeline here (request lifecycle spans and
    # per-launch spans stamped with LaunchPlan provenance); load it at
    # https://ui.perfetto.dev.  Host-side only; None = no tracing (the
    # zero-cost NULL_OBSERVER path).
    trace_path: Optional[str] = None
    # repro_torch.obs: when set, drain() writes the metrics artifact here
    # (TTFT / TPOT / queue-wait / launch histograms, occupancy gauges,
    # token and warning counters, plus the PlanCacheStats section).  A
    # ".prom" / ".txt" suffix selects Prometheus text exposition; any
    # other suffix gets the JSON snapshot.
    metrics_path: Optional[str] = None
    # cache-length bucket width for plan lookup; the policy reads only
    # ceil(L_K / KV_BLOCK), so any multiple of 128 loses no decision
    seqlen_bucket: int = 128
    # prompt-length bucket width for fused prefill; None = seqlen_bucket
    prefill_bucket: Optional[int] = None
    # resident plan entries, oldest evicted first; 0/None = unbounded
    plan_cache_capacity: Optional[int] = None
    # "fused" = whole prompt in one planned launch; "loop" = one decode
    # step per prompt token; "auto" = fused on the metadata path
    prefill_mode: str = "auto"
    # True: one frozen LaunchPlan per resident-length bucket (the paper's
    # metadata path).  False: the policy runs inside every launch on the
    # padded cache length (the internal-heuristic baseline).
    use_scheduler_metadata: bool = True
    # storage dtype of the K/V cache, independent of the model's
    # activation dtype (a KV_DTYPES name)
    kv_cache_dtype: str = "bfloat16"
    # quantized KV serving: a QUANT_DTYPES name ("int8" | "fp8") that
    # wins over kv_cache_dtype.  The cache holds the storage dtype plus
    # f32 per-(row, head) scales, decode plans are keyed on it, and
    # decode attends through the fused-dequant kernel.  None =
    # kv_cache_dtype rules.
    kv_quant: Optional[str] = None
    # repro_torch.cache storage layout: "dense" = one (B, max_len, ...)
    # block per cache tensor; "paged" = fixed-size pages in a shared pool
    # plus per-slot page tables, decode views gathered per resident
    # bucket, admission gated on free pages.  Paged rides the metadata
    # path.
    cache_layout: str = "dense"
    # paged layout: rows per page.  Must divide seqlen_bucket and
    # prefill_bucket (views are gathered per resident bucket).
    cache_page_size: int = 64
    # paged layout: data pages in the pool.  None = dense-equivalent
    # (batch_slots * ceil(max_len / page_size)).  Smaller budgets
    # oversubscribe slots; exhaustion mid-generation finishes that
    # request with finish_reason="cache_capacity".
    cache_page_budget: Optional[int] = None
    # paged layout: share identical prompt prefixes across requests
    # (per-page refcounts, a token-keyed prefix trie, copy-on-write);
    # only the unshared suffix is prefilled, as an ("sprefill", ...)
    # planned launch.  Needs cache_layout="paged" and fused prefill.
    share_prefix: bool = False
    # share_prefix: max pages the trie keeps anchored beyond their
    # owners (None = the pool is the only bound); anchored-only pages
    # are evicted leaf-first LRU.
    prefix_capacity: Optional[int] = None
    # repro_torch.spec: the engine-wide speculative-decoding default, a
    # drafter name ("ngram" | "prompt_lookup" | a registered one) every
    # request decodes with unless its SamplingParams.speculation says
    # otherwise.  None = plain decode.  Rides the metadata-enabled plan
    # path (verify launches are planned under ("verify", k, bucket) keys).
    speculation: Optional[str] = None
    # draft tokens proposed per verify step (1..64)
    speculation_k: int = 4
    # consecutive zero-accept verify steps before the engine stops
    # speculating for that request (None = never)
    speculation_max_rejects: Optional[int] = None
    seed: int = 0


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_arch(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from repro_torch.configs import _load_all  # noqa: PLC0415
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
