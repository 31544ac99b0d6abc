"""Model and serving configs plus the architecture registry.

Counterpart of ``repro.configs.base``.  Configs are frozen dataclasses,
so they hash, print and diff cleanly and a config file is only data.
``ModelConfig`` keeps the reference's fields of the ported families
(dense; moe through :class:`MoEConfig`; mla through :class:`MLAConfig`;
vlm through :class:`FrontendConfig`'s vision stub; encdec through the
encoder fields and the audio stub; hybrid through
:class:`HybridConfig`; ssm through :class:`SSMConfig`); the attention
implementation is not a config knob here, because the kernel follows the
tensor's device (see ``repro_torch.kernels.ops``).  ``ServeConfig``
carries the serving fields: planning, admission, the KV-cache format,
its layout (dense or paged, with prefix sharing), speculation, the
observability artifacts (``trace_path``, ``metrics_path``) and the
mesh-native topology (``shard``).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple


# the model families the port serves, and those of the reference it does
# not serve yet: reducing a config or building a model of one raises
PORTED_FAMILIES = ("dense", "moe", "mla", "vlm", "encdec", "hybrid", "ssm")
UNPORTED_FAMILIES: Tuple[str, ...] = ()


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
    # "ep_shard_map" (expert parallelism over a bound activation mesh
    # whose model axis divides L; elsewhere "gather", as the reference's)
    dispatch: str = "gather"


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 family)."""
    kv_lora_rank: int = 256            # compressed KV latent dim (the cache)
    q_lora_rank: int = 768
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block parameters."""
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2                    # d_inner = expand * d_model
    ngroups: int = 1
    chunk_size: int = 256
    conv_width: int = 4


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style hybrid: a repeating pattern of recurrent
    (RG-LRU) and local-attention blocks."""
    pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")
    window: int = 2048                 # local-attention window
    lru_width: Optional[int] = None    # defaults to d_model
    conv_width: int = 4


@dataclass(frozen=True)
class FrontendConfig:
    """Stubbed modality frontend: the caller supplies precomputed
    embeddings (``Model.frontend_inputs``)."""
    kind: str = "none"                 # "vision" | "audio" | "none"
    num_positions: int = 0             # patches (vision) / frames (audio)
    embed_dim: int = 0                 # frontend output dim (projected to d_model)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # one of PORTED_FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // num_heads
    mlp_kind: str = "swiglu"           # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    max_seq_len: int = 524_288
    dtype: str = "bfloat16"            # activations (the cache: ServeConfig)
    param_dtype: str = "bfloat16"
    moe: Optional[MoEConfig] = None    # family="moe": the FFN's experts
    mla: Optional[MLAConfig] = None    # family="mla": latent attention
    hybrid: Optional[HybridConfig] = None   # family="hybrid"
    ssm: Optional[SSMConfig] = None    # family="ssm": Mamba-2 SSD blocks
    # family="vlm": the vision stub whose patches prefill prepends;
    # family="encdec": the audio stub whose frames the encoder reads
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    # encoder-decoder (Whisper): encoder layer count (decoder =
    # num_layers) and the fixed encoder length the cross caches hold
    num_encoder_layers: int = 0
    cross_attention: bool = False
    encoder_positions: int = 0

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
            f"{', '.join(UNPORTED_FAMILIES) or 'none'})")


@dataclass(frozen=True)
class ShapeConfig:
    """One workload shape: its sequence length, global batch and kind
    (the reference's)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")


@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW's settings, field for field the reference's."""
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"           # cosine | linear | constant
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    # none | int8_ef (int8 + error feedback): the reference's train step
    # reads it nowhere (only its multi-device tests compress gradients),
    # and neither does the port's
    grad_compression: str = "none"


@dataclass(frozen=True)
class TrainConfig:
    """A training run: the reference's fields but its ``mesh``.  The
    port's grid is an explicit device list
    (:func:`~repro_torch.launch.mesh.make_host_mesh`), given to
    ``build_train_step`` beside the config, so it has no
    ``MeshConfig``."""
    model: ModelConfig
    shape: ShapeConfig = TRAIN_4K
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    microbatches: int = 1              # gradient accumulation steps
    remat_policy: str = "nothing_saveable"   # see training/remat.py
    seed: int = 0
    # the reference's /tmp/repro_ckpt, under the process's temp directory
    checkpoint_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    log_every: int = 10


@dataclass(frozen=True)
class ServeConfig:
    model: ModelConfig
    # the workload shape the frozen mesh step builders
    # (repro_torch.serving.decode_step) compile for: global batch and
    # sequence length
    shape: ShapeConfig = DECODE_32K
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
    # mesh-level split realization of the frozen decode step builder
    # (repro_torch.serving.decode_step): "fused" = one partials launch a
    # device over its sequence chunk, merged by the combine kernel;
    # "auto" = one launch on the lead device whose split is rounded up
    # to a multiple of the model axis
    decode_impl: str = "fused"
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
    # repro_torch.shard: the mesh-native serving topology as a ShardSpec
    # string, "dp,sp" positional (e.g. "4,2") or "dp=4,sp=2" named,
    # parsed by ShardSpec.parse: dp data-parallel slot shards x sp
    # sequence shards each, over dp * sp devices.  None = one
    # ServingEngine on one device (serve --mesh sets this).
    shard: Optional[str] = None
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
