"""Model and serving configs plus the architecture registry.

Counterpart of ``repro.configs.base``.  Configs are frozen dataclasses,
so they hash, print and diff cleanly and a config file is only data.
``ModelConfig`` keeps the reference's dense-family fields; the attention
implementation is not a config knob here, because the kernel follows the
tensor's device (see ``repro_torch.kernels.ops``).  ``ServeConfig``
carries the dense-path serving fields and the KV-cache format.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense (the only family ported yet)
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

    @property
    def resolved_head_dim(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.d_model // self.num_heads)

    @property
    def q_group_size(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ServeConfig:
    model: ModelConfig
    # fa3_baseline | paper (the policies in repro_torch.core.split_policy)
    split_policy: str = "paper"
    # explicit split count (FA3's ``num_splits``): the planner freezes
    # it, clamped per shape to num_n_blocks.  None = the policy decides.
    num_splits_override: Optional[int] = None
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
