"""AttentionSpec: the declarative input to the planner.

Counterpart of ``repro.plan.spec``, decode and prefill kinds.  A spec
says WHAT is launched (kind and shapes); the :class:`Planner` decides
HOW (the split count) and freezes it in a :class:`LaunchPlan`.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.split_policy import KV_BLOCK, KV_DTYPES, DecodeWorkload

KINDS = ("decode", "prefill")


def bucket_seqlen(seqlen_k: int, bucket: int = KV_BLOCK) -> int:
    """Round a cache length up to its bucket.  The policy reads only
    ``num_n_blocks``, so a multiple of the KV block loses nothing."""
    return ((max(1, seqlen_k) + bucket - 1) // bucket) * bucket


@dataclass(frozen=True)
class AttentionSpec:
    """One attention launch: the paper's (Batch, L_Q, L_K, H_Q, H_KV, D)
    plus the launch kind and the KV-cache dtype name."""
    kind: str                           # one of KINDS
    batch: int
    seqlen_q: int
    seqlen_k: int
    num_heads_q: int
    num_heads_kv: int
    head_dim: int = 128
    kv_dtype: str = "bfloat16"          # a KV_DTYPES name

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown attention kind {self.kind!r}; known: {KINDS}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"unknown kv_dtype {self.kv_dtype!r}; "
                f"known: {sorted(KV_DTYPES)}")

    def workload(self) -> DecodeWorkload:
        """The policy-facing shape tuple."""
        return DecodeWorkload(self.batch, self.seqlen_q, self.seqlen_k,
                              self.num_heads_q, self.num_heads_kv,
                              self.head_dim,
                              dtype_bytes=KV_DTYPES[self.kv_dtype],
                              kv_dtype=self.kv_dtype)

    @classmethod
    def decode(cls, batch: int, seqlen_k: int, num_heads_q: int,
               num_heads_kv: int, head_dim: int = 128,
               **kw) -> "AttentionSpec":
        """One new query token per sequence against a KV cache."""
        return cls("decode", batch, 1, seqlen_k, num_heads_q, num_heads_kv,
                   head_dim, **kw)

    @classmethod
    def prefill(cls, batch: int, seqlen: int, num_heads_q: int,
                num_heads_kv: int, head_dim: int = 128,
                **kw) -> "AttentionSpec":
        """Causal self-attention over a bucket-padded prompt
        (L_Q = L_K).  Prefill never splits KV, but it is planned,
        cached and counted like any other launch."""
        return cls("prefill", batch, seqlen, seqlen, num_heads_q,
                   num_heads_kv, head_dim, **kw)
