"""AttentionSpec: the declarative input to the planner.

Counterpart of ``repro.plan.spec``: the decode, prefill and verify
kinds.  A spec says WHAT is launched (kind and shapes); the
:class:`Planner` decides HOW (the split count) and freezes it in a
:class:`LaunchPlan`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.split_policy import KV_BLOCK, KV_DTYPES, DecodeWorkload

# ``verify`` is the speculative-decoding verify step: decode with a
# k + 1-row query block (seqlen_q = draft length + 1), planned by the same
# split policy over a workload whose ``num_m_blocks`` scales with the
# query rows.
KINDS = ("decode", "prefill", "verify")


def bucket_seqlen(seqlen_k: int, bucket: int = KV_BLOCK) -> int:
    """Round a cache length up to its bucket.  The policy reads only
    ``num_n_blocks``, so a multiple of the KV block loses nothing."""
    return ((max(1, seqlen_k) + bucket - 1) // bucket) * bucket


@dataclass(frozen=True)
class AttentionSpec:
    """One attention launch: the paper's (Batch, L_Q, L_K, H_Q, H_KV, D)
    plus the launch kind, a sliding ``window`` and MLA's ``v_width``
    (the reference's launch extras), the KV-cache dtype name, and the
    mesh axis the launch may sequence-shard over (set by
    ``Planner.mesh_plan``)."""
    kind: str                           # one of KINDS
    batch: int
    seqlen_q: int
    seqlen_k: int
    num_heads_q: int
    num_heads_kv: int
    head_dim: int = 128
    window: Optional[int] = None        # sliding window: L_K = min(w, L)
    v_width: Optional[int] = None       # MLA latent: v = k[..., :v_width]
    kv_dtype: str = "bfloat16"          # a KV_DTYPES name
    mesh_axis: Optional[str] = None     # sharding axis name (mesh plans)
    mesh_axis_size: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown attention kind {self.kind!r}; known: {KINDS}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"unknown kv_dtype {self.kv_dtype!r}; "
                f"known: {sorted(KV_DTYPES)}")

    def workload(self) -> DecodeWorkload:
        """The policy-facing shape tuple (a windowed launch reads at most
        ``window`` rows)."""
        lk = self.seqlen_k if self.window is None \
            else min(self.window, self.seqlen_k)
        return DecodeWorkload(self.batch, self.seqlen_q, lk,
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

    @classmethod
    def verify(cls, batch: int, seqlen_q: int, seqlen_k: int,
               num_heads_q: int, num_heads_kv: int, head_dim: int = 128,
               **kw) -> "AttentionSpec":
        """Speculative-decoding verify step: a ``seqlen_q``-row query
        block (the committed current token and k drafts) against the KV
        cache, causal within the block at each slot's own offset.  The
        same sequence-aware policy as decode plans its splits; the k-row
        block shifts ``num_m_blocks``, and with it the occupancy."""
        return cls("verify", batch, seqlen_q, seqlen_k, num_heads_q,
                   num_heads_kv, head_dim, **kw)

    @classmethod
    def from_workload(cls, w: DecodeWorkload, kind: str = "decode",
                      **kw) -> "AttentionSpec":
        kw.setdefault("kv_dtype", w.kv_dtype_name)
        return cls(kind, w.batch, w.seqlen_q, w.seqlen_k, w.num_heads_q,
                   w.num_heads_kv, w.head_dim, **kw)
