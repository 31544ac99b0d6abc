"""Plain PyTorch reference oracles for the attention kernels.

Counterpart of ``repro.kernels.ref``: materialising attention, one
split's unnormalised decode partial, and the log-sum-exp combine.  All
arithmetic is float32, or float64 when the query is float64 (an exact
oracle for checks on ill-conditioned inputs); outputs take the query's
dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # finite -inf stand-in: keeps masked softmax NaN-free


def acc_dtype(q: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic dtype for a query ``q``: float64
    for a float64 query, else float32."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def naive_attention(
    q: torch.Tensor,       # (B, Lq, Hq, D)
    k: torch.Tensor,       # (B, Lk, Hkv, D)
    v: torch.Tensor,       # (B, Lk, Hkv, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Materialising attention; ``q_offset`` is the absolute position of
    ``q[:, 0]``."""
    B, Lq, Hq, D = q.shape
    _, Lk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    dt = acc_dtype(q)
    qg = (q.to(dt) * scale).reshape(B, Lq, Hkv, g, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(dt))
    qpos = torch.arange(Lq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(dt))
    return out.reshape(B, Lq, Hq, Dv).to(q.dtype)


def naive_decode_attention(
    q: torch.Tensor,       # (B, Hq, D): one new token per sequence
    k: torch.Tensor,       # (B, Lk, Hkv, D)
    v: torch.Tensor,
    kv_len: torch.Tensor,  # (B,) valid cache lengths
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, Hq, D = q.shape
    _, Lk, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    dt = acc_dtype(q)
    qf = (q.to(dt) * scale).reshape(B, Hkv, g, D)
    scores = torch.einsum("bhgd,bkhd->bhgk", qf, k.to(dt))
    valid = torch.arange(Lk, device=q.device)[None, :] \
        < kv_len.to(q.device)[:, None]
    scores = torch.where(valid[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.to(dt))
    return out.reshape(B, Hq, v.shape[-1]).to(q.dtype)


def decode_partial(
    q: torch.Tensor,       # (B, Hkv, g, D) float32 or float64, pre-scaled
    k_chunk: torch.Tensor,  # (B, C, Hkv, D)
    v_chunk: torch.Tensor,  # (B, C, Hkv, Dv)
    valid: torch.Tensor,   # (B, C) bool
):
    """One split's unnormalised partial ``(acc, l, m)``.  A fully masked
    chunk keeps ``m`` at ``NEG_INF`` with ``l = 0`` and ``acc = 0``."""
    s = torch.einsum("bhgd,bkhd->bhgk", q, k_chunk.to(q.dtype))
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(valid[:, None, None], p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v_chunk.to(q.dtype))
    return acc, l, m


def lse_combine(accs: torch.Tensor, ls: torch.Tensor,
                ms: torch.Tensor) -> torch.Tensor:
    """Merge S unnormalised partials. accs: (S,B,H,g,D), ls/ms: (S,B,H,g)."""
    m_glob = ms.amax(dim=0)
    w = torch.exp(ms - m_glob[None])
    num = (accs * w[..., None]).sum(dim=0)
    den = (ls * w).sum(dim=0)
    return num / torch.clamp(den[..., None], min=1e-30)
