"""GQA attention block with a dense KV cache.

Counterpart of ``repro.models.attention`` (full attention, bf16/f32 KV).
Cache layout per layer is ``(B, max_len, H_kv, D)``, as in the
reference.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import ParamSpec, Rope, SpecModule, \
    apply_rope
from repro_torch.plan import LaunchPlan


class Attention(SpecModule):
    """Attention weights in the reference layout: ``wq`` (d, Hq, D),
    ``wk`` / ``wv`` (d, Hkv, D), ``wo`` (Hq, D, d), optional biases."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        d, hd = cfg.d_model, cfg.resolved_head_dim
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        specs = {
            "wq": ParamSpec((d, hq, hd)),
            "wk": ParamSpec((d, hkv, hd)),
            "wv": ParamSpec((d, hkv, hd)),
            "wo": ParamSpec((hq, hd, d), fan_in=hq * hd),
        }
        if cfg.qkv_bias:
            specs["bq"] = ParamSpec((hq, hd), init="zeros")
            specs["bk"] = ParamSpec((hkv, hd), init="zeros")
            specs["bv"] = ParamSpec((hkv, hd), init="zeros")
        super().__init__(specs, dtype, device)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bld,dhk->blhk") as one matmul."""
    B, L, d = x.shape
    return (x @ w.reshape(d, -1)).view(B, L, w.shape[1], w.shape[2])


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 rope: Rope
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, L, d) -> q (B, L, Hq, D), k / v (B, L, Hkv, D), RoPE applied
    (``rope`` from :func:`~repro_torch.models.common.rope_angles`)."""
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq.to(q.dtype)
        k = k + p.bk.to(k.dtype)
        v = v + p.bv.to(v.dtype)
    return apply_rope(q, rope), apply_rope(k, rope), v


def _out_proj(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """einsum("...hk,hkd->...d") as one matmul."""
    return out.flatten(-2) @ p.wo.reshape(-1, p.wo.shape[-1])


def attention_prefill(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                      rope: Rope
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal attention over a whole prompt.  Returns (y (B, L, d), and
    the prompt's K and V rows (B, L, Hkv, D) in the cache dtype, which the
    caller writes into its cache)."""
    q, k, v = _project_qkv(p, cfg, x, rope)
    out = ops.attention(q, k, v, causal=True)
    dt = getattr(torch, cfg.dtype)
    return _out_proj(p, out), k.to(dt), v.to(dt)


def attention_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     t: torch.Tensor, rope: Rope, *,
                     plan: LaunchPlan = None) -> torch.Tensor:
    """One decode step for every slot.  Returns (B, 1, d).

    ``t`` (B,) int64 holds each slot's position and ``rope`` its angles.
    Unlike the reference, which returns an updated copy of the cache,
    this writes the new K/V row of every slot into ``cache_k`` /
    ``cache_v`` (the engine's static (B, max_len, Hkv, D) buffers) IN
    PLACE at row ``t``, then attends over rows ``[0, t]`` through the
    frozen ``plan``.
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x, rope)
    rows = torch.arange(B, device=x.device)
    cache_k[rows, t] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, t] = v_new[:, 0].to(cache_v.dtype)
    out = ops.decode_attention(q[:, 0], cache_k, cache_v, t + 1, plan=plan)
    return _out_proj(p, out)[:, None]
