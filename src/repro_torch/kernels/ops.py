"""Dispatch wrappers around the attention kernels.

Counterpart of ``repro.kernels.ops`` (the ``pallas`` branches).  There is
no implementation knob: a CUDA tensor launches the hand-written kernels
and a CPU tensor runs their plain PyTorch versions, inside each kernel's
wrapper.

``decode_attention`` is the op the paper targets.  Given per-row scales
it reads a quantized (int8 / fp8) cache through the quantized cache's
decode kernel instead; ``decode_attention_quant`` takes the scales as a
:class:`~repro_torch.quant.QuantizedKV`.  Its split count comes
from a frozen :class:`~repro_torch.plan.LaunchPlan`; with no frozen plan
the policy runs inside the call (the paper's internal-heuristic path),
which :func:`policy_eval_count` counts.  A frozen plan's ``bucket`` cuts
the cache to ``k[:, :bucket]`` before the split, so the splits partition
the resident-length bucket rather than the cache's whole capacity.  Rows
at or past ``kv_len`` are masked either way, so it is the same function.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.scheduler_metadata import get_scheduler_metadata
from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_decode_quant import flash_decode_quant
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.plan import LaunchPlan

# How many times the split policy ran inside a decode-attention call.
# The metadata-enabled serving path passes frozen plans and must leave
# it at zero; tests and chip_smoke.py assert exactly that.
_POLICY_EVALS: int = 0


def policy_eval_count() -> int:
    return _POLICY_EVALS


def reset_policy_eval_count() -> None:
    global _POLICY_EVALS
    _POLICY_EVALS = 0


def launch_counts() -> Dict[str, int]:
    """Kernel launches by kernel name, since the last reset."""
    return {name: build.LAUNCHES[name] for name in build.KERNELS}


def launch_counts_by_key(name: str) -> Dict[tuple, int]:
    """Launches of kernel ``name`` by the key its wrapper also counts them
    under (the prefill kernel's: dtype name, Lq; the decode kernel's: view
    length, splits), since the last reset."""
    return {key[1:]: n for key, n in build.LAUNCHES.items()
            if isinstance(key, tuple) and key[0] == name}


def reset_launch_counts() -> None:
    build.LAUNCHES.clear()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0) -> torch.Tensor:
    """Full (prefill) attention: q (B, Lq, Hq, D), k / v (B, Lk, Hkv, D).

    q is scaled by ``D ** -0.5`` in f32 and rounded to its dtype before
    the kernel, as the reference's Pallas path does."""
    qs = (q.float() * q.shape[-1] ** -0.5).to(q.dtype)
    return flash_prefill(qs, k, v, causal=causal, window=window,
                         q_offset=q_offset)


def decode_attention(
    q: torch.Tensor,         # (B, Hq, D): one new token per sequence
    k: torch.Tensor,         # (B, Lk, Hkv, D) KV cache (may be a view)
    v: torch.Tensor,
    kv_len: torch.Tensor,    # (B,) valid lengths
    *,
    k_scale: Optional[torch.Tensor] = None,   # (B, Lk, Hkv) f32
    v_scale: Optional[torch.Tensor] = None,
    plan: Optional[LaunchPlan] = None,
) -> torch.Tensor:
    """Split-KV decode attention; the split count comes from ``plan``.

    Returns (B, Hq, D) in q's dtype.  The decode kernel runs exactly the
    plan's ``num_splits`` splits over ``k[:, :plan.bucket]`` and merges
    them in a fixed order, in one launch.  With ``k_scale`` / ``v_scale``
    the cache is quantized: the quantized cache's decode kernel reads it,
    scales cut to the same bucket, again in one launch.  A context-only
    plan (or none, meaning ``paper`` at 132 SMs) has the policy decide
    here, over the whole cache length.
    """
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    if plan is None or not plan.frozen:
        global _POLICY_EVALS
        _POLICY_EVALS += 1
        ctx = plan if plan is not None else LaunchPlan()
        cores = {} if ctx.num_cores is None else {"num_cores": ctx.num_cores}
        plan = get_scheduler_metadata(B, 1, k.shape[1], Hq, Hkv, D,
                                      policy=ctx.policy, **cores)
    if plan.bucket is not None:
        k = k[:, :plan.bucket]
        v = v[:, :plan.bucket]
        if k_scale is not None:
            k_scale = k_scale[:, :plan.bucket]
            v_scale = v_scale[:, :plan.bucket]
    s = max(1, min(plan.num_splits, k.shape[1]))
    qp = (q.float() * D ** -0.5).to(q.dtype).reshape(B, Hkv, Hq // Hkv, D)
    if k_scale is None:
        out = flash_decode(qp, k, v, kv_len, num_splits=s, out_dtype=q.dtype)
    else:
        out = flash_decode_quant(qp, k, v, k_scale, v_scale, kv_len,
                                 num_splits=s, out_dtype=q.dtype)
    return out.reshape(B, Hq, D)


def decode_attention_quant(q: torch.Tensor, qkv, kv_len: torch.Tensor,
                           **kw) -> torch.Tensor:
    """Split-KV decode over a quantized cache: ``qkv`` is a
    :class:`~repro_torch.quant.QuantizedKV` (or any ``(k, v, k_scale,
    v_scale)``), planned exactly as :func:`decode_attention`."""
    k, v, k_scale, v_scale = qkv
    return decode_attention(q, k, v, kv_len, k_scale=k_scale,
                            v_scale=v_scale, **kw)
