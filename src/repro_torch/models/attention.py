"""GQA attention block with a dense KV cache.

Counterpart of ``repro.models.attention`` (full attention).  A layer's
cache is a dict of the engine's static tensors: ``k`` / ``v`` of shape
``(B, max_len, H_kv, D)`` in the KV dtype, plus ``k_s`` / ``v_s`` f32
scales of shape ``(B, max_len, H_kv)`` when the cache is quantized
(int8 or fp8), as in the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import ParamSpec, Rope, SpecModule, \
    apply_rope
from repro_torch.plan import LaunchPlan
from repro_torch.quant import QUANT_DTYPES, QuantizedKV, Quantizer

LayerCache = Dict[str, torch.Tensor]


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
                      rope: Rope, *, kv_dtype: str = "bfloat16"
                      ) -> Tuple[torch.Tensor, LayerCache]:
    """Causal attention over a whole prompt.  Returns (y (B, L, d), the
    prompt's cache rows): ``k`` / ``v`` (B, L, Hkv, D) in the activation
    dtype, which the caller's write casts to the cache dtype, or, for a
    quantized ``kv_dtype``, quantized rows plus ``k_s`` / ``v_s`` scales.
    Attention itself reads the unquantized K/V."""
    q, k, v = _project_qkv(p, cfg, x, rope)
    out = ops.attention(q, k, v, causal=True)
    y = _out_proj(p, out)
    if kv_dtype in QUANT_DTYPES:
        qz = Quantizer.from_kv_dtype(kv_dtype)
        kq, ks = qz.quantize(k)
        vq, vs = qz.quantize(v)
        return y, {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
    dt = getattr(torch, cfg.dtype)
    return y, {"k": k.to(dt), "v": v.to(dt)}


def attention_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     cache: LayerCache, t: torch.Tensor, rope: Rope, *,
                     plan: LaunchPlan = None) -> torch.Tensor:
    """One decode step for every slot.  Returns (B, 1, d).

    ``t`` (B,) int64 holds each slot's position and ``rope`` its angles.
    Unlike the reference, which returns an updated copy of the cache,
    this writes the new K/V row of every slot into ``cache`` (views of
    the engine's static buffers) IN PLACE at row ``t``, then attends over
    rows ``[0, t]`` through the frozen ``plan``.  A quantized cache gets
    the row quantized, data and scales written, and is read through the
    fused-dequant kernel.
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x, rope)
    rows = torch.arange(B, device=x.device)
    qz = Quantizer.for_cache(cache)
    if qz is not None:
        kq, kns = qz.quantize(k_new[:, 0])
        vq, vns = qz.quantize(v_new[:, 0])
        # one-byte storage written as raw bytes: indexed writes of fp8
        # are not implemented for every device
        cache["k"].view(torch.uint8)[rows, t] = kq.view(torch.uint8)
        cache["v"].view(torch.uint8)[rows, t] = vq.view(torch.uint8)
        cache["k_s"][rows, t] = kns
        cache["v_s"][rows, t] = vns
        out = ops.decode_attention_quant(
            q[:, 0], QuantizedKV(cache["k"], cache["v"], cache["k_s"],
                                 cache["v_s"]), t + 1, plan=plan)
    else:
        cache["k"][rows, t] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, t] = v_new[:, 0].to(cache["v"].dtype)
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], t + 1,
                                   plan=plan)
    return _out_proj(p, out)[:, None]


# int8 per-(token, head) transforms as module functions, as in the
# reference; they delegate to the default Quantizer.
_INT8 = Quantizer()


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(..., head) int8 over the feature dim.
    x: (..., H, D) -> (q int8 same shape, scale f32 (..., H))."""
    return _INT8.quantize(x)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return _INT8.dequantize(q, scale)
