"""Quantizer: resolves a QuantSpec into KV quantize / dequantize transforms.

Counterpart of ``repro.quant.quantizer``: plain PyTorch on tensors (the
reference has no kernel here either), bit for bit the reference's
numerics — f32 amax and scale, a true division, round half to even for
int8, a round-to-nearest-even cast for fp8.

Artifact: :class:`QuantizedKV`, the four tensors every quantized decode
launch reads (dense tensors or views of the engine's cache).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.quant.spec import QUANT_DTYPES, QuantSpec


class QuantizedKV(NamedTuple):
    """``k`` / ``v``: (B, L, Hkv, D) in the spec's storage dtype;
    ``k_scale`` / ``v_scale``: (B, L, Hkv) scales."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor


class Quantizer:
    """Quantize / dequantize for one :class:`QuantSpec`."""

    def __init__(self, spec: QuantSpec = QuantSpec()):
        self.spec = spec

    @classmethod
    def from_kv_dtype(cls, kv_dtype: str, **kw) -> "Quantizer":
        """Resolver entry point from a KV_DTYPES name ("int8" | "fp8")."""
        return cls(QuantSpec(kv_dtype=kv_dtype, **kw))

    @classmethod
    def for_cache(cls, cache: Dict[str, torch.Tensor]
                  ) -> Optional["Quantizer"]:
        """The quantizer a cache dict was built for, from its data dtype;
        ``None`` for an unquantized cache (no scale tensors)."""
        if "k_s" not in cache:
            return None
        leaf = cache["k"].dtype
        for name, qd in QUANT_DTYPES.items():
            if leaf == qd.torch_dtype:
                return cls(QuantSpec(kv_dtype=name))
        raise ValueError(
            f"cache has scale leaves but data dtype {leaf} matches no "
            f"registered quantized dtype ({sorted(QUANT_DTYPES)})")

    def _amax(self, xf: torch.Tensor,
              page_size: Optional[int]) -> torch.Tensor:
        """Per-(row, head) amax (..., L, H), pooled per page if asked."""
        amax = xf.abs().amax(dim=-1)                     # (..., L, H)
        if self.spec.amax_mode == "static":
            return torch.full_like(amax, self.spec.static_amax)
        if self.spec.granularity == "per_page":
            if page_size is None:
                raise ValueError(
                    "granularity='per_page' needs page_size= at quantize "
                    "time (the cache layout's page width)")
            L = amax.shape[-2]
            n = -(-L // page_size)
            a = torch.nn.functional.pad(
                amax, (0, 0, 0, n * page_size - L))
            a = a.reshape(a.shape[:-2] + (n, page_size, a.shape[-1]))
            a = a.amax(dim=-2)                           # (..., n, H)
            amax = a.repeat_interleave(page_size, dim=-2)[..., :L, :]
        return amax

    def quantize(self, x: torch.Tensor, *,
                 page_size: Optional[int] = None):
        """x: (..., H, D) -> (q in the storage dtype, scale (..., H)).

        int8: symmetric round half to even, clipped to +-127.  fp8
        (e4m3fn): scaled to +-448, then cast (nearest even)."""
        qd = self.spec.qdtype
        xf = x.float()
        amax = self._amax(xf, page_size)
        scale = amax.clamp_min(self.spec.eps) / qd.qmax
        y = xf / scale[..., None]
        if qd.rounds:
            y = torch.round(y)
        y = y.clamp(-qd.qmax, qd.qmax)
        return (y.to(qd.torch_dtype),
                scale.to(getattr(torch, self.spec.scale_dtype)))

    def dequantize(self, q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
        """(q (..., H, D), scale (..., H)) -> f32 (..., H, D); the decode
        kernel's CUDA-core body applies the same ``float(q) * scale`` per
        staged row."""
        return q.float() * scale[..., None]

    def quantized_kv(self, k: torch.Tensor, v: torch.Tensor, *,
                     page_size: Optional[int] = None) -> QuantizedKV:
        """Quantize a K/V pair into the artifact the kernels read."""
        kq, ks = self.quantize(k, page_size=page_size)
        vq, vs = self.quantize(v, page_size=page_size)
        return QuantizedKV(kq, vq, ks, vs)

    def row_error_bound(self, scale: torch.Tensor) -> torch.Tensor:
        """Elementwise |x - dequant(quant(x))| bound per (row, head):
        half a step for int8, 2^-4 of qmax steps for e4m3 (3 mantissa
        bits)."""
        if self.spec.qdtype.rounds:
            return 0.5 * scale
        return self.spec.qmax * (2.0 ** -4) * scale
