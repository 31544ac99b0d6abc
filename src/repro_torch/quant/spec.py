"""QuantSpec: the declarative input to the KV-quantization resolver.

Counterpart of ``repro.quant.spec``.  A :class:`QuantSpec` says WHAT
low-precision scheme the KV cache uses (storage dtype, scale
granularity, scale dtype, amax calibration mode); the
:class:`~repro_torch.quant.Quantizer` resolves it into quantize /
dequantize transforms.  Storage names are torch dtype attribute names
(``int8`` -> ``torch.int8``, ``float8_e4m3fn`` -> ``torch.float8_e4m3fn``),
the same strings the reference uses for its jnp dtypes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.core.split_policy import KV_DTYPES


@dataclass(frozen=True)
class QuantDtype:
    """Storage format of one quantized KV family."""
    name: str            # KV_DTYPES key ("int8" | "fp8")
    storage: str         # torch dtype name of the cache data
    qmax: float          # largest representable magnitude
    rounds: bool         # True: round half to even; False: dtype cast

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.storage)


# The quantized members of KV_DTYPES.  fp8 is float8_e4m3fn, FA3's
# decode-side choice.  Both are 1 byte per element, so families are keyed
# by name, not width.
QUANT_DTYPES: Dict[str, QuantDtype] = {
    "int8": QuantDtype("int8", "int8", 127.0, rounds=True),
    "fp8": QuantDtype("fp8", "float8_e4m3fn", 448.0, rounds=False),
}

GRANULARITIES = ("per_head", "per_page")
AMAX_MODES = ("abs_max", "static")

# Fused-vs-unfused tolerance per dtype (absolute, on attention outputs of
# O(1) activations).  Both paths read the same quantized cache and
# dequantize with the same scales, so what remains is accumulation-order
# drift.
AB_ATOL: Dict[str, float] = {"int8": 2e-2, "fp8": 2e-2}


@dataclass(frozen=True)
class QuantSpec:
    """One KV-cache quantization scheme.

    ``granularity``: ``per_head`` is one scale per (token, head), amax
    over the feature dim (the serving default, the cache's ``k_s`` /
    ``v_s`` layout); ``per_page`` pools the amax over each
    ``page_size``-row page and repeats it per row, so the kernels stay
    granularity-blind.

    ``amax_mode``: ``abs_max`` observes the amax of the rows written;
    ``static`` uses ``static_amax`` everywhere (rows beyond it clip).
    """
    kv_dtype: str = "int8"              # QUANT_DTYPES key
    granularity: str = "per_head"       # per_head | per_page
    scale_dtype: str = "float32"
    amax_mode: str = "abs_max"          # abs_max | static
    static_amax: Optional[float] = None
    eps: float = 1e-8                   # amax floor (all-zero rows)

    def __post_init__(self) -> None:
        if self.kv_dtype not in QUANT_DTYPES:
            raise ValueError(
                f"unknown quantized kv_dtype {self.kv_dtype!r}; "
                f"known: {sorted(QUANT_DTYPES)} "
                f"(non-quantized KV_DTYPES: {sorted(KV_DTYPES)})")
        if self.granularity not in GRANULARITIES:
            raise ValueError(
                f"unknown scale granularity {self.granularity!r}; "
                f"known: {GRANULARITIES}")
        if self.amax_mode not in AMAX_MODES:
            raise ValueError(
                f"unknown amax mode {self.amax_mode!r}; "
                f"known: {AMAX_MODES}")
        if self.amax_mode == "static" and (
                self.static_amax is None or self.static_amax <= 0):
            raise ValueError(
                "amax_mode='static' needs a positive static_amax "
                "calibration constant")
        if self.eps <= 0:
            raise ValueError(
                "eps must be positive — it floors the amax so all-zero "
                "rows never divide by zero")
        if not isinstance(getattr(torch, self.scale_dtype, None),
                          torch.dtype):
            raise TypeError(f"scale_dtype {self.scale_dtype!r} is not a "
                            f"torch dtype name")

    @property
    def qdtype(self) -> QuantDtype:
        return QUANT_DTYPES[self.kv_dtype]

    @property
    def storage_dtype(self) -> str:
        """torch dtype name of the cache data."""
        return self.qdtype.storage

    @property
    def qmax(self) -> float:
        return self.qdtype.qmax

    @property
    def dtype_bytes(self) -> int:
        return self.qdtype.torch_dtype.itemsize

    def describe(self) -> Dict[str, object]:
        """JSON-safe summary (logs)."""
        d: Dict[str, object] = {
            "kv_dtype": self.kv_dtype, "storage": self.storage_dtype,
            "granularity": self.granularity, "amax_mode": self.amax_mode,
        }
        if self.static_amax is not None:
            d["static_amax"] = self.static_amax
        return d
