"""Low-precision KV: QuantSpec -> Quantizer -> QuantizedKV.

Counterpart of ``repro.quant``.  The artifact feeds
``kernels.ops.decode_attention_quant``, whose fused kernel dequantizes
each staged row in registers; ``ServeConfig.kv_quant`` makes it the
serving engine's cache format.
"""
from repro_torch.quant.quantizer import QuantizedKV, Quantizer  # noqa: F401
from repro_torch.quant.spec import (  # noqa: F401
    AB_ATOL,
    AMAX_MODES,
    GRANULARITIES,
    QUANT_DTYPES,
    QuantDtype,
    QuantSpec,
)
