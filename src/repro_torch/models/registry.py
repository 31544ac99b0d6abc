"""Model facade: one object per architecture, the entry point of the port.

Counterpart of ``repro.models.registry`` for ``family="dense"``.
``build_model(cfg)`` returns a :class:`Model` bound to a device: the
CUDA card unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig, get_arch
from repro_torch.models import lm as lm_mod
from repro_torch.models.common import init_params
from repro_torch.plan import LaunchPlan
from repro_torch.quant import QUANT_DTYPES

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card.  A CUDA device that is not present
    raises: nothing falls back to the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


class Model:
    """One dense LM on one device: params, dense cache, prefill, decode."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        if cfg.family != "dense":
            raise ValueError(f"only the dense family is ported, got "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_params(self, seed: Union[int, torch.Generator] = 0
                    ) -> lm_mod.LM:
        """Random weights from a seed or a generator on this device."""
        gen = seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        return init_params(lm_mod.LM(self.cfg, self.device), gen)

    def init_cache(self, batch: int, max_len: int,
                   kv_dtype: str = "bfloat16") -> lm_mod.Caches:
        """Dense K and V caches, (layers, batch, max_len, Hkv, D), zeroed,
        in ``kv_dtype`` (a KV_DTYPES name).  A quantized ``kv_dtype``
        ("int8" | "fp8") stores its storage dtype plus ``k_s`` / ``v_s``
        f32 scales of shape (layers, batch, max_len, Hkv), as the
        reference's ``kv_cache_specs``."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        if kv_dtype in QUANT_DTYPES:
            dt = QUANT_DTYPES[kv_dtype].torch_dtype
            scales = {name: torch.zeros(shape[:4], dtype=torch.float32,
                                        device=self.device)
                      for name in ("k_s", "v_s")}
        else:
            dt = getattr(torch, kv_dtype)
            scales = {}
        return {"k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device),
                **scales}

    @property
    def supports_fused_prefill(self) -> bool:
        return True                     # dense, token inputs only

    def prefill_slot(self, params: lm_mod.LM, caches: lm_mod.Caches,
                     tokens: torch.Tensor, slot: int, length: int, *,
                     plan: Optional[LaunchPlan] = None) -> torch.Tensor:
        """Prefill the bucket-padded prompt ``tokens`` into ``slot`` in
        place; returns the logits at row ``length - 1`` (vocab,) f32."""
        return lm_mod.lm_prefill_slot(params, self.cfg, caches, tokens, slot,
                                      length, plan=plan)

    def decode_step(self, params: lm_mod.LM, caches: lm_mod.Caches,
                    token: torch.Tensor, t: torch.Tensor, *,
                    plan: Optional[LaunchPlan] = None) -> torch.Tensor:
        """One decode step for every slot, caches updated in place;
        returns logits (B, vocab) f32."""
        return lm_mod.lm_decode_step(params, self.cfg, caches, token, t,
                                     plan=plan)


def build_model(cfg_or_name: Union[ModelConfig, str],
                device: DeviceLike = None) -> Model:
    cfg = (get_arch(cfg_or_name) if isinstance(cfg_or_name, str)
           else cfg_or_name)
    return Model(cfg, device)
