"""Model facade: one object per architecture, the entry point of the port.

Counterpart of ``repro.models.registry`` for the ported families,
``dense`` and ``moe`` (whose FFN is a mixture of experts; attention,
caches, prefill, decode and verify are dense's).  ``build_model(cfg)``
returns a :class:`Model` bound to a device: the CUDA card unless the
caller asks for the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.cache.manager import CacheManager
from repro_torch.cache.spec import CacheSpec
from repro_torch.configs.base import ModelConfig, check_ported, get_arch
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
    """One dense or moe LM on one device: params, caches, prefill,
    decode, verify."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        check_ported(cfg)
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

    def cache_shapes(self, batch: int, max_len: int,
                     kv_dtype: str = "bfloat16"
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Each dense cache tensor's (shape, dtype): K and V (layers,
        batch, max_len, Hkv, D) in ``kv_dtype`` (a KV_DTYPES name); a
        quantized ``kv_dtype`` ("int8" | "fp8") stores its storage dtype
        plus ``k_s`` / ``v_s`` f32 scales of shape (layers, batch,
        max_len, Hkv), as the reference's ``kv_cache_specs``.  Every one
        is position-linear (row t holds position t), so every one pages."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        if kv_dtype in QUANT_DTYPES:
            dt = QUANT_DTYPES[kv_dtype].torch_dtype
            scales = {name: (shape[:4], torch.float32)
                      for name in ("k_s", "v_s")}
        else:
            dt = getattr(torch, kv_dtype)
            scales = {}
        return {"k": (shape, dt), "v": (shape, dt), **scales}

    def init_cache(self, batch: int, max_len: int,
                   kv_dtype: str = "bfloat16") -> lm_mod.Caches:
        """Dense caches of :meth:`cache_shapes`, zeroed, on this device."""
        return {name: torch.zeros(shape, dtype=dt, device=self.device)
                for name, (shape, dt) in self.cache_shapes(
                    batch, max_len, kv_dtype).items()}

    @property
    def supports_prefix_sharing(self) -> bool:
        """Whether ``share_prefix`` may index this model's pages: every
        cache tensor of a dense or moe model is position-linear, so it
        pages, and suffix prefill is the restartable form of fused
        prefill."""
        return self.supports_fused_prefill

    def cache_spec(self, batch: int, max_len: int,
                   kv_dtype: str = "bfloat16", *, layout: str = "dense",
                   page_size: int = 64, page_budget: Optional[int] = None,
                   share_prefix: bool = False,
                   prefix_capacity: Optional[int] = None) -> CacheSpec:
        """The declarative :class:`~repro_torch.cache.spec.CacheSpec` for
        this model's caches, the input a
        :class:`~repro_torch.cache.manager.CacheManager` resolves into a
        layout."""
        if share_prefix and not self.supports_prefix_sharing:
            raise ValueError(
                f"{self.cfg.family} models cannot share prefix pages "
                "(needs paged caches, fused prefill and a uniform "
                "full-attention stack)")
        return CacheSpec(self.cfg.family, batch, max_len, kv_dtype=kv_dtype,
                         layout=layout, page_size=page_size,
                         page_budget=page_budget, share_prefix=share_prefix,
                         prefix_capacity=prefix_capacity)

    def cache_manager(self, batch: int, max_len: int,
                      kv_dtype: str = "bfloat16",
                      **layout_kw) -> CacheManager:
        """Resolve :meth:`cache_spec` into a
        :class:`~repro_torch.cache.manager.CacheManager` (the owner of
        residency and page tables; the engine holds the storage)."""
        return CacheManager(self, self.cache_spec(batch, max_len, kv_dtype,
                                                  **layout_kw))

    @property
    def supports_fused_prefill(self) -> bool:
        return True                     # dense and moe: token inputs only

    def prefill_slot_view(self, params: lm_mod.LM, tokens: torch.Tensor,
                          length: int, *,
                          plan: Optional[LaunchPlan] = None,
                          kv_dtype: str = "bfloat16"):
        """Prefill the bucket-padded prompt ``tokens`` (Lb,): (the logits
        at row ``length - 1`` (vocab,) f32, the prompt's batch-1 cache
        rows (layers, 1, Lb, ...)), written nowhere; the cache layout's
        ``write_slot`` lands them in a slot."""
        return lm_mod.lm_prefill_view(params, self.cfg, tokens, length,
                                      plan=plan, kv_dtype=kv_dtype)

    def prefill_suffix_view(self, params: lm_mod.LM, view: lm_mod.Caches,
                            tokens: torch.Tensor, start: int, length: int,
                            *, plan: Optional[LaunchPlan] = None,
                            kv_dtype: str = "bfloat16") -> torch.Tensor:
        """Suffix-only prefill over a batch-1 cache view whose rows [0,
        start) hold a shared prefix's K/V: ``tokens`` is the bucket-padded
        unshared suffix, ``length`` the whole prompt's length.  Writes
        the suffix rows into ``view`` in place and returns the logits at
        prompt row ``length - 1``."""
        return lm_mod.lm_prefill_suffix_view(params, self.cfg, view, tokens,
                                             start, length, plan=plan,
                                             kv_dtype=kv_dtype)

    @property
    def supports_speculation(self) -> bool:
        """Whether the engine may run speculative verify steps against
        this model: a uniform full-attention stack over the standard k/v
        cache, whose rejected rows roll back by truncating ``kv_len``.
        Every ported family (dense and moe) qualifies."""
        return True

    def verify_step(self, params: lm_mod.LM, caches: lm_mod.Caches,
                    tokens: torch.Tensor, t: torch.Tensor, *,
                    plan: Optional[LaunchPlan] = None) -> torch.Tensor:
        """Speculative verify: score a (B, M = k + 1)-token block per
        slot, each slot's current token and its drafts at positions [t, t
        + M), in one planned pass; caches updated in place.  Returns
        logits (B, M, vocab) f32, row ``j`` the next-token distribution
        after rows [0, j].  ``plan`` is the frozen ``("verify", k,
        bucket)`` plan."""
        if not self.supports_speculation:
            raise NotImplementedError(
                f"{self.cfg.family} models cannot run speculative verify "
                "steps")
        return lm_mod.lm_verify_step(params, self.cfg, caches, tokens, t,
                                     plan=plan)

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
