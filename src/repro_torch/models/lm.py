"""Decoder-only LM, dense family.

Counterpart of the dense path of ``repro.models.lm``.  Layers are an
``nn.ModuleList`` walked by a Python loop (the reference scans a
layer-stacked pytree).  Caches are the engine's static dense buffers
``{"k", "v"}`` of shape (layers, B, max_len, Hkv, D), plus ``{"k_s",
"v_s"}`` f32 scales of shape (layers, B, max_len, Hkv) for a quantized
cache, updated in place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (
    MLP,
    Embed,
    RMSNorm,
    Rope,
    apply_mlp,
    embed_tokens,
    rms_norm,
    rope_angles,
    unembed,
)
from repro_torch.plan import LaunchPlan
from repro_torch.quant import Quantizer

Caches = Dict[str, torch.Tensor]


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = RMSNorm(d, dtype, device)
        self.mix = attn_mod.Attention(cfg, dtype, device)
        self.ln2 = RMSNorm(d, dtype, device)
        self.ffn = MLP(d, cfg.d_ff, dtype, device)


class LM(nn.Module):
    """All weights of a dense LM, named as the reference's param tree:
    ``embed``, ``final_norm`` and one :class:`Block` per layer."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dtype = getattr(torch, cfg.param_dtype)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings,
                           dtype, device)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        self.layers = nn.ModuleList(Block(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))


def _ffn(block: Block, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h2 = rms_norm(x, block.ln2.scale, cfg.norm_eps)
    return x + apply_mlp(block.ffn, h2, cfg.mlp_kind)


def block_prefill(block: Block, cfg: ModelConfig, x: torch.Tensor,
                  rope: Rope, kv_dtype: str
                  ) -> Tuple[torch.Tensor, attn_mod.LayerCache]:
    """One block over a whole prompt: (x, the block's cache rows)."""
    h = rms_norm(x, block.ln1.scale, cfg.norm_eps)
    mix, rows = attn_mod.attention_prefill(block.mix, cfg, h, rope,
                                           kv_dtype=kv_dtype)
    return _ffn(block, cfg, x + mix), rows


def block_decode(block: Block, cfg: ModelConfig, x: torch.Tensor,
                 cache: attn_mod.LayerCache, t: torch.Tensor, rope: Rope, *,
                 plan: LaunchPlan = None) -> torch.Tensor:
    """One block, one token per slot; x: (B, 1, d)."""
    h = rms_norm(x, block.ln1.scale, cfg.norm_eps)
    mix = attn_mod.attention_decode(block.mix, cfg, h, cache, t, rope,
                                    plan=plan)
    return _ffn(block, cfg, x + mix)


def cache_kv_dtype(caches: Caches) -> str:
    """The KV_DTYPES name a cache dict was allocated for."""
    qz = Quantizer.for_cache(caches)
    if qz is not None:
        return qz.spec.kv_dtype
    return str(caches["k"].dtype).removeprefix("torch.")


def _logits(params: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return unembed(params.embed,
                   rms_norm(x, params.final_norm.scale, cfg.norm_eps))


@torch.no_grad()
def lm_prefill_view(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
                    length: int, *, plan: Optional[LaunchPlan] = None,
                    kv_dtype: str = "bfloat16"
                    ) -> Tuple[torch.Tensor, List[attn_mod.LayerCache]]:
    """Prefill one bucket-padded prompt ``tokens`` (Lb,) in one pass.

    Returns (the logits at row ``length - 1`` (vocab,) f32, each layer's
    cache rows: ``k`` / ``v`` (1, Lb, Hkv, D), and ``k_s`` / ``v_s`` (1,
    Lb, Hkv) when ``kv_dtype`` is quantized).  Rows at or past ``length``
    hold the padding's K/V: causal attention keeps them out of every real
    row, and decode masks and then overwrites them.  ``plan`` is the
    prefill-kind plan of the bucket; prefill never splits, so nothing in
    it changes the math.
    """
    x = embed_tokens(params.embed, tokens[None])
    rope = rope_angles(torch.arange(x.shape[1], device=x.device)[None],
                       cfg.resolved_head_dim, cfg.rope_theta)
    kv = []
    for block in params.layers:
        x, rows = block_prefill(block, cfg, x, rope, kv_dtype)
        kv.append(rows)
    return _logits(params, cfg, x[:, length - 1:length])[0, 0], kv


@torch.no_grad()
def lm_prefill_slot(params: LM, cfg: ModelConfig, caches: Caches,
                    tokens: torch.Tensor, slot: int, length: int, *,
                    plan: Optional[LaunchPlan] = None) -> torch.Tensor:
    """Prefill one prompt into slot ``slot`` of the dense cache, in place:
    rows [0, Lb) of every layer, quantized if the cache is.  Returns the
    logits at the last real prompt row, (vocab,) f32."""
    logits, kv = lm_prefill_view(params, cfg, tokens, length, plan=plan,
                                 kv_dtype=cache_kv_dtype(caches))
    lb = tokens.shape[0]
    for li, rows in enumerate(kv):
        for name, val in rows.items():
            caches[name][li, slot, :lb] = val[0]
    return logits


@torch.no_grad()
def lm_decode_step(params: LM, cfg: ModelConfig, caches: Caches,
                   token: torch.Tensor, t: torch.Tensor, *,
                   plan: Optional[LaunchPlan] = None) -> torch.Tensor:
    """One decode step for every slot.  ``token`` (B,) and ``t`` (B,) are
    each slot's fed token and its position.  Writes each slot's K/V row
    into ``caches`` in place and returns the logits (B, vocab) f32.
    ``plan`` is the frozen decode plan every layer launches from."""
    x = embed_tokens(params.embed, token[:, None])
    rope = rope_angles(t[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    for li, block in enumerate(params.layers):
        x = block_decode(block, cfg, x,
                         {name: c[li] for name, c in caches.items()}, t,
                         rope, plan=plan)
    return _logits(params, cfg, x)[:, 0]
