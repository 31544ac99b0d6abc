"""Decoder-only LM, dense and moe families.

Counterpart of the dense and moe paths of ``repro.models.lm``: every
block is attention then an FFN, a SwiGLU MLP (dense) or a
:class:`~repro_torch.models.moe.MoE` (``cfg.moe`` set; routing groups
are the rows each step passes: the padded prompt bucket in prefill, the
padded suffix bucket in suffix prefill, one token per slot in decode,
k + 1 rows per slot in verify).  Serving discards the MoE load-balance
loss, as the reference does.  Layers are an
``nn.ModuleList`` walked by a Python loop (the reference scans a
layer-stacked pytree).  Caches are dicts of dense tensors ``{"k", "v"}``
of shape (layers, B, L, Hkv, D), plus ``{"k_s", "v_s"}`` f32 scales of
shape (layers, B, L, Hkv) for a quantized cache: the engine's static
dense buffers (L = max_len), or a view the paged layout gathered (L =
the resident bucket).  Decode, suffix prefill and verify update them in
place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
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

Caches = Dict[str, torch.Tensor]


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = RMSNorm(d, dtype, device)
        self.mix = attn_mod.Attention(cfg, dtype, device)
        self.ln2 = RMSNorm(d, dtype, device)
        self.ffn = (moe_mod.MoE(cfg, dtype, device) if cfg.moe is not None
                    else MLP(d, cfg.d_ff, dtype, device))


class LM(nn.Module):
    """All weights of a dense or moe LM, named as the reference's param
    tree:
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
    if cfg.moe is not None:
        return x + moe_mod.apply_moe(block.ffn, cfg, h2)
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


def _logits(params: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return unembed(params.embed,
                   rms_norm(x, params.final_norm.scale, cfg.norm_eps))


@torch.no_grad()
def lm_prefill_view(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
                    length: int, *, plan: Optional[LaunchPlan] = None,
                    kv_dtype: str = "bfloat16"
                    ) -> Tuple[torch.Tensor, Caches]:
    """Prefill one bucket-padded prompt ``tokens`` (Lb,) in one pass.

    Returns (the logits at row ``length - 1`` (vocab,) f32, the prompt's
    batch-1 cache rows: ``k`` / ``v`` (layers, 1, Lb, Hkv, D), and
    ``k_s`` / ``v_s`` (layers, 1, Lb, Hkv) when ``kv_dtype`` is
    quantized), one stacked tensor each, so a cache layout lands them in
    one write per tensor.  Rows in [length, Lb) hold the padding's K/V:
    causal attention keeps them out of every real row, and decode masks
    and then overwrites them.  ``plan`` is the prefill-kind plan of the
    bucket; prefill never splits, so nothing in it changes the math.
    """
    x = embed_tokens(params.embed, tokens[None])
    lb = x.shape[1]
    rope = rope_angles(torch.arange(lb, device=x.device)[None],
                       cfg.resolved_head_dim, cfg.rope_theta)
    kv = []
    for block in params.layers:
        x, rows = block_prefill(block, cfg, x, rope, kv_dtype)
        kv.append(rows)
    view = {name: torch.stack([rows[name] for rows in kv]) for name in kv[0]}
    return _logits(params, cfg, x[:, length - 1:length])[0, 0], view


def block_suffix_prefill(block: Block, cfg: ModelConfig, x: torch.Tensor,
                         cache: attn_mod.LayerCache, start: int, rope: Rope,
                         kv_dtype: str) -> torch.Tensor:
    """One block over an unshared suffix (prefix sharing): rows [0,
    start) of the layer's batch-1 cache view arrive resident, and the
    suffix's K/V is written at [start, start + M) in place."""
    h = rms_norm(x, block.ln1.scale, cfg.norm_eps)
    mix = attn_mod.attention_suffix_prefill(block.mix, cfg, h, cache, start,
                                            rope, kv_dtype=kv_dtype)
    return _ffn(block, cfg, x + mix)


@torch.no_grad()
def lm_prefill_suffix_view(params: LM, cfg: ModelConfig, view: Caches,
                           tokens: torch.Tensor, start: int, length: int, *,
                           plan: Optional[LaunchPlan] = None,
                           kv_dtype: str = "bfloat16") -> torch.Tensor:
    """Suffix-only admission prefill (prefix sharing).

    The counterpart of :func:`lm_prefill_view` when rows [0, start) of
    the batch-1 view ``view`` (layers, 1, V, ...) already hold a shared
    prefix's K/V: one pass computes only the ``length - start`` unshared
    rows (bucket-padded to ``tokens``' length Mb), attending over prefix
    and suffix through the causal ``q_offset = start``, and writes their
    K/V into ``view`` in place.  Returns the logits at prompt row
    ``length - 1`` (vocab,) f32.  Padding rows land at key positions no
    real query attends, as in :func:`lm_prefill_view`.
    """
    x = embed_tokens(params.embed, tokens[None])
    pos = start + torch.arange(x.shape[1], device=x.device)
    rope = rope_angles(pos[None], cfg.resolved_head_dim, cfg.rope_theta)
    for li, block in enumerate(params.layers):
        x = block_suffix_prefill(block, cfg, x,
                                 {name: c[li] for name, c in view.items()},
                                 start, rope, kv_dtype)
    row = length - 1 - start
    return _logits(params, cfg, x[:, row:row + 1])[0, 0]


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


def block_verify(block: Block, cfg: ModelConfig, x: torch.Tensor,
                 cache: attn_mod.LayerCache, t: torch.Tensor, rope: Rope, *,
                 plan: LaunchPlan = None) -> torch.Tensor:
    """One block over an M-row verify block per slot; x: (B, M, d)."""
    h = rms_norm(x, block.ln1.scale, cfg.norm_eps)
    mix = attn_mod.attention_verify(block.mix, cfg, h, cache, t, rope,
                                    plan=plan)
    return _ffn(block, cfg, x + mix)


@torch.no_grad()
def lm_verify_step(params: LM, cfg: ModelConfig, caches: Caches,
                   tokens: torch.Tensor, t: torch.Tensor, *,
                   plan: Optional[LaunchPlan] = None) -> torch.Tensor:
    """Speculative verify: score M = k + 1 rows per slot in one pass.

    The multi-token sibling of :func:`lm_decode_step`: ``tokens[:, 0]``
    (B, M) is each slot's committed current token and ``tokens[:, 1:]``
    its drafts, at positions ``t + j``.  Row ``j`` of the returned logits
    (B, M, vocab) f32 is the next-token distribution after rows [0, j],
    the teacher-forced scores that accept/reject consumes.  Every layer
    writes the block's K/V rows into ``caches`` in place and attends
    through the frozen ``("verify", k, bucket)`` plan.
    """
    x = embed_tokens(params.embed, tokens)
    pos = t[:, None] + torch.arange(tokens.shape[1], device=t.device)
    rope = rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta)
    for li, block in enumerate(params.layers):
        x = block_verify(block, cfg, x,
                         {name: c[li] for name, c in caches.items()}, t,
                         rope, plan=plan)
    return _logits(params, cfg, x)
