"""Whisper-style encoder-decoder (audio backbone; the conv frontend is a stub).

Counterpart of ``repro.models.encdec``.  ``Model.frontend_inputs`` names
precomputed frame embeddings (B, encoder_positions, d_model); the
encoder adds fixed sinusoidal positions and runs bidirectional attention
on the prefill kernel; the decoder adds learned positions (``pos_dec``)
and runs causal self-attention, then cross-attention to the encoder
output, then a plain gelu MLP with biases.  Norms are LayerNorm (scale
and bias); there is no RoPE.

Caches are dense tensors, layers stacked: ``k`` / ``v`` (layers, B, L,
Hkv, D), the self-attention cache (position-linear: it pages), and
``cross_k`` / ``cross_v`` (layers, B, encoder_positions, Hkv, D), the
cross K / V projected from the encoder output once a request
(:func:`build_cross_caches`).  The cross leaves are position-complete:
every decode step reads all of them, so they never page
(:data:`CROSS_LEAVES`).  Both are bfloat16 whatever ``kv_dtype`` says,
as the reference's ``encdec_cache_specs``.  A decode step attends the
self cache under the frozen decode plan and the cross cache under the
scheduler's ``side_plans["cross"]``, frozen for the encoder length, or,
without one, a policy evaluation inside the launch over that length, as
the reference's does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (
    Embed,
    LayerNorm,
    ParamSpec,
    SpecModule,
    apply_mlp,
    apply_norm,
    embed_tokens,
    mlp_module,
    sinusoidal_positions,
    unembed,
)
from repro_torch.plan import LaunchPlan

Caches = Dict[str, torch.Tensor]
CROSS_LEAVES = ("cross_k", "cross_v")


def max_dec_positions(cfg: ModelConfig) -> int:
    """Rows of the decoder's learned position table: ``min(max_seq_len,
    32768)``, the reference's bound (the largest decode shape)."""
    return min(cfg.max_seq_len, 32_768)


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = LayerNorm(d, dtype, device)
        self.self = attn_mod.Attention(cfg, dtype, device)
        self.ln2 = LayerNorm(d, dtype, device)
        self.ffn = mlp_module(d, cfg.d_ff, cfg.mlp_kind, dtype, device)


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = LayerNorm(d, dtype, device)
        self.self = attn_mod.Attention(cfg, dtype, device)
        self.lnx = LayerNorm(d, dtype, device)
        self.cross = attn_mod.Attention(cfg, dtype, device)
        self.ln2 = LayerNorm(d, dtype, device)
        self.ffn = mlp_module(d, cfg.d_ff, cfg.mlp_kind, dtype, device)


class EncDec(SpecModule):
    """All weights, named as the reference's param tree: ``embed``,
    ``pos_dec``, ``enc_layers``, ``enc_norm``, ``dec_layers`` (each with
    ``self``, ``lnx``, ``cross``) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device):
        dtype = getattr(torch, cfg.param_dtype)
        d = cfg.d_model
        super().__init__({"pos_dec": ParamSpec((max_dec_positions(cfg), d),
                                                  ("seq", "embed"))},
                         dtype, device)
        self.embed = Embed(cfg.vocab_size, d, cfg.tie_embeddings, dtype,
                           device)
        self.enc_layers = nn.ModuleList(
            EncBlock(cfg, dtype, device)
            for _ in range(cfg.num_encoder_layers))
        self.enc_norm = LayerNorm(d, dtype, device)
        self.dec_layers = nn.ModuleList(DecBlock(cfg, dtype, device)
                                        for _ in range(cfg.num_layers))
        self.final_norm = LayerNorm(d, dtype, device)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """name -> ((layers, batch, rows, Hkv, D), bfloat16): the self cache
    over ``max_len`` rows and the cross cache over the encoder length."""
    hd, layers, h = cfg.resolved_head_dim, cfg.num_layers, cfg.num_kv_heads
    self_shape = (layers, batch, max_len, h, hd)
    cross_shape = (layers, batch, cfg.encoder_positions, h, hd)
    return {"k": (self_shape, torch.bfloat16),
            "v": (self_shape, torch.bfloat16),
            "cross_k": (cross_shape, torch.bfloat16),
            "cross_v": (cross_shape, torch.bfloat16)}


def _ffn(block, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x + apply_mlp(block.ffn, apply_norm(block.ln2, x, cfg.norm_eps),
                         cfg.mlp_kind)


def encode(params: EncDec, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames (B, T, d_model) stub embeddings -> the encoder output (B, T,
    d_model): sinusoidal positions added, then non-causal attention on
    the prefill kernel (no bias, no RoPE, as the reference's encoder)."""
    T, d = frames.shape[1], frames.shape[2]
    x = frames + sinusoidal_positions(T, d, frames.device).to(frames.dtype)
    for block in params.enc_layers:
        h = apply_norm(block.ln1, x, cfg.norm_eps)
        p = block.self
        q, k, v = (attn_mod._proj(h, w) for w in (p.wq, p.wk, p.wv))
        x = x + attn_mod._out_proj(p, ops.attention(q, k, v, causal=False))
        x = _ffn(block, cfg, x)
    return apply_norm(params.enc_norm, x, cfg.norm_eps)


def _embed(params: EncDec, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings plus the learned positions [0, L): (B, L, d)."""
    x = embed_tokens(params.embed, tokens)
    return x + params.pos_dec[:tokens.shape[1]].to(x.dtype)[None]


def _logits(params: EncDec, cfg: ModelConfig, x: torch.Tensor):
    return unembed(params.embed,
                   apply_norm(params.final_norm, x, cfg.norm_eps))


def _decoder_prefill(params: EncDec, cfg: ModelConfig, x: torch.Tensor,
                     cross) -> Tuple[torch.Tensor, Caches]:
    """Every decoder block over the embedded rows ``x`` (B, L, d):
    causal self-attention, then cross-attention over ``cross(li)``'s K /
    V.  Returns (the last block's output, the self rows ``k`` / ``v``
    stacked (layers, B, L, Hkv, D))."""
    kv = {"k": [], "v": []}
    for li, block in enumerate(params.dec_layers):
        h = apply_norm(block.ln1, x, cfg.norm_eps)
        mix, rows = attn_mod.attention_prefill(block.self, cfg, h, None)
        x = x + mix
        hx = apply_norm(block.lnx, x, cfg.norm_eps)
        x = x + attn_mod.cross_attention(block.cross, cfg, hx, cross(li))
        x = _ffn(block, cfg, x)
        kv["k"].append(rows["k"])
        kv["v"].append(rows["v"])
    return x, {name: torch.stack(r) for name, r in kv.items()}


def build_cross_caches(params: EncDec, cfg: ModelConfig,
                       memory: torch.Tensor) -> Caches:
    """Every decoder layer's cross K / V from the encoder output ``memory``
    (B, T, d): ``cross_k`` / ``cross_v`` (layers, B, T, Hkv, D)."""
    kv = [attn_mod.precompute_cross_kv(b.cross, cfg, memory)
          for b in params.dec_layers]
    return {"cross_k": torch.stack([c["k"] for c in kv]),
            "cross_v": torch.stack([c["v"] for c in kv])}


def _cross_rows(cross: Caches, slot: slice = slice(None)):
    """Layer ``li``'s cross K / V of the slots ``slot`` of stacked cross
    leaves, as a function of ``li``."""
    return lambda li: {"k": cross["cross_k"][li, slot],
                       "v": cross["cross_v"][li, slot]}


def encdec_forward(params: EncDec, cfg: ModelConfig, tokens: torch.Tensor,
                   frames: torch.Tensor) -> torch.Tensor:
    """The teacher-forced pass, the training path: encode ``frames``,
    then the decoder over ``tokens`` (B, L).  Returns the logits (B, L,
    vocab) f32.  It runs with grad (the reference differentiates through
    the encoder and the decoder); serving's prefill and decode steps run
    under ``no_grad``."""
    cross = build_cross_caches(params, cfg, encode(params, cfg, frames))
    x, _ = _decoder_prefill(params, cfg, _embed(params, tokens),
                            _cross_rows(cross))
    return _logits(params, cfg, x)


@torch.no_grad()
def encdec_prefill(params: EncDec, cfg: ModelConfig, tokens: torch.Tensor,
                   frames: torch.Tensor, caches: Caches) -> torch.Tensor:
    """Encode ``frames``, then the teacher-forced decoder prefill of
    ``tokens`` (B, L), writing rows [0, L) of the self cache and the
    whole cross cache of ``caches`` (dense, the B slots) in place; returns
    the last position's logits (B, vocab) f32.  Cross attention here
    attends K / V projected from the encoder output, the same numbers
    :func:`build_cross_caches` stores."""
    cross = build_cross_caches(params, cfg, encode(params, cfg, frames))
    x, rows = _decoder_prefill(params, cfg, _embed(params, tokens),
                               _cross_rows(cross))
    for name, r in {**rows, **cross}.items():
        caches[name][:, :, :r.shape[2]] = r.to(caches[name].dtype)
    return _logits(params, cfg, x[:, -1:])[:, 0]


@torch.no_grad()
def encdec_prefill_view(params: EncDec, cfg: ModelConfig,
                        tokens: torch.Tensor, length: int, caches: Caches,
                        slot: int) -> Tuple[torch.Tensor, Caches]:
    """Decoder prefill of one bucket-padded prompt ``tokens`` (Lb,) for
    slot ``slot``.  Cross attention reads the slot's resident cross K / V
    in ``caches`` (zeros after admission's reset, the encoder's after
    :func:`build_cross_caches` lands there), the memory its decode steps
    read.  Returns (the logits at row ``length - 1`` (vocab,) f32, the
    self rows ``k`` / ``v`` (layers, 1, Lb, Hkv, D)); the cross column is
    left where it is."""
    x, rows = _decoder_prefill(params, cfg, _embed(params, tokens[None]),
                               _cross_rows(caches, slice(slot, slot + 1)))
    return _logits(params, cfg, x[:, length - 1:length])[0, 0], rows


@torch.no_grad()
def encdec_decode_step(params: EncDec, cfg: ModelConfig, caches: Caches,
                       token: torch.Tensor, t: torch.Tensor, *,
                       plan: Optional[LaunchPlan] = None,
                       side_plans: Optional[Dict[str, LaunchPlan]] = None
                       ) -> torch.Tensor:
    """One decode step for every slot: ``token`` (B,) at positions ``t``
    (B,).  Self-attention writes each slot's row at ``t`` in place and
    attends under ``plan``; cross-attention reads the whole cross cache
    under ``side_plans["cross"]`` (else ``plan``'s policy, inside the
    launch).  Returns the logits (B, vocab) f32."""
    x = embed_tokens(params.embed, token[:, None])
    x = x + params.pos_dec[t].to(x.dtype)[:, None]
    cross_plan = (side_plans or {}).get("cross", plan)
    for li, block in enumerate(params.dec_layers):
        h = apply_norm(block.ln1, x, cfg.norm_eps)
        x = x + attn_mod.attention_decode(
            block.self, cfg, h, {"k": caches["k"][li], "v": caches["v"][li]},
            t, None, plan=plan)
        hx = apply_norm(block.lnx, x, cfg.norm_eps)
        x = x + attn_mod.cross_attention_decode(
            block.cross, cfg, hx, {"k": caches["cross_k"][li],
                                   "v": caches["cross_v"][li]},
            plan=cross_plan)
        x = _ffn(block, cfg, x)
    return _logits(params, cfg, x)[:, 0]
