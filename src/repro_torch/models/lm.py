"""Decoder-only LM: the dense, moe, mla, vlm, hybrid and ssm families.

Counterpart of ``repro.models.lm`` for those families: every block is a
mixer then an FFN, except the ssm family's, whose Mamba-2 SSD block
(:mod:`~repro_torch.models.ssd`, kind ``ssd``) carries the FFN's role
and has no MLP.  The mixer is GQA attention
(:mod:`~repro_torch.models.attention`), Multi-head Latent Attention
(:mod:`~repro_torch.models.mla`, family ``mla``), an SSD block, or, in
the hybrid family (RecurrentGemma), a repeating pattern of RG-LRU blocks
(:mod:`~repro_torch.models.rglru`) and local attention over a ring
cache of ``min(window, max_len)`` rows (kind ``attn_window``).  The FFN
is a gated MLP (swiglu, or geglu for gemma-style configs) or a
:class:`~repro_torch.models.moe.MoE` (``cfg.moe`` set; routing groups
are the rows each step passes: the padded prompt bucket in prefill, the
padded suffix bucket in suffix prefill, one token per slot in decode,
k + 1 rows per slot in verify).  Serving discards the MoE load-balance
loss, as the reference does; the training forward (:func:`lm_forward`,
:func:`block_train`) returns it.  A ``vlm`` config (PaliGemma) adds the
``patch_proj`` weight: :func:`lm_prefill` projects a vision stub's patch
embeddings and prepends them to the text.  Layers are an
``nn.ModuleList`` walked by a Python loop (the reference scans a
layer-stacked pytree).  Caches are dicts of dense tensors of shape
(layers, B, L, ...): ``{"k", "v"}`` (layers, B, L, Hkv, D), plus ``{"k_s",
"v_s"}`` f32 scales of shape (layers, B, L, Hkv) for a quantized cache,
or MLA's one ``{"latent"}`` (layers, B, L, 1, kv_lora_rank + rope):
the engine's static dense buffers (L = max_len), or a view the paged
layout gathered (L = the resident bucket).  A hybrid model's ``k`` / ``v``
stack its attention layers only, over the ring (L = the ring's rows),
and its recurrent layers stack ``{"state", "conv"}`` (:data:`REC_LEAVES`)
of their own, as every layer of an ssm model does (its ``state`` is the
SSD state (B, H, P, N)); :func:`layer_caches` hands each layer its
rows.  Decode, suffix prefill and verify update them in place.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.common import (
    Embed,
    ParamSpec,
    RMSNorm,
    Rope,
    SpecModule,
    apply_mlp,
    embed_tokens,
    mlp_module,
    rms_norm,
    rope_angles,
    unembed,
)
from repro_torch.plan import LaunchPlan

Caches = Dict[str, torch.Tensor]
SidePlans = Optional[Dict[str, LaunchPlan]]

# the recurrent (rglru, ssd) layers' cache leaves; every other leaf
# belongs to the attention layers
REC_LEAVES = ("state", "conv")
REC_KINDS = ("rglru", "ssd")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Each layer's mixer kind: the hybrid pattern repeated (``attn``
    there is ``attn_window``), ``ssd`` for the ssm family, ``mla`` for
    the mla family, else ``attn`` (dense, moe and vlm)."""
    if cfg.family == "hybrid":
        p = cfg.hybrid.pattern
        return [("attn_window" if p[i % len(p)] == "attn"
                 else p[i % len(p)]) for i in range(cfg.num_layers)]
    if cfg.family == "ssm":
        return ["ssd"] * cfg.num_layers
    return ["mla" if cfg.family == "mla" else "attn"] * cfg.num_layers


def layer_groups(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """[(pattern, repeats), ...] covering the layers in order, the
    reference's scan groups: the hybrid pattern repeated, then its
    remainder as a group of one; one group otherwise."""
    if cfg.family == "hybrid":
        p = tuple("attn_window" if k == "attn" else k
                  for k in cfg.hybrid.pattern)
        n_full, rem = divmod(cfg.num_layers, len(p))
        groups = [(p, n_full)] if n_full else []
        return groups + ([(p[:rem], 1)] if rem else [])
    return [((layer_kinds(cfg)[0],), cfg.num_layers)]


def ring_len(cfg: ModelConfig, max_len: int) -> int:
    """Rows of a windowed layer's ring cache."""
    return min(cfg.hybrid.window, max_len)


def cache_rows(cfg: ModelConfig) -> List[int]:
    """Each layer's index in the stacked cache leaves of its kind: a
    recurrent layer counts among the recurrent layers, any other among
    the others."""
    seen = {True: 0, False: 0}
    out = []
    for kind in layer_kinds(cfg):
        rec = kind in REC_KINDS
        out.append(seen[rec])
        seen[rec] += 1
    return out


def layer_caches(cfg: ModelConfig, caches: Caches
                 ) -> List[attn_mod.LayerCache]:
    """Each layer's cache: its row of the stacked leaves of its kind."""
    return [{name: c[i] for name, c in caches.items()
             if (name in REC_LEAVES) == (kind in REC_KINDS)}
            for kind, i in zip(layer_kinds(cfg), cache_rows(cfg))]


def rope_dim(cfg: ModelConfig) -> int:
    """The width RoPE rotates: MLA's shared rope key, else the head."""
    return (cfg.mla.qk_rope_head_dim if cfg.mla is not None
            else cfg.resolved_head_dim)


def has_mlp(kind: str) -> bool:
    """Whether a layer of ``kind`` has an FFN (an SSD block has none)."""
    return kind != "ssd"


class Block(nn.Module):
    """One layer of kind ``kind`` (:func:`layer_kinds`): its mixer, the
    norms and, unless :func:`has_mlp` says otherwise, the FFN."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        self.ln1 = RMSNorm(d, dtype, device)
        if kind == "mla":
            self.mix = mla_mod.MLA(cfg, dtype, device)
        elif kind == "rglru":
            self.mix = rglru_mod.RGLRU(cfg, dtype, device)
        elif kind == "ssd":
            self.mix = ssd_mod.SSD(cfg, dtype, device)
        else:
            self.mix = attn_mod.Attention(cfg, dtype, device)
        if not has_mlp(kind):
            return
        self.ln2 = RMSNorm(d, dtype, device)
        self.ffn = (moe_mod.MoE(cfg, dtype, device) if cfg.moe is not None
                    else mlp_module(d, cfg.d_ff, cfg.mlp_kind, dtype,
                                    device))


class LM(SpecModule):
    """All weights of an LM, named as the reference's param tree:
    ``embed``, ``final_norm``, one :class:`Block` per layer, and for a
    vision frontend ``patch_proj`` (embed_dim, d_model)."""

    def __init__(self, cfg: ModelConfig, device):
        dtype = getattr(torch, cfg.param_dtype)
        specs = {}
        if cfg.frontend.kind == "vision":
            specs["patch_proj"] = ParamSpec((cfg.frontend.embed_dim,
                                             cfg.d_model), (None, "embed"))
        super().__init__(specs, dtype, device)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings,
                           dtype, device)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        self.layers = nn.ModuleList(Block(cfg, kind, dtype, device)
                                    for kind in layer_kinds(cfg))


def _ffn(block: Block, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if not has_mlp(block.kind):
        return x
    h2 = rms_norm(x, block.ln2.scale, cfg.norm_eps)
    if cfg.moe is not None:
        return x + moe_mod.apply_moe(block.ffn, cfg, h2)
    return x + apply_mlp(block.ffn, h2, cfg.mlp_kind)


def block_train(block: Block, cfg: ModelConfig, x: torch.Tensor,
                rope: Rope) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block over a whole sequence, the training path (the
    reference's ``block_train``): (x, the block's auxiliary loss, f32;
    a MoE FFN's load-balance loss, else 0)."""
    h = rms_norm(x, block.ln1.scale, cfg.norm_eps)
    if block.kind == "mla":
        mix = mla_mod.mla_train(block.mix, cfg, h, rope)
    elif block.kind == "rglru":
        mix = rglru_mod.apply_rglru_train(block.mix, cfg, h)
    elif block.kind == "ssd":
        mix = ssd_mod.apply_ssd_train(block.mix, cfg, h)
    else:
        mix = attn_mod.attention_train(
            block.mix, cfg, h, rope,
            window=cfg.hybrid.window if block.kind == "attn_window"
            else None)
    x = x + mix
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not has_mlp(block.kind):
        return x, aux
    h2 = rms_norm(x, block.ln2.scale, cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = moe_mod.apply_moe_train(block.ffn, cfg, h2)
    else:
        y = apply_mlp(block.ffn, h2, cfg.mlp_kind)
    return x + y, aux


def lm_forward(params: LM, cfg: ModelConfig, tokens: torch.Tensor, *,
               patches: Optional[torch.Tensor] = None,
               block_wrapper: Optional[Callable] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward (the reference's ``lm_forward``): tokens (B,
    L_text), a vision config's ``patches`` (B, P, embed_dim) projected by
    ``patch_proj`` and prepended, then every block.  Returns (logits (B,
    L_total, vocab) f32, the summed auxiliary loss).  Layers run in the
    reference's scan groups (:func:`layer_groups`): one repetition of a
    group's pattern is one body, which ``block_wrapper`` (a remat policy,
    :func:`repro_torch.training.remat.block_wrapper`) wraps, as the
    reference wraps its scan body."""
    x = embed_tokens(params.embed, tokens)
    if cfg.frontend.kind == "vision":
        if patches is None:
            raise ValueError("a vision config's forward needs patches")
        pp = patches.to(x.dtype) @ params.patch_proj.to(x.dtype)
        x = torch.cat([pp, x], dim=1)
    L = x.shape[1]
    rope = rope_angles(torch.arange(L, device=x.device)[None],
                       rope_dim(cfg), cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body_of(blocks):
        def body(xc, auxc):
            for block in blocks:
                xc, a = block_train(block, cfg, xc, rope)
                auxc = auxc + a
            return xc, auxc
        return block_wrapper(body) if block_wrapper is not None else body

    first = 0
    for pattern, reps in layer_groups(cfg):
        for _ in range(reps):
            blocks = params.layers[first:first + len(pattern)]
            x, aux = body_of(blocks)(x, aux)
            first += len(pattern)
    return _logits(params, cfg, x), aux


def block_prefill(block: Block, cfg: ModelConfig, x: torch.Tensor,
                  rope: Rope, kv_dtype: str, ring: Optional[int] = None
                  ) -> Tuple[torch.Tensor, attn_mod.LayerCache]:
    """One block over a whole prompt: (x, the block's cache rows).  An
    MLA block's latent rows ignore ``kv_dtype``, as the reference's
    ``mla_cache_specs`` does; a windowed block's rows come in the layout
    of a ``ring``-row ring cache; a recurrent block's are its ``state``
    and ``conv`` after the prompt."""
    h = rms_norm(x, block.ln1.scale, cfg.norm_eps)
    if block.kind == "mla":
        mix, rows = mla_mod.mla_prefill(block.mix, cfg, h, rope)
    elif block.kind == "rglru":
        mix, rows = rglru_mod.apply_rglru_train(block.mix, cfg, h,
                                                return_cache=True)
    elif block.kind == "ssd":
        mix, rows = ssd_mod.apply_ssd_train(block.mix, cfg, h,
                                            return_cache=True)
    elif block.kind == "attn_window":
        mix, rows = attn_mod.attention_prefill(
            block.mix, cfg, h, rope, kv_dtype=kv_dtype,
            window=cfg.hybrid.window, ring=ring)
    else:
        mix, rows = attn_mod.attention_prefill(block.mix, cfg, h, rope,
                                               kv_dtype=kv_dtype)
    return _ffn(block, cfg, x + mix), rows


def block_decode(block: Block, cfg: ModelConfig, x: torch.Tensor,
                 cache: attn_mod.LayerCache, t: torch.Tensor, rope: Rope, *,
                 plan: LaunchPlan = None,
                 side_plans: SidePlans = None) -> torch.Tensor:
    """One block, one token per slot; x: (B, 1, d).  ``plan`` is the
    frozen plan of the full-attention layers; a windowed layer attends
    its ring under ``side_plans["ring"]`` when the scheduler froze one,
    else the policy decides inside the launch over the ring's length,
    as the reference's does."""
    h = rms_norm(x, block.ln1.scale, cfg.norm_eps)
    if block.kind == "rglru":
        mix = rglru_mod.apply_rglru_decode(block.mix, cfg, h, cache)
    elif block.kind == "ssd":
        mix = ssd_mod.apply_ssd_decode(block.mix, cfg, h, cache)
    elif block.kind == "attn_window":
        mix = attn_mod.attention_decode(
            block.mix, cfg, h, cache, t, rope,
            plan=(side_plans or {}).get("ring", plan),
            window=cfg.hybrid.window)
    else:
        decode = (mla_mod.mla_decode if block.kind == "mla"
                  else attn_mod.attention_decode)
        mix = decode(block.mix, cfg, h, cache, t, rope, plan=plan)
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
    x, view = _prefill_layers(params, cfg, embed_tokens(params.embed,
                                                        tokens[None]),
                              kv_dtype)
    return _logits(params, cfg, x[:, length - 1:length])[0, 0], view


def _prefill_layers(params: LM, cfg: ModelConfig, x: torch.Tensor,
                    kv_dtype: str, ring: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Caches]:
    """Every block over the embedded rows ``x`` (B, L, d) at positions
    [0, L): (the last block's output, the cache rows of every layer
    stacked, (layers, B, L, ...) a tensor; a hybrid model's leaves stack
    the layers that hold them, in layer order, its windowed rows in the
    layout of a ``ring``-row ring)."""
    L = x.shape[1]
    rope = rope_angles(torch.arange(L, device=x.device)[None],
                       rope_dim(cfg), cfg.rope_theta)
    kv: Dict[str, List[torch.Tensor]] = {}
    for block in params.layers:
        x, rows = block_prefill(block, cfg, x, rope, kv_dtype, ring)
        for name, r in rows.items():
            kv.setdefault(name, []).append(r)
    return x, {name: torch.stack(r) for name, r in kv.items()}


@torch.no_grad()
def lm_prefill(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
               caches: Caches, *, patches: Optional[torch.Tensor] = None,
               kv_dtype: str = "bfloat16") -> torch.Tensor:
    """Batched prefill of whole prompts (the reference's ``lm_prefill``).

    ``tokens`` (B, L_text); a vision config also takes ``patches`` (B, P,
    embed_dim), projected by ``patch_proj`` and prepended, so the
    sequence is L_total = P + L_text rows.  Writes every layer's cache
    rows [0, L_total) of the B slots of ``caches`` (dense, (layers, B,
    max_len, ...), zeroed past L_total) in place, laid out for
    :func:`lm_decode_step` to continue at t = L_total, and returns the
    last position's logits (B, vocab) f32."""
    x = embed_tokens(params.embed, tokens)
    if cfg.frontend.kind == "vision":
        if patches is None:
            raise ValueError("a vision config's prefill needs patches")
        pp = patches.to(x.dtype) @ params.patch_proj.to(x.dtype)
        x = torch.cat([pp, x], dim=1)
    ring = caches["k"].shape[2] if cfg.family == "hybrid" else None
    x, rows = _prefill_layers(params, cfg, x, kv_dtype, ring)
    for name, c in caches.items():
        # rows [0, L) of a position-indexed leaf; a recurrent leaf
        # (state, conv tail) whole
        ops.bit_view(c)[:, :, :rows[name].shape[2]] = ops.bit_view(
            rows[name].to(c.dtype))
    return _logits(params, cfg, x[:, -1:])[:, 0]


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
                   plan: Optional[LaunchPlan] = None,
                   side_plans: SidePlans = None) -> torch.Tensor:
    """One decode step for every slot.  ``token`` (B,) and ``t`` (B,) are
    each slot's fed token and its position.  Writes each slot's K/V row
    (and a recurrent layer's state) into ``caches`` in place and returns
    the logits (B, vocab) f32.  ``plan`` is the frozen decode plan the
    full-attention layers launch from, ``side_plans`` the hybrid's ring
    plan (:func:`block_decode`)."""
    x = embed_tokens(params.embed, token[:, None])
    rope = rope_angles(t[:, None], rope_dim(cfg), cfg.rope_theta)
    for block, cache in zip(params.layers, layer_caches(cfg, caches)):
        x = block_decode(block, cfg, x, cache, t, rope, plan=plan,
                         side_plans=side_plans)
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
