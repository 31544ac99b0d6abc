"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 family).

Counterpart of ``repro.models.mla``.  MLA compresses K/V into one shared
latent stream per layer:

- prefill: queries come from a low-rank down and up projection
  (``q_lora``); keys and values are reconstructed from the compressed
  latent ``c_kv`` (rank ``kv_lora_rank``) plus a *shared* RoPE key of
  width ``qk_rope_head_dim``, and causal attention runs at q / k width
  ``qk_nope + qk_rope`` (96 for minicpm3-4b) and v width ``v_head_dim``
  (64).
- decode: the cache holds only ``[c_kv, k_rope]``, one ``latent`` leaf
  of shape (B, L, 1, kv_lora_rank + qk_rope_head_dim), so H_KV = 1.
  Decode uses the *absorbed* form: ``W_uk`` is folded into the query and
  ``W_uv`` into the output, so attention runs in latent space with K the
  whole latent row (288 wide) and V its first ``kv_lora_rank`` columns
  (256), a column view of the same cache.

Under tensor parallelism (``param_policy="tp"``) the per-head weights
(``q_up``, ``k_up``, ``v_up``, ``wo``) are heads-sharded: each device
runs its heads' up projections and absorptions, and the output
projection's partials sum on the lead device; the down projections and
the latent stay whole on the lead.

As in the reference, the latent cache is bfloat16 whatever the cache
dtype asked for (``Model.cache_shapes``): ``kv_quant`` leaves it
unquantized, so decode reads it through the bf16 decode kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import ParamSpec, Rope, SpecModule, \
    apply_rope, rms_norm, sharded, tp_join, tp_sum
from repro_torch.plan import LaunchPlan

LayerCache = Dict[str, torch.Tensor]


class MLA(SpecModule):
    """MLA weights in the reference layout: ``q_down`` (d, q_lora),
    ``q_norm`` (q_lora,), ``q_up`` (q_lora, H, nope + rope), ``kv_down``
    (d, r + rope), ``kv_norm`` (r,), ``k_up`` (r, H, nope), ``v_up`` (r,
    H, v), ``wo`` (H, v, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        m = cfg.mla
        d, h = cfg.d_model, cfg.num_heads
        dqk = m.qk_nope_head_dim + m.qk_rope_head_dim
        r = m.kv_lora_rank
        super().__init__({
            "q_down": ParamSpec((d, m.q_lora_rank), ("embed", None)),
            "q_norm": ParamSpec((m.q_lora_rank,), (None,), init="ones"),
            "q_up": ParamSpec((m.q_lora_rank, h, dqk),
                              (None, "heads", "head_dim"),
                              fan_in=m.q_lora_rank),
            "kv_down": ParamSpec((d, r + m.qk_rope_head_dim), ("embed", None)),
            "kv_norm": ParamSpec((r,), (None,), init="ones"),
            "k_up": ParamSpec((r, h, m.qk_nope_head_dim),
                              (None, "heads", "head_dim"), fan_in=r),
            "v_up": ParamSpec((r, h, m.v_head_dim),
                              (None, "heads", "head_dim"), fan_in=r),
            "wo": ParamSpec((h, m.v_head_dim, d),
                            ("heads", "head_dim", "embed"),
                            fan_in=h * m.v_head_dim),
        }, dtype, device)


def latent_width(cfg: ModelConfig) -> int:
    """Columns of one latent cache row: ``kv_lora_rank + qk_rope``."""
    return cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim


def _latents(p: MLA, cfg: ModelConfig, x: torch.Tensor, rope: Rope
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, d) -> (c_kv (B, L, r) normalized, k_rope (B, L, rope)
    rotated, one head shared by all)."""
    r = cfg.mla.kv_lora_rank
    kv = x @ p.kv_down
    c_kv = rms_norm(kv[..., :r], p.kv_norm, cfg.norm_eps)
    k_rope = apply_rope(kv[..., r:][:, :, None, :], rope)[:, :, 0]
    return c_kv, k_rope


def _queries(p: MLA, cfg: ModelConfig, x: torch.Tensor, rope: Rope
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (q_nope (B, L, H, nope), q_rope (B, L, H, rope) rotated)."""
    dn = cfg.mla.qk_nope_head_dim
    ql = rms_norm(x @ p.q_down, p.q_norm, cfg.norm_eps)
    q = attn_mod._heads(p, ql, "q_up", None)
    return q[..., :dn], apply_rope(q[..., dn:], rope)


def mla_train(p: MLA, cfg: ModelConfig, x: torch.Tensor, rope: Rope
              ) -> torch.Tensor:
    """Causal MLA over a whole sequence, x (B, L, d) -> (B, L, d): the
    reference's ``mla_train``.  K and V are rebuilt from the latent;
    attention runs at q / k width nope + rope and v width ``v_head_dim``,
    scaled by the q width ** -0.5.  ``rope`` holds the angles at width
    ``qk_rope_head_dim``."""
    return _mla_attend(p, cfg, x, rope)[0]


def _mla_attend(p: MLA, cfg: ModelConfig, x: torch.Tensor, rope: Rope
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(:func:`mla_train`'s output, c_kv, k_rope)."""
    m = cfg.mla
    q_nope, q_rope = _queries(p, cfg, x, rope)
    c_kv, k_rope = _latents(p, cfg, x, rope)
    k_nope = attn_mod._heads(p, c_kv, "k_up", None)
    v = attn_mod._heads(p, c_kv, "v_up", None)
    B, L, H, _ = q_nope.shape
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(
        B, L, H, m.qk_rope_head_dim)], dim=-1)
    out = ops.attention(q, k, v.contiguous(), causal=True)
    return attn_mod._out_proj(p, out), c_kv, k_rope


def mla_prefill(p: MLA, cfg: ModelConfig, x: torch.Tensor, rope: Rope
                ) -> Tuple[torch.Tensor, LayerCache]:
    """:func:`mla_train` plus the prompt's latent rows: (y (B, L, d),
    ``{"latent": (B, L, 1, r + rope)}`` in the model's dtype; the
    caller's write casts it to the cache's bfloat16)."""
    y, c_kv, k_rope = _mla_attend(p, cfg, x, rope)
    latent = torch.cat([c_kv, k_rope], dim=-1)[:, :, None]
    return y, {"latent": latent.to(getattr(torch, cfg.dtype))}


def mla_decode(p: MLA, cfg: ModelConfig, x: torch.Tensor, cache: LayerCache,
               t: torch.Tensor, rope: Rope, *,
               plan: LaunchPlan = None) -> torch.Tensor:
    """One absorbed-MLA decode step for every slot.  Returns (B, 1, d).

    Writes each slot's latent row ``[c_kv, k_rope]`` into ``cache``
    IN PLACE at row ``t``, then attends the pre-scaled latent query
    ``[q_nope W_uk^T, q_rope] * (nope + rope) ** -0.5`` over rows
    ``[0, t]`` with K the whole latent and V its first ``kv_lora_rank``
    columns, at ``scale=1.0``, through the frozen ``plan`` (sequence-
    sharded when its ``seq_shard_mesh`` is set); ``W_uv`` and
    ``wo`` then map the latent output back to d_model."""
    m = cfg.mla
    B = x.shape[0]
    q_nope, q_rope = _queries(p, cfg, x, rope)                # (B, 1, H, .)
    c_kv, k_rope = _latents(p, cfg, x, rope)                  # (B, 1, .)
    lat = cache["latent"]
    row = torch.cat([c_kv, k_rope], dim=-1)
    # absorb W_uk into q: q_nope . (c W_uk) = (q_nope W_uk^T) . c
    q_lat = _absorb_q(p, q_nope[:, 0])
    q_cat = torch.cat([q_lat, q_rope[:, 0]], dim=-1)          # (B, H, w)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    if plan is not None and plan.seq_shard_mesh is not None:
        out_lat = ops.decode_update_seqsharded(
            q_cat * scale, {"latent": lat}, {"latent": row}, t, t + 1,
            devices=plan.seq_shard_mesh.rows[0], v_width=m.kv_lora_rank,
            scale=1.0)
    else:
        rows = torch.arange(B, device=x.device)
        lat[rows, t] = row.to(lat.dtype)
        out_lat = ops.decode_attention(q_cat * scale, lat,
                                       lat[..., :m.kv_lora_rank], t + 1,
                                       scale=1.0, plan=plan)  # (B, H, r)
    return _absorb_out(p, out_lat)[:, None]


def _absorb_q(p: MLA, q_nope: torch.Tensor) -> torch.Tensor:
    """q_nope (B, H, nope) -> q_nope W_uk^T (B, H, r), each device's
    heads there under heads-sharded weights."""
    def one(mod, q):
        return torch.einsum("bhk,rhk->bhr", q, mod.k_up)
    if sharded(p, "k_up") is None:
        return one(p, q_nope)
    return tp_join(p, one, q_nope, dim=1, split=(1,))


def _absorb_out(p: MLA, out_lat: torch.Tensor) -> torch.Tensor:
    """The latent outputs (B, H, r) through ``W_uv`` then ``wo``: (B,
    d), summed over the devices' heads under heads-sharded weights."""
    def one(mod, o):
        out = torch.einsum("bhr,rhk->bhk", o, mod.v_up)      # absorb W_uv
        return torch.einsum("bhk,hkd->bd", out, mod.wo)
    if sharded(p, "v_up") is None:
        return one(p, out_lat)
    return tp_sum(p, one, out_lat, split=(1,))
