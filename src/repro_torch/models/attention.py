"""GQA attention block over a KV cache.

Counterpart of ``repro.models.attention``: full attention, local
(windowed) attention over a ring cache, and encoder-decoder cross
attention.  A layer's cache is a dict of tensors: ``k`` / ``v`` of shape
``(B, L, H_kv, D)`` in the KV dtype, plus ``k_s`` / ``v_s`` f32 scales of
shape ``(B, L, H_kv)`` when the cache is quantized (int8 or fp8), as in
the reference.  They are views of the engine's static tensors (L =
max_len, or the ring's ``min(window, max_len)`` rows) or of a view the
paged layout gathered (L = the resident bucket).

Two decode launches attend a length that is not the one the frozen
decode plan was made for: cross attention reads the whole fixed-length
encoder memory, and a windowed layer its whole ring.  Each takes a plan
frozen for its own length (the scheduler's side plans), or else drops
the frozen decision and lets the policy decide inside the launch over
that length, as the reference does (:func:`plan_for_length`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import ParamSpec, Rope, SpecModule, \
    apply_rope, sharded, tp_join, tp_sum
from repro_torch.plan import LaunchPlan
from repro_torch.quant import QUANT_DTYPES, QuantizedKV, Quantizer

LayerCache = Dict[str, torch.Tensor]


class Attention(SpecModule):
    """Attention weights in the reference layout: ``wq`` (d, Hq, D),
    ``wk`` / ``wv`` (d, Hkv, D), ``wo`` (Hq, D, d), optional biases."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        d, hd = cfg.d_model, cfg.resolved_head_dim
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        specs = {
            "wq": ParamSpec((d, hq, hd), ("embed", "heads", "head_dim")),
            "wk": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
            "wv": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
            "wo": ParamSpec((hq, hd, d), ("heads", "head_dim", "embed"),
                            fan_in=hq * hd),
        }
        if cfg.qkv_bias:
            specs["bq"] = ParamSpec((hq, hd), ("heads", "head_dim"),
                                    init="zeros")
            specs["bk"] = ParamSpec((hkv, hd), ("kv_heads", "head_dim"),
                                    init="zeros")
            specs["bv"] = ParamSpec((hkv, hd), ("kv_heads", "head_dim"),
                                    init="zeros")
        super().__init__(specs, dtype, device)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bld,dhk->blhk") as one matmul."""
    B, L, d = x.shape
    return (x @ w.reshape(d, -1)).view(B, L, w.shape[1], w.shape[2])


def _heads(p: Attention, x: torch.Tensor, w: str,
           b: Optional[str]) -> torch.Tensor:
    """x (B, L, d) through weight ``w`` (d, H, D) plus bias ``b``: (B, L,
    H, D) (also MLA's up projections from a rank-r input).  Over
    heads-sharded weights each device projects its heads and the heads
    join on the lead device; else the lead projects them all."""
    def one(mod, xs):
        y = _proj(xs, getattr(mod, w))
        return y + getattr(mod, b).to(y.dtype) if b else y
    if sharded(p, w) is None:
        return one(p, x)
    return tp_join(p, one, x, dim=2)


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 rope: Rope
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, L, d) -> q (B, L, Hq, D), k / v (B, L, Hkv, D), RoPE applied
    (``rope`` from :func:`~repro_torch.models.common.rope_angles`).
    Tensor-parallel weights project each device's heads there
    (:func:`_heads`); K / V heads the axis does not divide are projected
    once, on the lead device."""
    bias = cfg.qkv_bias
    q = _heads(p, x, "wq", "bq" if bias else None)
    k = _heads(p, x, "wk", "bk" if bias else None)
    v = _heads(p, x, "wv", "bv" if bias else None)
    return apply_rope(q, rope), apply_rope(k, rope), v


def _out_proj(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """einsum("...hk,hkd->...d") as one matmul.  Over heads-sharded
    ``wo`` each device multiplies its heads' outputs and the partial
    (..., d) sum on the lead device in device order."""
    def one(mod, o):
        return o.flatten(-2) @ mod.wo.reshape(-1, mod.wo.shape[-1])
    if sharded(p, "wo") is None:
        return one(p, out)
    return tp_sum(p, one, out, split=(out.dim() - 2,))


def plan_for_length(plan: LaunchPlan, length: int) -> LaunchPlan:
    """The plan a decode launch over exactly ``length`` cache rows takes
    from ``plan``: ``plan`` itself when it was frozen for that length with
    no bucket cut (a side plan, see
    :meth:`repro_torch.serving.scheduler.Scheduler.side_plans`), else its
    policy overrides alone, so the policy decides inside the launch over
    ``length`` (the reference's ``plan.context_only()``)."""
    if plan is None or not plan.frozen:
        return plan
    if plan.bucket is None and plan.spec is not None \
            and plan.spec.seqlen_k == length:
        return plan
    return plan.context_only()


def ring_rows(x: torch.Tensor, ring: int) -> torch.Tensor:
    """A prompt's rows ``x`` (B, L, ...) laid out in a ``ring``-row ring
    cache: for L < ring the rows themselves, at rows [0, L); for L >=
    ring the last ``ring`` positions, position p at row p % ring."""
    L = x.shape[1]
    if L < ring:
        return x
    base = L - ring
    src = base + torch.remainder(
        torch.arange(ring, device=x.device) - base, ring)
    return x[:, src]


def attention_train(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    rope: Rope, *, window: Optional[int] = None
                    ) -> torch.Tensor:
    """Causal (with a ``window``, local) attention over a whole sequence,
    x (B, L, d) -> (B, L, d): the training path, the reference's
    ``attention_train``.  It runs ``ops.attention``, which differentiates
    through the prefill kernel and its backward on the card.  Over
    weights whose query and KV heads the model axis both cuts, each
    device attends its own heads (the KV heads its query heads read lie
    on it too) and the partial outputs sum on the lead device, as the
    reference's head-sharded attention runs a launch a device."""
    if sharded(p, "wq") is not None and sharded(p, "wk") is not None:
        def one(mod, xs):
            r = None if rope is None else tuple(t.to(xs.device)
                                                for t in rope)
            q, k, v = _project_qkv(mod, cfg, xs, r)
            return _out_proj(mod, ops.attention(q, k, v, causal=True,
                                                window=window))
        return tp_sum(p, one, x)
    q, k, v = _project_qkv(p, cfg, x, rope)
    return _out_proj(p, ops.attention(q, k, v, causal=True, window=window))


def attention_prefill(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                      rope: Rope, *, kv_dtype: str = "bfloat16",
                      window: Optional[int] = None,
                      ring: Optional[int] = None
                      ) -> Tuple[torch.Tensor, LayerCache]:
    """Causal attention over a whole prompt.  Returns (y (B, L, d), the
    prompt's cache rows): ``k`` / ``v`` (B, L, Hkv, D) in the activation
    dtype, which the caller's write casts to the cache dtype, or, for a
    quantized ``kv_dtype``, quantized rows plus ``k_s`` / ``v_s`` scales.
    Attention itself reads the unquantized K/V.  With a ``window`` the
    attention is local (key positions > query position - window) and the
    rows come in the ``ring``-row ring layout of :func:`ring_rows` (L
    rows for L < ring, else ring rows), which the windowed decode
    continues."""
    q, k, v = _project_qkv(p, cfg, x, rope)
    out = ops.attention(q, k, v, causal=True, window=window)
    y = _out_proj(p, out)
    if window is not None:
        k, v = ring_rows(k, ring), ring_rows(v, ring)
    if kv_dtype in QUANT_DTYPES:
        qz = Quantizer.from_kv_dtype(kv_dtype)
        kq, ks = qz.quantize(k)
        vq, vs = qz.quantize(v)
        return y, {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
    dt = getattr(torch, cfg.dtype)
    return y, {"k": k.to(dt), "v": v.to(dt)}


def attention_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     cache: LayerCache, t: torch.Tensor, rope: Rope, *,
                     plan: LaunchPlan = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """One decode step for every slot.  Returns (B, 1, d).

    ``t`` (B,) int64 holds each slot's position and ``rope`` its angles.
    Unlike the reference, which returns an updated copy of the cache,
    this writes the new K/V row of every slot into ``cache`` (views of
    the engine's static buffers) IN PLACE at row ``t``, then attends over
    rows ``[0, t]`` through the frozen ``plan``.  A quantized cache gets
    the row quantized, data and scales written, and is read through the
    fused-dequant kernel.  Under a plan whose ``seq_shard_mesh`` is set
    (a sequence-sharded shard) the write and the attention go through
    :func:`repro_torch.kernels.ops.decode_update_seqsharded`, one
    partials launch a device of the shard, merged; over a head-sharded
    cache (:class:`~repro_torch.kernels.ops.HeadShards`, the frozen mesh
    decode step's) through :func:`repro_torch.kernels.ops.
    decode_update_headsharded`, a launch a device over its KV heads.
    With a ``window`` the
    cache is a ring of W rows: the row lands at ``t % W`` and attention
    reads ``min(t + 1, W)`` rows, every resident one (RoPE was applied at
    absolute positions, so ring order does not matter), over the whole
    ring under :func:`plan_for_length` of W.
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x, rope)
    rows = torch.arange(B, device=x.device)
    kv_len = t + 1
    qz = Quantizer.for_cache(cache)
    head_sharded = isinstance(cache["k"], ops.HeadShards)
    if head_sharded or (plan is not None
                        and plan.seq_shard_mesh is not None):
        new = {"k": k_new[:, 0], "v": v_new[:, 0]}
        if qz is not None:
            new["k"], new["k_s"] = qz.quantize(k_new[:, 0])
            new["v"], new["v_s"] = qz.quantize(v_new[:, 0])
        if head_sharded:
            # the frozen step's head-sharded cache: a launch a device
            # over its KV heads
            out = ops.decode_update_headsharded(q[:, 0], cache, new, t,
                                                kv_len, plan=plan)
        else:
            # a sequence-sharded shard: one partials launch a device,
            # merged
            out = ops.decode_update_seqsharded(
                q[:, 0], cache, new, t, kv_len,
                devices=plan.seq_shard_mesh.rows[0])
        return _out_proj(p, out)[:, None]
    extra = {}
    if window is not None:
        W = cache["k"].shape[1]
        t = torch.remainder(t, W)
        kv_len = kv_len.clamp(max=W)
        plan = plan_for_length(plan, W)
        extra["use_ctx_metadata"] = False
    if qz is not None:
        kq, kns = qz.quantize(k_new[:, 0])
        vq, vns = qz.quantize(v_new[:, 0])
        # one-byte storage written as raw bytes: indexed writes of fp8
        # are not implemented for every device
        cache["k"].view(torch.uint8)[rows, t] = kq.view(torch.uint8)
        cache["v"].view(torch.uint8)[rows, t] = vq.view(torch.uint8)
        cache["k_s"][rows, t] = kns
        cache["v_s"][rows, t] = vns
        out = ops.decode_attention_quant(
            q[:, 0], QuantizedKV(cache["k"], cache["v"], cache["k_s"],
                                 cache["v_s"]), kv_len, plan=plan, **extra)
    else:
        cache["k"][rows, t] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, t] = v_new[:, 0].to(cache["v"].dtype)
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], kv_len,
                                   plan=plan, **extra)
    return _out_proj(p, out)[:, None]


def _project_q(p: Attention, cfg: ModelConfig,
               x: torch.Tensor) -> torch.Tensor:
    q = _proj(x, p.wq)
    return q + p.bq.to(q.dtype) if cfg.qkv_bias else q


def precompute_cross_kv(p: Attention, cfg: ModelConfig,
                        memory: torch.Tensor) -> LayerCache:
    """Project the encoder output ``memory`` (B, Lk, d) to cross K / V
    (B, Lk, Hkv, D), once a request: what the decode steps read."""
    k, v = _proj(memory, p.wk), _proj(memory, p.wv)
    if cfg.qkv_bias:
        k = k + p.bk.to(k.dtype)
        v = v + p.bv.to(v.dtype)
    return {"k": k, "v": v}


def cross_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    kv: LayerCache) -> torch.Tensor:
    """Cross attention of the decoder stream ``x`` (B, Lq, d) over
    precomputed cross K / V (:func:`precompute_cross_kv`, or a slot's
    resident bfloat16 ones, read in q's dtype): no mask, no RoPE.
    Returns (B, Lq, d)."""
    q = _project_q(p, cfg, x)
    out = ops.attention(q, kv["k"].to(q.dtype), kv["v"].to(q.dtype),
                        causal=False)
    return _out_proj(p, out)


def cross_attention_train(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                          memory: torch.Tensor) -> torch.Tensor:
    """Encoder-decoder cross attention over the encoder output ``memory``
    (B, Lk, d): (B, Lq, d)."""
    return cross_attention(p, cfg, x, precompute_cross_kv(p, cfg, memory))


def cross_attention_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                           cache: LayerCache, *,
                           plan: LaunchPlan = None) -> torch.Tensor:
    """Decode-time cross attention of ``x`` (B, 1, d) against a fixed-
    length memory: ``cache`` holds the precomputed cross ``k`` / ``v`` (B,
    Lk, Hkv, D), every row of which is attended (kv_len = Lk).  That is
    the paper's shape family (Whisper: 1500 frames, 12 KV blocks), split
    under :func:`plan_for_length` of Lk, outside any ambient frozen plan.
    Returns (B, 1, d)."""
    B = x.shape[0]
    k, v = cache["k"], cache["v"]
    Lk = k.shape[1]
    kv_len = torch.full((B,), Lk, dtype=torch.int64, device=x.device)
    out = ops.decode_attention(_project_q(p, cfg, x)[:, 0], k, v, kv_len,
                               plan=plan_for_length(plan, Lk),
                               use_ctx_metadata=False)
    return _out_proj(p, out)[:, None]


def _place_rows(old: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """Write ``new`` (B, M, ...) into ``old`` (B, V, ...) at rows [start,
    start + M), in place; rows past the view's end are dropped, not
    clamped back into it (the reference masks them for the same reason).
    One-byte storage is written as raw bytes: indexed writes of fp8 are
    not implemented on every device."""
    m = min(new.shape[1], old.shape[1] - start)
    ops.bit_view(old)[:, start:start + m] = ops.bit_view(
        new[:, :m].to(old.dtype))


def attention_suffix_prefill(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                             cache: LayerCache, start: int, rope: Rope, *,
                             kv_dtype: str = "bfloat16") -> torch.Tensor:
    """Prefill only rows [start, start + M) against a resident prefix
    (prefix sharing).  Returns y (1, M, d).

    ``x`` (1, M, d) is the unshared suffix and ``rope`` its angles at
    positions ``start + i``; ``cache`` is the slot's batch-1 view, whose
    rows [0, start) hold the adopted pages' K/V.  The suffix's K/V
    (quantized first for a quantized ``kv_dtype``) is placed into the
    view in place, and the suffix queries attend over the whole view
    through the causal ``q_offset = start``: rows past ``start + M`` are
    the slot's unwritten tail, at key positions beyond every query.  As
    in the reference, a quantized view is attended dequantized.  On the
    card this runs the prefill kernel, which takes ``q_offset`` at run
    time; the reference sends it to XLA, because its Pallas kernel needs
    a static offset.
    """
    q, k, v = _project_qkv(p, cfg, x, rope)
    if kv_dtype in QUANT_DTYPES:
        qz = Quantizer.from_kv_dtype(kv_dtype)
        (kq, ks), (vq, vs) = qz.quantize(k), qz.quantize(v)
        for name, rows in (("k", kq), ("v", vq), ("k_s", ks), ("v_s", vs)):
            _place_rows(cache[name], rows, start)
        kf = qz.dequantize(cache["k"], cache["k_s"])
        vf = qz.dequantize(cache["v"], cache["v_s"])
    else:
        _place_rows(cache["k"], k, start)
        _place_rows(cache["v"], v, start)
        kf, vf = cache["k"], cache["v"]
    out = ops.attention(q, kf.to(q.dtype), vf.to(q.dtype), causal=True,
                        q_offset=start)
    return _out_proj(p, out)


def _place_rows_at(old: torch.Tensor, new: torch.Tensor,
                   start: torch.Tensor) -> None:
    """Per-slot :func:`_place_rows`: write ``new`` (B, M, ...) into ``old``
    (B, V, ...) at rows [start[b], start[b] + M) of each slot ``b``, in
    place.  A verify block places each slot's rows at that slot's own
    position, so the offset is a vector.  Rows past the view's end (a
    padding row, a dead slot's stale position) are dropped, not clamped
    back into it: their writes go to the view's last row carrying that
    row's own value (the block's row that lands there, else its old
    content), so every write to it agrees, and no host sync is needed to
    find them.  One-byte storage is written as raw bytes."""
    B, V = old.shape[:2]
    M = new.shape[1]
    dev = old.device
    st = start.to(device=dev, dtype=torch.int64)[:, None]           # (B, 1)
    j = torch.arange(M, device=dev)
    dst = st + j                                                    # (B, M)
    inside = dst < V
    at_last = (V - 1 - st).expand(B, M)     # the block row landing on V-1
    src = torch.where(inside, j, at_last.clamp(0, M - 1))
    from_block = inside | ((at_last >= 0) & (at_last < M))
    slot = torch.arange(B, device=dev)[:, None].expand(B, M)
    dst = dst.clamp(max=V - 1)
    raw = ops.bit_view(old)
    vals = ops.bit_view(new.to(old.dtype))[slot, src]
    keep = from_block.reshape((B, M) + (1,) * (old.dim() - 2))
    raw[slot, dst] = torch.where(keep, vals, raw[slot, dst])


def attention_verify(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     cache: LayerCache, t: torch.Tensor, rope: Rope, *,
                     plan: LaunchPlan = None) -> torch.Tensor:
    """Speculative-verify attention: score an ``M = k + 1``-row query
    block per slot.  Returns y (B, M, d).

    ``x`` (B, M, d) holds each slot's current token and drafts, ``t``
    (B,) each slot's position and ``rope`` the angles at ``t + j``.  The
    block's K/V rows land in ``cache`` in place at [t, t + M) per slot
    (rows past the view are dropped), then the queries attend causal
    within the block through :func:`ops.verify_attention` and the frozen
    ``("verify", k, bucket)`` plan.  The caller commits only accepted
    rows: the paged layout writes back only the pages up to the accept
    point, and the host rolls ``kv_len`` back; rejected rows stay above
    ``kv_len``, masked.  A quantized cache gets the rows quantized and
    placed, data and scales, and is attended dequantized to q's dtype, as
    in the reference.
    """
    q, k, v = _project_qkv(p, cfg, x, rope)
    qz = Quantizer.for_cache(cache)
    if qz is not None:
        (kq, ks), (vq, vs) = qz.quantize(k), qz.quantize(v)
        for name, rows in (("k", kq), ("v", vq), ("k_s", ks), ("v_s", vs)):
            _place_rows_at(cache[name], rows, t)
        kf = qz.dequantize(cache["k"], cache["k_s"])
        vf = qz.dequantize(cache["v"], cache["v_s"])
    else:
        _place_rows_at(cache["k"], k, t)
        _place_rows_at(cache["v"], v, t)
        kf, vf = cache["k"], cache["v"]
    out = ops.verify_attention(q, kf.to(q.dtype), vf.to(q.dtype), t,
                               plan=plan)
    return _out_proj(p, out)


# int8 per-(token, head) transforms as module functions, as in the
# reference; they delegate to the default Quantizer.
_INT8 = Quantizer()


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(..., head) int8 over the feature dim.
    x: (..., H, D) -> (q int8 same shape, scale f32 (..., H))."""
    return _INT8.quantize(x)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return _INT8.dequantize(q, scale)
