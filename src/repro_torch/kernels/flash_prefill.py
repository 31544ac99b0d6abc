"""Causal flash-attention forward for prefill, and its gradient.

Counterpart of ``repro.kernels.flash_prefill.flash_prefill``.  On a CUDA
tensor :func:`flash_prefill` launches ``csrc/flash_prefill.cu``: bf16 on
the tensor cores (wgmma fed by TMA), float32 on the CUDA cores.  Its KV
loop stops at the causal limit (and starts at the window, when one is
given) and its ``q_offset`` is a runtime int.  On a CPU tensor it runs
:func:`prefill_plain`.  Both take q already scaled by ``D ** -0.5``.
v may be narrower than q and k (MLA's prefill, 96 / 64).

Training differentiates through it.  On a CUDA tensor with grad enabled
and an input that needs a gradient, :func:`flash_prefill` runs
:class:`FlashPrefillFn`: its forward launches the prefill kernel with the
per-row log-sum-exp (:func:`flash_prefill_lse`) and saves q, k, v, the
output and the LSE; its backward launches ``csrc/flash_prefill_bwd.cu``
(:func:`flash_prefill_bwd`, dq, dk, dv in two launches).  That kernel
replaces no Pallas kernel: the reference trains through
``ref.flash_attention_xla`` and lets XLA differentiate it.  On a CPU
tensor autograd differentiates :func:`prefill_plain` itself;
:func:`prefill_backward_plain` is the backward kernel's plain version,
for the tests and the card's checks.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (64, 128, 160, 256)
# (q / k width, v width) pairs with v narrower that the bf16 tensor-core
# body is compiled for: MLA's prefill (minicpm3-4b: 64 nope + 32 rope
# columns of q and k, 64 of v)
WIDTH_PAIRS = ((96, 64),)
# kernel launches of one flash_prefill_bwd call: dq (and delta), then dk, dv
BWD_LAUNCHES_PER_CALL = 2


def _visible(Lq: int, Lk: int, causal: bool, window: Optional[int],
             q_offset: int, device) -> torch.Tensor:
    """(Lq, Lk) bool: which keys each query row attends."""
    qpos = torch.arange(Lq, device=device)[:, None] + q_offset
    kpos = torch.arange(Lk, device=device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version: materialising attention on pre-scaled q."""
    return ref.naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=1.0)


def prefill_lse_plain(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0) -> torch.Tensor:
    """The prefill kernel's LSE output, plainly: each (b, query head,
    row)'s log-sum-exp of the pre-scaled scores over its visible keys,
    (B, Hq, Lq) in float32 (float64 for a float64 q); +inf on a row with
    no visible key, whose P is then 0 in the backward."""
    B, Lq, Hq, D = q.shape
    _, Lk, Hkv, _ = k.shape
    dt = ref.acc_dtype(q)
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.to(dt).reshape(B, Lq, Hkv, Hq // Hkv, D), k.to(dt))
    mask = _visible(Lq, Lk, causal, window, q_offset, q.device)
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    lse = lse.masked_fill(lse == float("-inf"), float("inf"))
    return lse.reshape(B, Hq, Lq)


def prefill_backward_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, o: torch.Tensor,
                           lse: torch.Tensor, do: torch.Tensor, *,
                           causal: bool = True, window: Optional[int] = None,
                           q_offset: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain version of the backward kernel: (dq, dk, dv) in q's dtype,
    from pre-scaled q (B, Lq, Hq, D), k (B, Lk, Hkv, D), v (B, Lk, Hkv,
    Dv), the forward's output o and ``lse`` (B, Hq, Lq), and the output's
    gradient ``do``.  It materialises P = exp(S - lse) on the visible keys
    and applies the textbook formulas with delta = rowsum(do * o): dS =
    P (do v^T - delta), dq = dS k, dk = dS^T q, dv = P^T do.  float32
    arithmetic, float64 when q is float64."""
    B, Lq, Hq, D = q.shape
    _, Lk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    g = Hq // Hkv
    dt = ref.acc_dtype(q)
    qg = q.to(dt).reshape(B, Lq, Hkv, g, D)
    dog = do.to(dt).reshape(B, Lq, Hkv, g, Dv)
    kf, vf = k.to(dt), v.to(dt)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)
    mask = _visible(Lq, Lk, causal, window, q_offset, q.device)
    p = torch.exp(s - lse.to(dt).reshape(B, Hkv, g, Lq)[..., None])
    p = torch.where(mask, p, torch.zeros((), dtype=dt, device=q.device))
    delta = (dog * o.to(dt).reshape(B, Lq, Hkv, g, Dv)).sum(-1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(B, Lq, Hq, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("flash_prefill").flash_prefill
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = build.load("flash_prefill_bwd").flash_prefill_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], backward: bool = False) -> None:
    """Raise unless the prefill kernel (or, with ``backward``, the
    backward kernel, which also takes WIDTH_PAIRS in float32) takes these
    inputs."""
    B, Lq, Hq, D = q.shape
    _, Lk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    if Dv == D and D not in HEAD_DIMS:
        raise ValueError(f"flash_prefill kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    if Dv != D and ((D, Dv) not in WIDTH_PAIRS
                    or (q.dtype != torch.bfloat16 and not backward)):
        raise ValueError(f"flash_prefill kernel takes q / k and v widths "
                         f"equal in {HEAD_DIMS}, or in {WIDTH_PAIRS} in "
                         f"bfloat16 (the f32 CUDA-core body needs equal "
                         f"widths); got ({D}, {Dv}) in {q.dtype}")
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_prefill kernel needs q, k, v of one dtype "
                         f"in {list(build.DTYPE_CODES)}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if k.shape != (B, Lk, Hkv, D) or v.shape != (B, Lk, Hkv, Dv) \
            or Hq % Hkv:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"does not fit q {tuple(q.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_prefill kernel takes contiguous q, k, v")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    build.cuda_args(q, k, v)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: Optional[int], q_offset: int,
            with_lse: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One prefill kernel launch: (out, the LSE or None).  A launch counts
    under the kernel's name and under ``(name, dtype name, Lq)``: bf16 and
    float32 take different kernels."""
    _check(q, k, v, window)
    B, Lq, Hq, D = q.shape
    _, Lk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    out = torch.empty((B, Lq, Hq, Dv), device=q.device, dtype=q.dtype)
    lse = (torch.empty((B, Hq, Lq), device=q.device, dtype=torch.float32)
           if with_lse else None)
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, Lq, Lk, Hq, Hkv, D, Dv, int(causal), window or 0,
                   int(q_offset), build.DTYPE_CODES[q.dtype],
                   lse.data_ptr() if with_lse else None, build.stream_ptr())
    build.check(err, "flash_prefill")
    build.LAUNCHES["flash_prefill"] += 1
    build.LAUNCHES["flash_prefill", str(q.dtype)[6:], Lq] += 1
    return out, lse


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (B, Lq, Hq, D) pre-scaled; k: (B, Lk, Hkv, D); v: (B, Lk, Hkv,
    Dv) -> (B, Lq, Hq, Dv) in q's dtype.  Dv = D in HEAD_DIMS, or (D, Dv)
    in WIDTH_PAIRS in bf16; a CUDA tensor at other widths raises.
    ``q_offset`` is the absolute position of ``q[:, 0]``.  Where autograd
    will need the gradient (grad enabled, an input that requires it), a
    CUDA call runs :class:`FlashPrefillFn`, whose backward is the backward
    kernel; it never detaches and never falls back to the plain version."""
    if not q.is_cuda:
        return prefill_plain(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashPrefillFn.apply(q, k, v, causal, window, q_offset)
    return _launch(q, k, v, causal=causal, window=window, q_offset=q_offset,
                   with_lse=False)[0]


def flash_prefill_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse (B, Hq, Lq) f32): the prefill kernel with its LSE output
    on a CUDA tensor, the plain versions on a CPU one.  Not
    differentiable itself: :class:`FlashPrefillFn` is its autograd
    form."""
    if not q.is_cuda:
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        return prefill_plain(q, k, v, **kw), prefill_lse_plain(q, k, **kw)
    return _launch(q, k, v, causal=causal, window=window, q_offset=q_offset,
                   with_lse=True)


def flash_prefill_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      *, causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the prefill attention, in q's dtype: the backward
    kernel on CUDA tensors (two launches, :data:`BWD_LAUNCHES_PER_CALL`,
    each counted under ``flash_prefill_bwd`` and ``(name, dtype name,
    Lq)``), :func:`prefill_backward_plain` on CPU ones.  ``lse`` is the
    forward's (:func:`flash_prefill_lse`), ``o`` its output and ``do`` the
    output's gradient; dq is the gradient of the pre-scaled q."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if not q.is_cuda:
        return prefill_backward_plain(q, k, v, o, lse, do, **kw)
    _check(q, k, v, window, backward=True)
    B, Lq, Hq, D = q.shape
    _, Lk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    if o.shape != (B, Lq, Hq, Dv) or do.shape != o.shape \
            or o.dtype != q.dtype or do.dtype != q.dtype \
            or lse.shape != (B, Hq, Lq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_prefill_bwd takes o and do of shape "
                         f"{(B, Lq, Hq, Dv)} in {q.dtype} and lse "
                         f"{(B, Hq, Lq)} float32; got {tuple(o.shape)} "
                         f"{o.dtype}, {tuple(do.shape)} {do.dtype}, "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not (o.is_contiguous() and do.is_contiguous()
            and lse.is_contiguous()):
        raise ValueError("flash_prefill_bwd takes contiguous o, do, lse")
    build.cuda_args(o, do, lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    err = _bwd_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                       dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                       delta.data_ptr(), B, Lq, Lk, Hq, Hkv, D, Dv,
                       int(causal), window or 0, int(q_offset),
                       build.DTYPE_CODES[q.dtype], build.stream_ptr())
    build.check(err, "flash_prefill_bwd")
    build.LAUNCHES["flash_prefill_bwd"] += BWD_LAUNCHES_PER_CALL
    build.LAUNCHES["flash_prefill_bwd", str(q.dtype)[6:], Lq] += \
        BWD_LAUNCHES_PER_CALL
    return dq, dk, dv


class FlashPrefillFn(torch.autograd.Function):
    """Prefill attention with a backward: the forward runs
    :func:`flash_prefill_lse` and saves q, k, v, the output and the LSE;
    the backward runs :func:`flash_prefill_bwd`.  On CUDA tensors those
    are the two kernels; on CPU ones their plain versions (which is how
    the CPU tests hold the wiring against autograd's gradient of
    :func:`prefill_plain`).  Under ``torch.utils.checkpoint`` the forward
    runs again in the backward pass, so each call then launches the
    prefill kernel twice."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = flash_prefill_lse(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_prefill_bwd(q, k, v, out, lse, do.contiguous(),
                                       causal=causal, window=window,
                                       q_offset=q_offset)
        return dq, dk, dv, None, None, None
