"""Causal flash-attention forward for prefill.

Counterpart of ``repro.kernels.flash_prefill.flash_prefill``.  On a CUDA
tensor :func:`flash_prefill` launches ``csrc/flash_prefill.cu``: bf16 on
the tensor cores (wgmma fed by TMA), float32 on the CUDA cores.  Its KV
loop stops at the causal limit (and starts at the window, when one is
given) and its ``q_offset`` is a runtime int.  On a CPU tensor it runs
:func:`prefill_plain`.  Both take q already scaled by ``D ** -0.5``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (64, 128, 160, 256)


def prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version: materialising attention on pre-scaled q."""
    return ref.naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=1.0)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("flash_prefill").flash_prefill
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (B, Lq, Hq, D) pre-scaled; k, v: (B, Lk, Hkv, D) -> (B, Lq, Hq, D)
    in q's dtype.  ``q_offset`` is the absolute position of ``q[:, 0]``.
    A launch counts under the kernel's name and under ``(name, dtype
    name, Lq)``: bf16 and float32 take different kernels."""
    if not q.is_cuda:
        return prefill_plain(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    B, Lq, Hq, D = q.shape
    _, Lk, Hkv, _ = k.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_prefill kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_prefill kernel needs q, k, v of one dtype "
                         f"in {list(build.DTYPE_CODES)}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if k.shape != (B, Lk, Hkv, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"does not fit q {tuple(q.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_prefill kernel takes contiguous q, k, v")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    build.cuda_args(q, k, v)
    out = torch.empty_like(q)
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, Lq, Lk, Hq, Hkv, D, int(causal), window or 0,
                   int(q_offset), build.DTYPE_CODES[q.dtype],
                   build.stream_ptr())
    build.check(err, "flash_prefill")
    build.LAUNCHES["flash_prefill"] += 1
    build.LAUNCHES["flash_prefill", str(q.dtype)[6:], Lq] += 1
    return out
