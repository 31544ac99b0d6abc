"""Split-KV combine: merge S unnormalised decode partials.

Counterpart of ``repro.kernels.flash_combine.flash_combine``.  On a CUDA
tensor :func:`flash_combine` launches ``csrc/flash_combine.cu``, a
fixed-order reduction over the splits with no atomics, so the same split
gives the same bits; on a CPU tensor it runs :func:`combine_plain`.
No serving path launches it: both decode kernels, over a bf16 / f32 or
a quantized cache, merge their own splits in their epilogue with its
arithmetic.  It merges partials written by their partials-only epilogue.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref


def combine_plain(acc: torch.Tensor, l: torch.Tensor, m: torch.Tensor, *,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: :func:`ref.lse_combine` in the output dtype."""
    return ref.lse_combine(acc, l, m).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("flash_combine").flash_combine
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_combine(acc: torch.Tensor, l: torch.Tensor, m: torch.Tensor, *,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """acc (S, B, Hkv, G, D), l / m (S, B, Hkv, G), all f32 ->
    (B, Hkv, G, D) normalised output in ``out_dtype``."""
    if not acc.is_cuda:
        return combine_plain(acc, l, m, out_dtype=out_dtype)
    S, B, Hkv, G, D = acc.shape
    if acc.dtype != torch.float32 or l.dtype != torch.float32 \
            or m.dtype != torch.float32:
        raise ValueError("flash_combine kernel takes float32 partials")
    if l.shape != (S, B, Hkv, G) or m.shape != l.shape:
        raise ValueError(f"l/m shape {tuple(l.shape)}/{tuple(m.shape)} "
                         f"does not match acc {tuple(acc.shape)}")
    if not (acc.is_contiguous() and l.is_contiguous() and m.is_contiguous()):
        raise ValueError("flash_combine kernel takes contiguous partials")
    if out_dtype not in build.DTYPE_CODES:
        raise ValueError(f"flash_combine kernel writes "
                         f"{list(build.DTYPE_CODES)}, got {out_dtype}")
    build.cuda_args(acc, l, m)
    out = torch.empty((B, Hkv, G, D), device=acc.device, dtype=out_dtype)
    err = _entry()(acc.data_ptr(), l.data_ptr(), m.data_ptr(),
                   out.data_ptr(), S, B, Hkv, G, D,
                   build.DTYPE_CODES[out_dtype], build.stream_ptr())
    build.check(err, "flash_combine")
    build.LAUNCHES["flash_combine"] += 1
    return out
