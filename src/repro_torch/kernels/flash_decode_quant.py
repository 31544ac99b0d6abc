"""Split-KV flash decode over a quantized (int8 / fp8) KV cache.

Counterpart of ``repro.kernels.flash_decode.flash_decode_quant_partials``
and, fused behind it, ``repro.kernels.flash_combine.flash_combine``.  On
a CUDA tensor both wrappers launch the hand-written Hopper kernel
``csrc/flash_decode_quant.cu``: :func:`flash_decode_quant` computes the
split partials and merges them in the same launch (the quantized decode
path's op); :func:`flash_decode_quant_partials` stops at the partials.
On a CPU tensor they run :func:`decode_quant_plain` and
:func:`decode_quant_partials_plain`.  The split partition is
:func:`repro_torch.kernels.flash_decode.split_bounds`, and the fused
kernel shares the bf16 cache's kernel's epilogue and workspace.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_combine import combine_plain
from repro_torch.kernels.flash_decode import HEAD_DIMS, fused_workspace, \
    split_bounds


def decode_quant_partials_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor, kv_len: torch.Tensor,
                                *, num_splits: int):
    """Plain PyTorch version of the kernel: each split's rows dequantized
    in f32 (``Quantizer.dequantize``), then :func:`ref.decode_partial`.

    q: (B, Hkv, G, D) pre-scaled; k, v: (B, L, Hkv, D) int8 or
    float8_e4m3fn; k_scale, v_scale: (B, L, Hkv) f32; kv_len: (B,),
    clamped to L.  Returns acc (S, B, Hkv, G, D) and l, m (S, B, Hkv, G)
    in float32.
    """
    B, Hkv, G, D = q.shape
    L = k.shape[1]
    qf = q.to(ref.acc_dtype(q))
    lens = kv_len.to(device=q.device, dtype=torch.int64).clamp(0, L)
    accs, ls, ms = [], [], []
    for s in range(num_splits):
        lo, hi = split_bounds(L, num_splits, s)
        if hi <= lo:
            accs.append(qf.new_zeros(B, Hkv, G, v.shape[-1]))
            ls.append(qf.new_zeros(B, Hkv, G))
            ms.append(qf.new_full((B, Hkv, G), ref.NEG_INF))
            continue
        pos = torch.arange(lo, hi, device=q.device)
        valid = pos[None, :] < lens[:, None]
        kc = k[:, lo:hi].float() * k_scale[:, lo:hi, :, None]
        vc = v[:, lo:hi].float() * v_scale[:, lo:hi, :, None]
        acc, l, m = ref.decode_partial(qf, kc, vc, valid)
        accs.append(acc)
        ls.append(l)
        ms.append(m)
    return torch.stack(accs), torch.stack(ls), torch.stack(ms)


def decode_quant_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor,
                       kv_len: torch.Tensor, *, num_splits: int,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel:
    :func:`decode_quant_partials_plain`, then :func:`combine_plain`.
    Returns (B, Hkv, G, D) in ``out_dtype`` (default q's dtype)."""
    parts = decode_quant_partials_plain(q, k, v, k_scale, v_scale, kv_len,
                                        num_splits=num_splits)
    return combine_plain(*parts, out_dtype=out_dtype or q.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("flash_decode_quant").flash_decode_quant
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, k_scale, v_scale, kv_len, num_splits, acc, l, m,
            counters=None, out=None) -> None:
    """Checks the operands and launches the kernel; with ``counters`` and
    ``out`` it merges the splits into ``out``, else writes the partials."""
    B, Hkv, G, D = q.shape
    L = k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_decode_quant kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    if q.dtype not in build.DTYPE_CODES:
        raise ValueError(f"flash_decode_quant kernel takes q in "
                         f"{list(build.DTYPE_CODES)}, got {q.dtype}")
    if k.dtype not in build.QUANT_CODES or v.dtype != k.dtype:
        raise ValueError(f"flash_decode_quant kernel takes k, v of one "
                         f"dtype in {list(build.QUANT_CODES)}, got "
                         f"{k.dtype}, {v.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError(f"flash_decode_quant kernel takes float32 scales, "
                         f"got {k_scale.dtype}, {v_scale.dtype}")
    if k.shape != (B, L, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if k_scale.shape != (B, L, Hkv) or v_scale.shape != k_scale.shape:
        raise ValueError(f"scale shape {tuple(k_scale.shape)}/"
                         f"{tuple(v_scale.shape)} does not match k "
                         f"{tuple(k.shape)}")
    if k.stride() != v.stride() or k.stride(3) != 1 or k.stride(2) != D \
            or k.stride(0) % 16 or k.stride(1) % 16:
        raise ValueError("k and v need one layout with contiguous "
                         "(Hkv, D) rows 16-byte aligned, got strides "
                         f"{k.stride()} and {v.stride()}")
    if k_scale.stride() != v_scale.stride() or k_scale.stride(2) != 1:
        raise ValueError("k_scale and v_scale need one layout with "
                         f"contiguous heads, got strides {k_scale.stride()}"
                         f" and {v_scale.stride()}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    build.cuda_args(q, k, v)            # 16-byte loads; scales are scalar
    if not (k_scale.is_cuda and v_scale.is_cuda):
        raise ValueError("k_scale and v_scale must be CUDA tensors")
    lens = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   k_scale.data_ptr(), v_scale.data_ptr(), lens.data_ptr(),
                   acc, l, m, counters, None if out is None else
                   out.data_ptr(), B, Hkv, G, L, num_splits, D, k.stride(0),
                   k.stride(1), k_scale.stride(0), k_scale.stride(1),
                   build.DTYPE_CODES[q.dtype], build.QUANT_CODES[k.dtype],
                   build.DTYPE_CODES[out.dtype] if out is not None else 0,
                   build.stream_ptr())
    build.check(err, "flash_decode_quant")
    build.LAUNCHES["flash_decode_quant"] += 1
    build.LAUNCHES[("flash_decode_quant", L, num_splits)] += 1


def flash_decode_quant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor,
                       kv_len: torch.Tensor, *, num_splits: int,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Split-KV decode attention over ``num_splits`` splits of a quantized
    cache, merged.

    q: (B, Hkv, G, D), pre-scaled, f32 or bf16 (bf16 runs on the tensor
    cores); k, v: (B, L, Hkv, D) int8 or float8_e4m3fn and k_scale,
    v_scale: (B, L, Hkv) f32, each possibly a strided view of a longer
    cache (``cache[:, :bucket]`` is read in place); kv_len: (B,) valid
    lengths, clamped to L.  Returns (B, Hkv, G, D) in ``out_dtype``
    (default q's dtype).  One launch computes the partials and their
    combine; it is counted under ``"flash_decode_quant"`` and under
    ``("flash_decode_quant", L, num_splits)``.
    """
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return decode_quant_plain(q, k, v, k_scale, v_scale, kv_len,
                                  num_splits=num_splits, out_dtype=out_dtype)
    if out_dtype not in build.DTYPE_CODES:
        raise ValueError(f"flash_decode_quant kernel writes "
                         f"{list(build.DTYPE_CODES)}, got {out_dtype}")
    B, Hkv, G, D = q.shape
    S = int(num_splits)
    acc, l, m, counters = fused_workspace(q.device, build.stream_ptr(), S,
                                          B, Hkv, G, D)
    out = torch.empty((B, Hkv, G, D), device=q.device, dtype=out_dtype)
    _launch(q, k, v, k_scale, v_scale, kv_len, S, acc, l, m, counters, out)
    return out


def flash_decode_quant_partials(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor, kv_len: torch.Tensor,
                                *, num_splits: int):
    """Split-KV partials over ``num_splits`` splits of a quantized cache,
    as :func:`flash_decode_quant` takes them: the same kernel, its
    epilogue writing the partials only.  Returns acc (S, B, Hkv, G, D)
    and l, m (S, B, Hkv, G) in f32."""
    if not q.is_cuda:
        return decode_quant_partials_plain(q, k, v, k_scale, v_scale, kv_len,
                                           num_splits=num_splits)
    B, Hkv, G, D = q.shape
    S = int(num_splits)
    acc = torch.empty((S, B, Hkv, G, D), device=q.device, dtype=torch.float32)
    l = torch.empty((S, B, Hkv, G), device=q.device, dtype=torch.float32)
    m = torch.empty_like(l)
    _launch(q, k, v, k_scale, v_scale, kv_len, S, acc.data_ptr(),
            l.data_ptr(), m.data_ptr())
    return acc, l, m
