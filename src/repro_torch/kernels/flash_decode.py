"""Split-KV flash decode: the paper's target kernel.

Counterparts of ``repro.kernels.flash_decode.flash_decode_partials`` and,
fused behind it, ``repro.kernels.flash_combine.flash_combine``.  On a
CUDA tensor both wrappers launch the hand-written Hopper kernel
``csrc/flash_decode.cu``: :func:`flash_decode` computes the split
partials and merges them in the same launch (the decode path's op);
:func:`flash_decode_partials` stops at the partials.  On a CPU tensor
they run :func:`decode_plain` and :func:`decode_partials_plain`, the same
functions in plain PyTorch.

The cache is split into ``num_splits`` ranges of whole 128-row KV
blocks, FA3's partition: ``NB = ceil(nblk / S)`` blocks per split, split
``s`` covering blocks ``[s * NB, min((s + 1) * NB, nblk))``.  Each
(batch, kv head, split) yields an unnormalised partial ``(acc, l, m)``,
merged by the log-sum-exp combine of
:mod:`repro_torch.kernels.flash_combine`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_combine import combine_plain

BLOCK_K = 128                    # KV_BLOCK: split bounds count these
HEAD_DIMS = (64, 128, 160, 256)  # head dims the kernel is compiled for


def split_bounds(length: int, num_splits: int, split: int):
    """Row range ``[lo, hi)`` of split ``split`` over ``length`` rows."""
    nblk = -(-length // BLOCK_K)
    nb = -(-nblk // num_splits)
    lo = min(split * nb * BLOCK_K, length)
    hi = min((split + 1) * nb * BLOCK_K, length)
    return lo, hi


def decode_partials_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor, *, num_splits: int):
    """Plain PyTorch version of the kernel: the same split partition,
    each split through :func:`ref.decode_partial`.

    q: (B, Hkv, G, D) pre-scaled; k, v: (B, L, Hkv, D); kv_len: (B,),
    clamped to L.  Returns acc (S, B, Hkv, G, D) and l, m (S, B, Hkv, G)
    in float32.
    """
    B, Hkv, G, D = q.shape
    L = k.shape[1]
    qf = q.float()
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
        acc, l, m = ref.decode_partial(qf, k[:, lo:hi], v[:, lo:hi], valid)
        accs.append(acc)
        ls.append(l)
        ms.append(m)
    return torch.stack(accs), torch.stack(ls), torch.stack(ms)


def decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor, *, num_splits: int,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel:
    :func:`decode_partials_plain`, then :func:`combine_plain`.  Returns
    (B, Hkv, G, D) in ``out_dtype`` (default q's dtype)."""
    parts = decode_partials_plain(q, k, v, kv_len, num_splits=num_splits)
    return combine_plain(*parts, out_dtype=out_dtype or q.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("flash_decode").flash_decode
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# The fused kernels' f32 partials and int32 arrival counters, per
# (device, stream) and name: allocated at first use, grown on demand,
# never per call.  Every launch leaves the counters at zero, as it found
# them.  Launches on one stream share them and run in that stream's order;
# a launch on another stream (a side stream, a graph captured on one) gets
# buffers of its own, so concurrent launches never mix their tickets.
_WORKSPACE: Dict[Tuple[torch.device, int, str], torch.Tensor] = {}


def _workspace(device: torch.device, stream: int, name: str, numel: int,
               dtype: torch.dtype) -> torch.Tensor:
    key = (device, stream, name)
    buf = _WORKSPACE.get(key)
    if buf is None or buf.numel() < numel:
        grown = max(numel, 2 * buf.numel()) if buf is not None else numel
        buf = _WORKSPACE[key] = torch.zeros(grown, device=device,
                                            dtype=dtype)
    return buf


def fused_workspace(device: torch.device, stream: int, num_splits: int,
                    batch: int, kv_heads: int, group: int, head_dim: int):
    """Pointers to the fused decode kernels' workspace on ``device`` and
    ``stream``: the f32 partials acc (S, B, Hkv, G, D), l and m (S, B,
    Hkv, G), and the int32 arrival counters (B, Hkv), all zero between
    launches.  The bf16 and the quantized cache's kernels share it."""
    n = num_splits * batch * kv_heads * group
    acc = _workspace(device, stream, "acc", n * head_dim, torch.float32)
    lm = _workspace(device, stream, "lm", 2 * n, torch.float32)
    counters = _workspace(device, stream, "counters", batch * kv_heads,
                          torch.int32)
    return (acc.data_ptr(), lm.data_ptr(), lm.data_ptr() + 4 * n,
            counters.data_ptr())


def _launch(q, k, v, kv_len, num_splits, acc, l, m, counters=None,
            out=None) -> None:
    """Checks the operands and launches the kernel; with ``counters`` and
    ``out`` it merges the splits into ``out``, else writes the partials."""
    B, Hkv, G, D = q.shape
    L = k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_decode kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    codes = build.DTYPE_CODES
    if q.dtype not in codes or k.dtype not in codes or v.dtype != k.dtype:
        raise ValueError(f"flash_decode kernel needs q in, and k, v of one "
                         f"dtype in, {list(build.DTYPE_CODES)}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (B, L, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"does not match q {tuple(q.shape)}")
    vec = 16 // k.element_size()
    if k.stride() != v.stride() or k.stride(3) != 1 or k.stride(2) != D \
            or k.stride(0) % vec or k.stride(1) % vec:
        raise ValueError("k and v need one layout with contiguous "
                         "(Hkv, D) rows 16-byte aligned, got strides "
                         f"{k.stride()} and {v.stride()}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    build.cuda_args(q, k, v)
    lens = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                   acc, l, m, counters, None if out is None else
                   out.data_ptr(), B, Hkv, G, L, num_splits, D, k.stride(0),
                   k.stride(1), codes[q.dtype], codes[k.dtype],
                   codes[out.dtype] if out is not None else 0,
                   build.stream_ptr())
    build.check(err, "flash_decode")
    build.LAUNCHES["flash_decode"] += 1
    build.LAUNCHES[("flash_decode", L, num_splits)] += 1


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor, *, num_splits: int,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Split-KV decode attention over ``num_splits`` splits, merged.

    q: (B, Hkv, G, D), pre-scaled, f32 or bf16; k, v: (B, L, Hkv, D), f32
    or bf16 (not necessarily q's dtype), possibly a strided view of a
    longer cache (``cache[:, :bucket]`` is read in place, never copied);
    kv_len: (B,) valid lengths, clamped to L.  Returns (B, Hkv, G, D) in
    ``out_dtype`` (default q's dtype).  One launch computes the partials
    and their combine; the launch is counted under ``"flash_decode"`` and
    under ``("flash_decode", L, num_splits)``.
    """
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return decode_plain(q, k, v, kv_len, num_splits=num_splits,
                            out_dtype=out_dtype)
    if out_dtype not in build.DTYPE_CODES:
        raise ValueError(f"flash_decode kernel writes "
                         f"{list(build.DTYPE_CODES)}, got {out_dtype}")
    B, Hkv, G, D = q.shape
    S = int(num_splits)
    acc, l, m, counters = fused_workspace(q.device, build.stream_ptr(), S,
                                          B, Hkv, G, D)
    out = torch.empty((B, Hkv, G, D), device=q.device, dtype=out_dtype)
    _launch(q, k, v, kv_len, S, acc, l, m, counters, out)
    return out


def flash_decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor, *, num_splits: int):
    """Split-KV partials over ``num_splits`` splits, as
    :func:`flash_decode` takes them: the same kernel, its epilogue
    writing the partials only.  Returns acc (S, B, Hkv, G, D) and l, m
    (S, B, Hkv, G) in f32."""
    if not q.is_cuda:
        return decode_partials_plain(q, k, v, kv_len, num_splits=num_splits)
    B, Hkv, G, D = q.shape
    S = int(num_splits)
    acc = torch.empty((S, B, Hkv, G, D), device=q.device, dtype=torch.float32)
    l = torch.empty((S, B, Hkv, G), device=q.device, dtype=torch.float32)
    m = torch.empty_like(l)
    _launch(q, k, v, kv_len, S, acc.data_ptr(), l.data_ptr(), m.data_ptr())
    return acc, l, m
