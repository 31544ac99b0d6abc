"""Split-KV flash-decode partials: the paper's target kernel.

Counterpart of ``repro.kernels.flash_decode.flash_decode_partials``.  On a
CUDA tensor :func:`flash_decode_partials` launches the hand-written
Hopper kernel ``csrc/flash_decode.cu``; on a CPU tensor it runs
:func:`decode_partials_plain`, the same function in plain PyTorch.

The cache is split into ``num_splits`` ranges of whole 128-row KV
blocks, FA3's partition: ``NB = ceil(nblk / S)`` blocks per split, split
``s`` covering blocks ``[s * NB, min((s + 1) * NB, nblk))``.  Each
(batch, kv head, split) yields an unnormalised partial ``(acc, l, m)``;
:mod:`repro_torch.kernels.flash_combine` merges them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

BLOCK_K = 128          # KV_BLOCK: the split bounds are counted in these
HEAD_DIMS = (64, 128)  # head dims the kernel is compiled for
MAX_GROUP = 16         # query heads per KV head the kernel takes


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


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("flash_decode").flash_decode_partials
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor, *, num_splits: int):
    """Split-KV partials over ``num_splits`` splits.

    q: (B, Hkv, G, D), pre-scaled, f32 or bf16; k, v: (B, L, Hkv, D), f32
    or bf16 (not necessarily q's dtype), possibly a strided view of a
    longer cache (``cache[:, :bucket]`` is read in place, never copied);
    kv_len: (B,) valid lengths, clamped to L.  Returns acc (S, B, Hkv, G,
    D) and l, m (S, B, Hkv, G) in f32.
    """
    if not q.is_cuda:
        return decode_partials_plain(q, k, v, kv_len, num_splits=num_splits)
    B, Hkv, G, D = q.shape
    L = k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_decode kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    if G > MAX_GROUP:
        raise ValueError(f"flash_decode kernel takes at most {MAX_GROUP} "
                         f"query heads per KV head, got {G}")
    codes = build.DTYPE_CODES
    if q.dtype not in codes or k.dtype not in codes or v.dtype != k.dtype:
        raise ValueError(f"flash_decode kernel needs q in, and k, v of one "
                         f"dtype in, {list(build.DTYPE_CODES)}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (B, L, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if k.stride() != v.stride() or k.stride(3) != 1 or k.stride(2) != D:
        raise ValueError("k and v need one layout with contiguous "
                         f"(Hkv, D) rows, got strides {k.stride()} and "
                         f"{v.stride()}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    build.cuda_args(q, k, v)
    S = int(num_splits)
    lens = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    acc = torch.empty((S, B, Hkv, G, D), device=q.device, dtype=torch.float32)
    l = torch.empty((S, B, Hkv, G), device=q.device, dtype=torch.float32)
    m = torch.empty_like(l)
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                   acc.data_ptr(), l.data_ptr(), m.data_ptr(), B, Hkv, G, L,
                   S, D, k.stride(0), k.stride(1),
                   build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k.dtype],
                   build.stream_ptr())
    build.check(err, "flash_decode")
    build.LAUNCHES["flash_decode"] += 1
    return acc, l, m
