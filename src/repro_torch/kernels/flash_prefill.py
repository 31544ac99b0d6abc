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
(:func:`flash_prefill_bwd`, dq, dk, dv in two launches: bf16 on the
tensor cores, float32 on the CUDA cores).  That kernel replaces no Pallas
kernel: the reference trains through ``ref.flash_attention_xla`` and lets
XLA differentiate it.  On a CPU tensor autograd differentiates
:func:`prefill_plain` itself; :func:`prefill_backward_plain` is the
backward kernel's plain version, for the tests and the card's checks.

The bf16 dk / dv launch runs one CTA per chunk of a key block's walk over
the (query head, query tile) steps that see it: :func:`dkdv_split` cuts
the walks so that the launch fills the card's CTA slots (the paper's
sequence-aware split, applied to the backward), and its table is what the
kernel runs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_decode import _workspace

HEAD_DIMS = (64, 128, 160, 256)
# (q / k width, v width) pairs with v narrower that the bf16 tensor-core
# body is compiled for: MLA's prefill (minicpm3-4b: 64 nope + 32 rope
# columns of q and k, 64 of v)
WIDTH_PAIRS = ((96, 64),)
# kernel launches of one flash_prefill_bwd call: dq (and delta), then dk, dv
BWD_LAUNCHES_PER_CALL = 2
# the bf16 backward's tile: query rows and keys a step (one wgmma M)
BWD_TILE = 64
# ints a row of the dk / dv launch's work table (csrc/flash_prefill_bwd.cu
# kWorkInts): b * Hkv + KV head, key block, first query tile, query tiles,
# i0, i1, first partial slot (-1 with one chunk), chunk index, chunks
BWD_WORK_INTS = 9


@dataclasses.dataclass(frozen=True)
class DkdvSplit:
    """The bf16 dk / dv launch's work: key block ``kb`` of (b, KV head)
    ``bh`` sees the ``n_qt`` query tiles from ``qt_lo`` in each of the G
    query heads of its group, a walk of G * n_qt steps (step i: head i //
    n_qt, tile qt_lo + i % n_qt); ``rows`` cut each walk into chunks of at
    most ``steps_per_chunk`` steps (BWD_WORK_INTS ints a row, in launch
    order), one CTA a row and column group, and ``slots`` f32 partials a
    column group hold the chunks of the key blocks cut in more than
    one."""
    steps_per_chunk: int
    rows: Tuple[Tuple[int, ...], ...]
    slots: int
    groups: int

    @property
    def ctas(self) -> int:
        return len(self.rows) * self.groups


def _key_block_tiles(kb: int, Lq: int, Lk: int, causal: bool, window: int,
                     q_offset: int) -> Tuple[int, int]:
    """(first query tile, query tiles) that see a key of block ``kb``: the
    rows [q_lo, q_hi) under the mask, in tiles of BWD_TILE."""
    k0 = kb * BWD_TILE
    k_last = min(k0 + BWD_TILE, Lk) - 1
    q_lo = max(0, k0 - q_offset) if causal else 0
    q_hi = min(Lq, k_last + window - q_offset) if window > 0 else Lq
    if q_hi <= q_lo:
        return 0, 0
    first = q_lo // BWD_TILE
    return first, -(-q_hi // BWD_TILE) - first


def bwd_column_groups(D: int, Dv: int) -> int:
    """CTAs a chunk of the bf16 dk / dv launch runs as: one per two
    64-column boxes of dK and dV (a warpgroup's registers hold two of
    each beside S^T and dP^T), 1 up to D 128, 2 at D 160 and 256."""
    return max(-(-D // 128), -(-Dv // 128))


@functools.lru_cache(maxsize=256)
def dkdv_split(B: int, Hkv: int, G: int, Lq: int, Lk: int, causal: bool,
               window: int, q_offset: int, cta_slots: int,
               groups: int = 1) -> DkdvSplit:
    """The chunks of the bf16 dk / dv launch (``window`` 0: none), each
    run by ``groups`` CTAs (``bwd_column_groups``), on a card that runs
    ``cta_slots`` of its CTAs at once (``bwd_cta_slots``: the SM count
    times the CTAs an SM holds).  Every key block's walk is cut into ceil(steps
    / T) near-equal chunks (at least one, so a block no query sees still
    writes its zeros), T the largest chunk length for which the B * Hkv
    walks give at least ``cta_slots`` CTAs, or 1 when none does: the launch
    fills the card while the longest chunk, the launch's critical path,
    stays as short as that allows; a shape with enough key blocks keeps
    one chunk a block.  Rows are in launch order, the longest chunks
    first."""
    n_kb = -(-Lk // BWD_TILE)
    tiles = [_key_block_tiles(kb, Lq, Lk, causal, window, q_offset)
             for kb in range(n_kb)]
    steps = [G * n for _, n in tiles]

    def ctas(t: int) -> int:
        return groups * B * Hkv * sum(max(1, -(-n // t)) for n in steps)

    lo, hi = 1, max(1, max(steps))      # ctas() falls as t grows
    if ctas(lo) >= cta_slots:
        while lo < hi:              # the largest t with ctas(t) >= cta_slots
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if ctas(mid) >= cta_slots else (lo, mid - 1)
    rows, slots = [], 0
    for bh in range(B * Hkv):
        for kb, ((first, n_qt), n) in enumerate(zip(tiles, steps)):
            chunks = max(1, -(-n // lo))
            slot0 = slots if chunks > 1 else -1
            slots += chunks if chunks > 1 else 0
            rows += [(bh, kb, first, n_qt, j * n // chunks,
                      (j + 1) * n // chunks, slot0, j, chunks)
                     for j in range(chunks)]
    rows.sort(key=lambda r: r[4] - r[5])    # stable: longest first
    return DkdvSplit(lo, tuple(rows), slots, groups)


@functools.lru_cache(maxsize=None)
def bwd_attrs(D: int, Dv: int, dtype: torch.dtype,
              device: torch.device = torch.device("cuda", 0)) -> Dict[str,
                                                                    int]:
    """The backward kernel's two launches at (D, Dv) in ``dtype`` on
    ``device``: the registers the runtime reports, the dynamic shared
    memory and threads each launches with, and the dk / dv launch's CTAs
    a chunk and CTAs an SM holds (the runtime's occupancy)."""
    fn = build.load("flash_prefill_bwd").flash_prefill_bwd_attrs
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        build.check(fn(D, Dv, build.DTYPE_CODES[dtype],
                       ctypes.addressof(out)), "flash_prefill_bwd_attrs")
    return dict(zip(("dq_registers", "dq_shared_bytes", "dkdv_registers",
                     "dkdv_shared_bytes", "dkdv_ctas_a_chunk", "threads",
                     "dkdv_ctas_an_sm"), out))


def bwd_cta_slots(device: torch.device, D: int, Dv: int) -> int:
    """How many CTAs of the bf16 dk / dv launch ``device`` runs at once:
    its SM count times the CTAs an SM holds at (D, Dv)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * bwd_attrs(D, Dv, torch.bfloat16, device)["dkdv_ctas_an_sm"]


# The dk / dv launch's work tables on the card, with their splits, by
# device and shape: copied once, read-only, so every stream shares them.
_WORK_TABLES: Dict[tuple, Tuple[DkdvSplit, torch.Tensor]] = {}


def bwd_work(device: torch.device, B: int, Hkv: int, G: int, Lq: int,
             Lk: int, causal: bool, window: int, q_offset: int, D: int,
             Dv: int) -> Tuple[DkdvSplit, torch.Tensor]:
    """The split the bf16 dk / dv launch runs on ``device`` for this
    shape (:func:`dkdv_split` at the device's CTA slots and the widths'
    column groups) and its rows on ``device``."""
    key = (device, B, Hkv, G, Lq, Lk, causal, window, q_offset, D, Dv)
    found = _WORK_TABLES.get(key)
    if found is None:
        split = dkdv_split(B, Hkv, G, Lq, Lk, causal, window, q_offset,
                           bwd_cta_slots(device, D, Dv),
                           bwd_column_groups(D, Dv))
        found = _WORK_TABLES[key] = (split, torch.tensor(
            split.rows, dtype=torch.int32).reshape(-1).to(device))
    return found


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
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 12 \
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
    Lq)``; in bf16 the dk / dv launch runs :func:`bwd_work`'s table, its
    f32 partials and arrival counters in a workspace per (device, stream)
    that every launch leaves at zero), :func:`prefill_backward_plain` on
    CPU ones.  ``lse`` is the
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
    stream = build.stream_ptr()
    # delta and the scaled LSE, each (B, Hq, Lq) padded to whole tiles,
    # written by the dq launch and read by the dk / dv launch
    stats = _workspace(q.device, stream, "bwd_stats",
                       2 * B * Hq * -(-Lq // BWD_TILE) * BWD_TILE,
                       torch.float32)
    work = (None, None, None)     # float32 runs without the split
    n_work = 0
    if q.dtype == torch.bfloat16:
        split, table = bwd_work(q.device, B, Hkv, Hq // Hkv, Lq, Lk,
                                bool(causal), window or 0, int(q_offset), D,
                                Dv)
        n_work = len(split.rows)
        # a thread's dK and dV fragments, two 64-column boxes at most each
        floats = 128 * 32 * (min(2, -(-D // 64)) + min(2, -(-Dv // 64)))
        cells = max(1, split.slots) * split.groups
        work = (table.data_ptr(),
                _workspace(q.device, stream, "bwd_partials", cells * floats,
                           torch.float32).data_ptr(),
                _workspace(q.device, stream, "bwd_counters", cells,
                           torch.int32).data_ptr())
    err = _bwd_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                       dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                       stats.data_ptr(), *work, B, Lq, Lk, Hq, Hkv, D, Dv,
                       int(causal), window or 0, int(q_offset), n_work,
                       build.DTYPE_CODES[q.dtype], stream)
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
