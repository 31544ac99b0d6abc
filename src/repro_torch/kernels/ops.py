"""Dispatch wrappers around the attention kernels.

Counterpart of ``repro.kernels.ops`` (the ``pallas`` branches).  There is
no implementation knob: a CUDA tensor launches the hand-written kernels
and a CPU tensor runs their plain PyTorch versions, inside each kernel's
wrapper.

``decode_attention`` is the op the paper targets.  Given per-row scales
it reads a quantized (int8 / fp8) cache through the quantized cache's
decode kernel instead; ``decode_attention_quant`` takes the scales as a
:class:`~repro_torch.quant.QuantizedKV`.  Its split count comes
from a frozen :class:`~repro_torch.plan.LaunchPlan`, passed as ``plan=``
or pushed ambiently with :func:`repro_torch.plan.plan_scope`; with no
frozen plan in reach the policy runs inside the call (the paper's
internal-heuristic path), which :func:`policy_eval_count` counts and
:func:`last_inline_plan` records, with the policy and core count of
whatever context-only plan applies (``_resolve_policy``).  A frozen
plan's ``bucket`` cuts the cache to ``k[:, :bucket]`` before the split,
so the splits partition the resident-length bucket rather than the
cache's whole capacity.  Rows at or past ``kv_len`` are masked either
way, so it is the same function.

``verify_attention`` scores a speculative verify step's query block:
row ``j`` of slot ``b`` is split-KV decode over ``pos[b] + j + 1`` keys,
each row one launch of the decode kernel at the verify plan's split
count.

``decode_update_headsharded`` is the head-sharded decode of the frozen
mesh decode step: the cache's KV heads cut into one chunk a device
(:class:`HeadShards`), each device launching the decode kernel over its
own heads.

``decode_seqsharded`` is the sequence-sharded decode of a mesh-native
shard (a plan whose ``seq_shard_mesh`` is set): the cache's sequence is
cut into one chunk a device (:class:`SeqShards`), each device launches
the decode kernel's partials-only epilogue over its chunk at one split,
and one combine-kernel launch on the lead device merges the partials.
:func:`decode_update_seqsharded` first writes each slot's new row into
the chunk that holds it.

The paged cache's gather path lives here too: :class:`PagedKV` names one
tensor's page pool, page table and page count, :func:`gather_pages`
reads the pages of every slot into a dense view with one indexing op
(over every layer at once when the pool is layer-stacked), and
:func:`scatter_pages` writes a view back.  ``decode_attention`` takes a
:class:`PagedKV` wherever it takes a cache tensor and gathers it first.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.core.scheduler_metadata import get_scheduler_metadata
from repro_torch.kernels import build
from repro_torch.kernels.flash_combine import flash_combine
from repro_torch.kernels.flash_decode import flash_decode, \
    flash_decode_partials
from repro_torch.kernels.flash_decode_quant import flash_decode_quant, \
    flash_decode_quant_partials
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.plan import LaunchPlan, current_plan, plan_scope

_DEFAULT_POLICY = "paper"

# How many times the split policy ran inside a decode-attention call.
# The metadata-enabled serving path passes frozen plans and must leave
# it at zero; tests and chip_smoke.py assert exactly that.
_POLICY_EVALS: int = 0

# the plan the most recent inline evaluation resolved to
_LAST_INLINE: Optional[LaunchPlan] = None


def policy_eval_count() -> int:
    return _POLICY_EVALS


def reset_policy_eval_count() -> None:
    global _POLICY_EVALS, _LAST_INLINE
    _POLICY_EVALS = 0
    _LAST_INLINE = None


def last_inline_plan() -> Optional[LaunchPlan]:
    """The frozen plan of the most recent in-call policy evaluation (None
    if every launch since the reset consumed a precomputed plan)."""
    return _LAST_INLINE


def decode_context(ctx: LaunchPlan):
    """The reference's alias of :func:`repro_torch.plan.plan_scope`."""
    return plan_scope(ctx)


def attention_context(ctx: LaunchPlan):
    """The reference's alias of :func:`repro_torch.plan.plan_scope`."""
    return plan_scope(ctx)


def current_decode_context() -> LaunchPlan:
    """The ambient decode plan (or an empty one)."""
    plan = current_plan("decode")
    return plan if plan is not None else LaunchPlan(kind="decode")


def current_attention_context() -> LaunchPlan:
    """The ambient prefill plan (or an empty one)."""
    plan = current_plan("prefill")
    return plan if plan is not None else LaunchPlan(kind="prefill")


def _resolve_policy(scope: Optional[LaunchPlan], plan: Optional[LaunchPlan],
                    policy: str, num_cores: Optional[int]):
    """Policy and core count for an inline evaluation, as the reference
    resolves them: the call's arguments, overridden by the ambient scope,
    overridden by an explicit context-only plan.  An override's policy
    applies when it differs from the default or pins ``num_cores``."""
    pol, cores = policy, num_cores
    for over in (scope, plan):
        if over is None:
            continue
        if over.num_cores is not None:
            cores = over.num_cores
        if over.policy != _DEFAULT_POLICY or over.num_cores is not None:
            pol = over.policy
    return pol, cores


def _resolve_plan(plan: Optional[LaunchPlan], use_ctx_metadata: bool,
                  policy: str, num_cores: Optional[int],
                  shape: tuple) -> LaunchPlan:
    """The frozen plan a decode-family launch of ``shape`` (B, M, Lk, Hq,
    Hkv, D) runs: ``plan`` if frozen, else the ambient frozen decode plan
    (unless ``use_ctx_metadata=False``), else one the policy makes here,
    counted as an inline evaluation."""
    global _POLICY_EVALS, _LAST_INLINE
    scope = current_plan("decode")
    if (plan is None or not plan.frozen) and use_ctx_metadata \
            and scope is not None and scope.frozen:
        plan = scope
    if plan is not None and plan.frozen:
        return plan
    _POLICY_EVALS += 1
    pol, cores = _resolve_policy(scope, plan, policy, num_cores)
    kwargs = {} if cores is None else {"num_cores": cores}
    _LAST_INLINE = get_scheduler_metadata(*shape, policy=pol, **kwargs)
    return _LAST_INLINE


def launch_counts() -> Dict[str, int]:
    """Kernel launches by kernel name, since the last reset."""
    return {name: build.LAUNCHES[name] for name in build.KERNELS}


def launch_counts_by_key(name: str) -> Dict[tuple, int]:
    """Launches of kernel ``name`` by the key its wrapper also counts them
    under (the prefill kernel's: dtype name, Lq; the decode kernel's: view
    length, splits), since the last reset."""
    return {key[1:]: n for key, n in build.LAUNCHES.items()
            if isinstance(key, tuple) and key[0] == name}


def reset_launch_counts() -> None:
    build.LAUNCHES.clear()


class PagedKV(NamedTuple):
    """A paged view of one cache tensor, in place of a dense ``(B, L,
    *rest)`` one.  ``pages`` is the shared pool ``(P, page, *rest)``,
    ``page_table`` maps each slot to its pages ``(B, >= num_pages)``
    int32, and ``num_pages`` is how many pages the launch attends over
    (the resident-length bucket over the page size).  Table entries past
    a slot's allocation point at the trash page, whose rows sit at
    positions >= the slot's ``kv_len`` and are masked."""
    pages: torch.Tensor
    page_table: torch.Tensor
    num_pages: int

    @property
    def view_len(self) -> int:
        return self.num_pages * self.pages.shape[1]


def bit_view(x: torch.Tensor) -> torch.Tensor:
    """One-byte float storage (fp8) as uint8: indexed copies of fp8 are
    not implemented on every device, and a bit copy is all they do."""
    return x.view(torch.uint8) if x.dtype.is_floating_point \
        and x.element_size() == 1 else x


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor, *,
                 num_pages: int, axis: int = 0) -> torch.Tensor:
    """A dense per-slot view of a page pool, in one ``index_select``.

    ``pages``: ``(..., P, page, *rest)`` with the pool dim at ``axis``;
    ``page_table``: ``(B, >= num_pages)`` int32.  Returns ``(..., B,
    num_pages * page, *rest)``: the first ``num_pages`` pages of every
    slot, in sequence order, as a new tensor."""
    pt = page_table[:, :num_pages]
    g = torch.index_select(bit_view(pages), axis, pt.reshape(-1))
    shape = (pages.shape[:axis] + (pt.shape[0],
                                   num_pages * pages.shape[axis + 1])
             + pages.shape[axis + 2:])
    return g.view(shape).view(pages.dtype)


def scatter_pages(pages: torch.Tensor, view: torch.Tensor,
                  page_table: torch.Tensor, *, num_pages: int,
                  axis: int = 0) -> torch.Tensor:
    """Write a dense per-slot view back into the pool, in place (the
    inverse of :func:`gather_pages`); returns ``pages``.

    Table entries that repeat (every slot's unallocated tail points at
    the shared trash page) leave that one page's content
    nondeterministic: its rows are masked by ``kv_len`` everywhere."""
    pt = page_table[:, :num_pages].reshape(-1).long()
    page = pages.shape[axis + 1]
    vp = view.reshape(view.shape[:axis] + (pt.numel(), page)
                      + view.shape[axis + 2:])
    bit_view(pages).index_copy_(axis, pt, bit_view(vp.to(pages.dtype)))
    return pages


def _resolve_paged(x):
    """A dense tensor -> itself; a :class:`PagedKV` -> its gathered view."""
    if isinstance(x, PagedKV):
        return gather_pages(x.pages, x.page_table, num_pages=x.num_pages)
    return x


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0) -> torch.Tensor:
    """Full (prefill) attention: q (B, Lq, Hq, D), k (B, Lk, Hkv, D), v
    (B, Lk, Hkv, Dv) -> (B, Lq, Hq, Dv).  Dv may be narrower than D
    (MLA's prefill: D 96, Dv 64).

    q is scaled by ``D ** -0.5`` (q's width, also where v is narrower, as
    the reference's ``flash_attention_xla`` does) in f32 and rounded to
    its dtype before the kernel, as the reference's Pallas path does.

    An ambient prefill-kind plan (:func:`~repro_torch.plan.plan_scope`)
    whose ``seq_shard_mesh`` is set runs :func:`_attention_seqpar` under
    the reference's conditions: an int ``q_offset``, and Lq divisible by
    the grid's ``model`` axis ``n`` with Lq >= 2 n."""
    scope = current_plan("prefill")
    if (scope is not None and scope.seq_shard_mesh is not None
            and isinstance(q_offset, int)):
        mesh = scope.seq_shard_mesh
        n = mesh.shape["model"]
        if q.shape[1] % n == 0 and q.shape[1] >= 2 * n:
            return _attention_seqpar(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, mesh=mesh)
    qs = (q.float() * q.shape[-1] ** -0.5).to(q.dtype)
    return flash_prefill(qs, k, v, causal=causal, window=window,
                         q_offset=q_offset)


def _attention_seqpar(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: Optional[int], q_offset: int,
                      mesh) -> torch.Tensor:
    """Sequence-parallel prefill attention over ``mesh``'s ``model``
    axis (n devices): the reference's ``_attention_seqpar``, its
    ``shard_map`` made explicit.  Device ``i`` of a grid row runs the
    prefill kernel over its chunk of C = Lq / n query rows against the
    whole K / V, at ``q_offset + i C``, and the chunks join on q's
    device.  The batch rides the rows where their count divides B
    (row ``r`` its B / rows), else the first row takes it all, as
    replicated.  Where the reference runs XLA's flash here, the port
    runs its kernel, as this op does everywhere.  It is differentiable:
    under autograd each chunk runs the kernel with its LSE and its
    backward (``flash_prefill``'s autograd form) and K / V's gradients
    add over the chunks, which is how mesh training runs attention
    where the model axis does not divide the query heads."""
    B, Lq = q.shape[:2]
    n = mesh.shape["model"]
    C = Lq // n
    qs = (q.float() * q.shape[-1] ** -0.5).to(q.dtype)
    rows = mesh.rows if B % len(mesh.rows) == 0 else mesh.rows[:1]
    b = B // len(rows)
    out = []
    for r, devices in enumerate(rows):
        kr, vr = k[r * b:(r + 1) * b], v[r * b:(r + 1) * b]
        parts = []
        for i, dev in enumerate(devices):
            qc = qs[r * b:(r + 1) * b, i * C:(i + 1) * C].contiguous()
            o = flash_prefill(qc.to(dev), kr.to(dev), vr.to(dev),
                              causal=causal, window=window,
                              q_offset=q_offset + i * C)
            parts.append(o.to(q.device))
        out.append(torch.cat(parts, dim=1))
    return torch.cat(out, dim=0)


def _splits(plan: LaunchPlan, length: int) -> int:
    """The split count a launch over ``length`` rows runs: the plan's,
    clamped to [1, length], rounded up to a multiple of the plan's (or
    the ambient decode plan's) ``min_splits``, as the reference rounds
    a mesh-level split so the split axis cuts evenly over the devices,
    and clamped again."""
    s = max(1, min(plan.num_splits, length))
    scope = current_plan("decode")
    m = max(plan.min_splits, scope.min_splits if scope is not None else 1)
    if m > 1:
        s = min(-(-s // m) * m, length)
    return s


def decode_attention(
    q: torch.Tensor,         # (B, Hq, D): one new token per sequence
    k,                       # (B, Lk, Hkv, D) KV cache (may be a view),
    v,                       # or a PagedKV
    kv_len: torch.Tensor,    # (B,) valid lengths
    *,
    k_scale=None,            # (B, Lk, Hkv) f32, or a PagedKV
    v_scale=None,
    plan: Optional[LaunchPlan] = None,
    use_ctx_metadata: bool = True,
    policy: str = _DEFAULT_POLICY,
    num_cores: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Split-KV decode attention; the split count comes from ``plan``.

    Returns (B, Hq, Dv) in q's dtype, Dv being v's width.  q is scaled
    by ``scale`` (None: ``D ** -0.5``, D being q's and k's width) in f32
    and rounded to its dtype before the kernel.  v may be narrower than
    k: MLA's latent decode passes ``v = k[..., :kv_lora_rank]``, a
    column view of the same cache, with a pre-scaled q and ``scale=1.0``
    (the reference's ``decode_attention_update(..., v_width=,
    scale=)``).  The decode kernel runs exactly the
    plan's ``num_splits`` splits over ``k[:, :plan.bucket]`` and merges
    them in a fixed order, in one launch.  With ``k_scale`` / ``v_scale``
    the cache is quantized: the quantized cache's decode kernel reads it,
    scales cut to the same bucket, again in one launch.  With no frozen
    plan, the ambient frozen decode plan
    (:func:`~repro_torch.plan.plan_scope`) serves unless
    ``use_ctx_metadata=False``; failing that the policy decides here,
    over the whole cache length: ``policy`` / ``num_cores`` (``paper`` at
    132 SMs), overridden by the scope's context-only plan, overridden by
    ``plan``'s.  Any of ``k``, ``v``, ``k_scale`` and ``v_scale`` may be a
    :class:`PagedKV`, gathered first.
    """
    k, v, k_scale, v_scale = (_resolve_paged(x)
                              for x in (k, v, k_scale, v_scale))
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    plan = _resolve_plan(plan, use_ctx_metadata, policy, num_cores,
                         (B, 1, k.shape[1], Hq, Hkv, D))
    if plan.bucket is not None:
        k = k[:, :plan.bucket]
        v = v[:, :plan.bucket]
        if k_scale is not None:
            k_scale = k_scale[:, :plan.bucket]
            v_scale = v_scale[:, :plan.bucket]
    s = _splits(plan, k.shape[1])
    sc = D ** -0.5 if scale is None else scale
    qp = (q.float() * sc).to(q.dtype).reshape(B, Hkv, Hq // Hkv, D)
    if k_scale is None:
        out = flash_decode(qp, k, v, kv_len, num_splits=s, out_dtype=q.dtype)
    else:
        out = flash_decode_quant(qp, k, v, k_scale, v_scale, kv_len,
                                 num_splits=s, out_dtype=q.dtype)
    return out.reshape(B, Hq, v.shape[-1])


def decode_attention_quant(q: torch.Tensor, qkv, kv_len: torch.Tensor,
                           **kw) -> torch.Tensor:
    """Split-KV decode over a quantized cache: ``qkv`` is a
    :class:`~repro_torch.quant.QuantizedKV` (or any ``(k, v, k_scale,
    v_scale)``), planned exactly as :func:`decode_attention`."""
    k, v, k_scale, v_scale = qkv
    return decode_attention(q, k, v, kv_len, k_scale=k_scale,
                            v_scale=v_scale, **kw)


def verify_attention(
    q: torch.Tensor,         # (B, M, Hq, D): the k + 1-row query block
    k,                       # (B, Lk, Hkv, D) KV cache (may be a view),
    v,                       # or a PagedKV
    pos: torch.Tensor,       # (B,) absolute position of q[:, 0]
    *,
    plan: Optional[LaunchPlan] = None,
    use_ctx_metadata: bool = True,
    policy: str = _DEFAULT_POLICY,
    num_cores: Optional[int] = None,
) -> torch.Tensor:
    """Speculative-verify attention: the ``M = k + 1`` query rows of each
    slot (its committed current token and k drafts), causal within the
    block at the slot's own offset and over the whole prefix outside it.

    Row ``j`` of slot ``b`` sits at position ``pos[b] + j`` and is
    split-KV decode over ``kv_len = clamp(pos[b] + j + 1, 1, L)``, where
    ``L`` is the attended view (``k[:, :plan.bucket]`` under a frozen
    plan), so a padding row or a dead slot's stale position past the view
    reads the whole view and is ignored by the caller.  Each row is one
    launch of the decode kernel, ``M`` launches in all, with the plan's
    ``num_splits``, counted under ``("flash_decode", L, S)``.  The frozen
    ``("verify", k, bucket)`` plan, or the ambient one, is consumed as
    :func:`decode_attention` consumes its plan: without one the policy
    decides here on the M-row workload, and that counts as a policy
    evaluation.  The reference
    sends verify to XLA because its Pallas kernel needs static offsets;
    the decode kernel takes per-row lengths at run time.  Returns (B, M,
    Hq, D) in q's dtype.
    """
    k, v = _resolve_paged(k), _resolve_paged(v)
    B, M, Hq, D = q.shape
    Hkv = k.shape[2]
    plan = _resolve_plan(plan, use_ctx_metadata, policy, num_cores,
                         (B, M, k.shape[1], Hq, Hkv, D))
    if plan.bucket is not None:
        k = k[:, :plan.bucket]
        v = v[:, :plan.bucket]
    L = k.shape[1]
    s = max(1, min(plan.num_splits, L))
    # row-major copies of every row's pre-scaled queries (M, B, Hkv, G, D)
    # and kv_len (M, B), so each launch reads a contiguous slice
    qp = (q.float() * D ** -0.5).to(q.dtype).reshape(
        B, M, Hkv, Hq // Hkv, D).transpose(0, 1).contiguous()
    lens = (pos.to(device=q.device, dtype=torch.int32)[None]
            + torch.arange(1, M + 1, device=q.device, dtype=torch.int32)[
                :, None]).clamp(1, L)
    rows = [flash_decode(qp[j], k, v, lens[j], num_splits=s,
                         out_dtype=q.dtype) for j in range(M)]
    return torch.stack(rows, dim=1).reshape(B, M, Hq, D)


# ---------------------------------------------------------------------------
# Sequence-sharded decode (mesh-native serving)
# ---------------------------------------------------------------------------


class Shards:
    """A cache tensor held as ``n`` equal chunks of its dim ``dim``,
    chunk ``i`` on its own device (the devices may repeat).  Indexing an
    integer takes one layer of a layer-stacked tensor, chunk by chunk, as
    indexing a tensor's first dim does, so ``caches[name][layer]`` works
    on either.  Which dim is cut is the subclass's: :class:`SeqShards`
    cuts the sequence, :class:`HeadShards` the KV heads."""

    def __init__(self, chunks: Sequence[torch.Tensor], dim: int):
        self.chunks = tuple(chunks)
        self.dim = dim

    @classmethod
    def split(cls, x: torch.Tensor, devices: Sequence[torch.device],
              dim: int):
        """Cut ``x`` into ``len(devices)`` chunks along ``dim``, chunk i
        moved to ``devices[i]``: a view where the device is x's own (a
        paged view cut per launch), else a copy."""
        n = len(devices)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"divide over {n} shards")
        c = x.shape[dim] // n
        return cls([x.narrow(dim, i * c, c).to(d)
                    for i, d in enumerate(devices)], dim)

    @classmethod
    def place(cls, x: torch.Tensor, devices: Sequence[torch.device],
              dim: int):
        """Like :meth:`split`, each chunk a contiguous tensor of its own
        (dense storage, physically chunked)."""
        return cls([ch.clone(memory_format=torch.contiguous_format)
                    for ch in cls.split(x, devices, dim).chunks], dim)

    @property
    def chunk_len(self) -> int:
        return self.chunks[0].shape[self.dim]

    @property
    def dtype(self) -> torch.dtype:
        return self.chunks[0].dtype

    def __getitem__(self, i: int):
        return type(self)([c[i] for c in self.chunks], self.dim - 1)

    def join(self, device: torch.device) -> torch.Tensor:
        """The whole tensor on ``device``."""
        return torch.cat([c.to(device) for c in self.chunks], self.dim)

    def copy_(self, x: torch.Tensor) -> None:
        """Overwrite every chunk with its part of the whole tensor ``x``."""
        c = self.chunk_len
        for i, ch in enumerate(self.chunks):
            bit_view(ch).copy_(bit_view(x.narrow(self.dim, i * c, c)))


class SeqShards(Shards):
    """A cache tensor held as ``n`` equal chunks of its sequence dim
    ``dim``: chunk ``i`` holds rows ``[i * C, (i + 1) * C)`` on its own
    device."""

    def cols(self, width: int) -> "SeqShards":
        """Each chunk's first ``width`` columns of its last dim (MLA's V,
        a column view of its latent K)."""
        return SeqShards([c[..., :width] for c in self.chunks], self.dim)

    def write_slot(self, slot: int, lo: int, rows: torch.Tensor) -> None:
        """Layer-stacked storage (layers, B, L, ...): write ``rows``
        (layers, n, ...) into slot ``slot``'s rows [lo, lo + n), each part
        into the chunk that holds it."""
        c, hi = self.chunk_len, lo + rows.shape[1]
        for i, ch in enumerate(self.chunks):
            a, b = max(lo, i * c), min(hi, (i + 1) * c)
            if a < b:
                ch[:, slot, a - i * c:b - i * c] = \
                    rows[:, a - lo:b - lo].to(ch.device)

    def zero_slot(self, slot: int) -> None:
        """Layer-stacked storage: zero slot ``slot`` in every chunk."""
        for ch in self.chunks:
            ch[:, slot].zero_()


class HeadShards(Shards):
    """A cache tensor held as ``n`` equal chunks of its KV-head dim
    ``dim``, chunk ``i`` on its own device: the head-sharded layout of the
    frozen mesh decode step (``cache_rules(False)``), where each device
    attends its own KV heads."""


CacheLeaf = Union[torch.Tensor, Shards]


def _write_row(leaf: SeqShards, t: torch.Tensor, new: torch.Tensor) -> None:
    """Write ``new[b]`` at row ``t[b]`` of one layer's (B, L, ...) leaf
    for every slot b, in the one chunk that holds the row.  A chunk
    rewrites its clamped row with its own value where the row is not
    its own (the reference's ``where``), so no launch waits on the
    host."""
    c = leaf.chunk_len
    for i, ch in enumerate(leaf.chunks):
        dev = ch.device
        local = t.to(dev) - i * c
        own = (local >= 0) & (local < c)
        lt = local.clamp(0, c - 1)
        rows = torch.arange(ch.shape[0], device=dev)
        raw = bit_view(ch)
        old = raw[rows, lt]
        val = bit_view(new.to(ch.dtype)).to(dev)
        mask = own.view((-1,) + (1,) * (old.dim() - 1))
        raw[rows, lt] = torch.where(mask, val, old)


def decode_seqsharded(q: torch.Tensor, k: SeqShards, v: SeqShards,
                      kv_len: torch.Tensor, *,
                      k_scale: Optional[SeqShards] = None,
                      v_scale: Optional[SeqShards] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over a sequence-sharded cache: the counterpart of
    the reference's ``_decode_seqsharded`` body.

    q (B, Hq, D); k, v (and the quantized cache's ``k_scale`` /
    ``v_scale``) one layer's :class:`SeqShards` of (B, L, Hkv, ...)
    cut into ``n`` chunks of ``C = L / n`` rows.  Shard ``i`` launches the
    decode kernel's partials-only epilogue (the quantized cache's kernel
    with scales) over its chunk at one split, with ``kv_len_i =
    clamp(kv_len - i C, 0, C)``: a slot whose prompt ends before the
    chunk gives the empty partial (acc 0, l 0, m NEG_INF).  The
    partials go to q's device, and one combine-kernel launch merges the
    ``n`` of them in shard order, the reference's ``pmax`` / ``psum``.
    q is scaled by ``scale`` (None: ``D ** -0.5``) in f32 and rounded to
    its dtype, as :func:`decode_attention` does, so where the chunks
    meet the fused kernel's split bounds the result is that launch's at
    S = n.  Returns (B, Hq, Dv) in q's dtype."""
    B, Hq, D = q.shape
    c = k.chunk_len
    Hkv = k.chunks[0].shape[2]
    sc = D ** -0.5 if scale is None else scale
    qp = (q.float() * sc).to(q.dtype).reshape(B, Hkv, Hq // Hkv, D)
    lens = kv_len.to(device=q.device, dtype=torch.int64)
    parts: List[tuple] = []
    for i, kc in enumerate(k.chunks):
        dev = kc.device
        qi = qp.to(dev)
        li = (lens - i * c).clamp(0, c).to(dev)
        if k_scale is None:
            part = flash_decode_partials(qi, kc, v.chunks[i], li,
                                         num_splits=1)
        else:
            part = flash_decode_quant_partials(
                qi, kc, v.chunks[i], k_scale.chunks[i], v_scale.chunks[i],
                li, num_splits=1)
        parts.append(tuple(x.to(q.device) for x in part))
    acc, l, m = (torch.cat(x) for x in zip(*parts))
    out = flash_combine(acc, l, m, out_dtype=q.dtype)
    return out.reshape(B, Hq, out.shape[-1])


def decode_update_seqsharded(q: torch.Tensor, cache: Dict[str, CacheLeaf],
                             new: Dict[str, torch.Tensor], t: torch.Tensor,
                             kv_len: torch.Tensor, *, devices: Sequence,
                             v_width: Optional[int] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Write each slot's new row, then :func:`decode_seqsharded`.

    ``cache`` is one layer's cache: ``k`` / ``v`` (``k_s`` / ``v_s`` for a
    quantized cache) or MLA's ``latent``, each a :class:`SeqShards` (dense
    storage, chunked on ``devices``) or a tensor (B, V, ...) on q's device
    (the paged layout's gathered view, cut into ``len(devices)`` chunks
    here, after the write, as the reference re-partitions it a launch).
    ``new`` holds the rows (B, ...) under the same names.  MLA's V is the
    first ``v_width`` columns of its latent K."""
    rows = torch.arange(q.shape[0], device=q.device)
    shards: Dict[str, SeqShards] = {}
    for name, leaf in cache.items():
        if isinstance(leaf, SeqShards):
            _write_row(leaf, t, new[name])
            shards[name] = leaf
        elif isinstance(leaf, Shards):
            raise TypeError(f"{name}: a {type(leaf).__name__} cache is not "
                            "cut on its sequence")
        else:
            bit_view(leaf)[rows, t] = bit_view(new[name].to(leaf.dtype))
            shards[name] = SeqShards.split(leaf, devices, 1)
    if "latent" in shards:
        k = shards["latent"]
        return decode_seqsharded(q, k, k.cols(v_width), kv_len,
                                 scale=scale)
    return decode_seqsharded(q, shards["k"], shards["v"], kv_len,
                             k_scale=shards.get("k_s"),
                             v_scale=shards.get("v_s"), scale=scale)


def decode_update_headsharded(q: torch.Tensor,
                              cache: Dict[str, HeadShards],
                              new: Dict[str, torch.Tensor], t: torch.Tensor,
                              kv_len: torch.Tensor, *,
                              plan: Optional[LaunchPlan] = None
                              ) -> torch.Tensor:
    """Decode attention over a head-sharded cache: each device writes its
    KV heads' part of every slot's new row, then launches
    :func:`decode_attention` (the quantized cache's kernel where ``k_s``
    / ``v_s`` are present) over its heads, with its query heads (the G
    of each of its KV heads), at the plan's split.  The outputs join on
    q's device in head order.

    q (B, Hq, D); ``cache`` one layer's ``k`` / ``v`` (``k_s`` / ``v_s``)
    :class:`HeadShards` of (B, L, Hkv, ...) cut on dim 2; ``new`` the
    rows (B, Hkv, ...) under the same names.  Returns (B, Hq, Dv)."""
    B, Hq, D = q.shape
    k = cache["k"]
    hl = k.chunks[0].shape[2]
    gl = Hq // len(k.chunks)
    outs = []
    for i, kc in enumerate(k.chunks):
        dev = kc.device
        rows = torch.arange(B, device=dev)
        ti = t.to(dev)
        local = {}
        for name, leaf in cache.items():
            ch = leaf.chunks[i]
            part = new[name][:, i * hl:(i + 1) * hl]
            bit_view(ch)[rows, ti] = bit_view(part.to(ch.dtype)).to(dev)
            local[name] = ch
        out = decode_attention(
            q[:, i * gl:(i + 1) * gl].to(dev), local["k"], local["v"],
            kv_len.to(dev), k_scale=local.get("k_s"),
            v_scale=local.get("v_s"), plan=plan)
        outs.append(out.to(q.device))
    return torch.cat(outs, dim=1)


def seq_sharded(storage: Dict[str, CacheLeaf]) -> bool:
    """Whether a cache dict holds :class:`SeqShards` leaves."""
    return any(isinstance(x, SeqShards) for x in storage.values())
