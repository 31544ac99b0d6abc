"""CacheLayout: how an engine's KV-cache tensors are arranged on the card.

Counterpart of ``repro.cache.layout``.  A layout maps between the
model-facing cache VIEW, the dict of dense ``(layers, B, L, ...)``
tensors every ``decode_step`` and prefill consumes, and the device
STORAGE the layout allocates.  The reference's entry points are pure
functions returning new storage; here the storage is the engine's static
tensors and every write lands in place:

- ``init_storage()`` allocates the storage dict;
- ``gather_view(storage, table, n)`` is the full-batch dense view of the
  first ``n`` pages of every slot (the dense storage is its own view),
  and ``scatter_view`` writes a whole view back;
- ``decode_positions`` bounds each slot's write row to that view;
- ``write_token`` writes back the page holding each slot's decoded row,
  and ``write_rows`` the pages holding a verify step's accepted rows
  (dense: the step already wrote them);
- ``write_slot`` lands a prefilled batch-1 view in a slot; the paged
  ``slot_view`` gathers one for suffix prefill;
- ``copy_page`` backs copy-on-write; ``zero_slot`` resets a slot for
  loop admission.

The engine drives both layouts through these calls alone.

A cache tensor pages unless the model names it in
``Model.unpaged_caches()`` (the reference's ``paged=False`` leaves):
encdec's cross K / V, read whole every step.  The paged layout keeps
those dense, ``(layers, B, rows, ...)``, passes them through its gathers
and page writes untouched, and zeroes their slot column at
:meth:`~PagedKVCache.zero_slot`.

:class:`DenseLayout` keeps ``Model.init_cache``'s tensors.
:class:`PagedKVCache` stores every cache tensor ``(layers, B, max_len,
*rest)`` as a pool ``(layers, pool_pages, page_size, *rest)``; one page
table ``(B, slot_pages)`` serves every tensor that pages and every
layer, so a decode step's gather is one ``index_select`` per tensor over
the whole layer stack (:func:`repro_torch.kernels.ops.gather_pages`).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.cache.spec import TRASH_PAGE, CacheSpec
from repro_torch.kernels import ops

Storage = Dict[str, torch.Tensor]


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * dtype.itemsize


class CacheLayout:
    """Base: resolved from a :class:`CacheSpec` by the CacheManager."""

    kind: str = "abstract"

    def __init__(self, model, spec: CacheSpec):
        self.model = model
        self.spec = spec
        # name -> ((layers, B, max_len, *rest), dtype)
        self.shapes = model.cache_shapes(spec.batch, spec.max_len,
                                         spec.kv_dtype)
        # the tensors that page: the position-linear ones
        self.paged = tuple(name for name in self.shapes
                           if name not in model.unpaged_caches())

    # --- sizing (observability) ---------------------------------------------

    def dense_bytes(self) -> int:
        """Bytes of the dense-equivalent storage (the baseline)."""
        return sum(_nbytes(s, dt) for s, dt in self.shapes.values())

    def storage_bytes(self) -> int:
        raise NotImplementedError

    def row_bytes(self) -> int:
        """Bytes per resident row per slot (all layers) of the tensors
        that page."""
        return sum(_nbytes(s, dt) // (s[1] * s[2])
                   for name, (s, dt) in self.shapes.items()
                   if name in self.paged)

    def attended_bytes(self, view_len: int) -> int:
        """K/V bytes one decode launch reads for a ``view_len``-row view.
        Both layouts attend the resident bucket here (the reference's
        dense decode reads the padded capacity)."""
        return self.row_bytes() * int(view_len) * self.spec.batch


class DenseLayout(CacheLayout):
    """``Model.init_cache``'s tensors: the storage is the view.  A
    sequence-sharded engine holds each tensor as
    :class:`~repro_torch.kernels.ops.SeqShards`, one chunk of rows a
    device, which the slot writes and resets here land chunk by chunk."""

    kind = "dense"

    def init_storage(self) -> Storage:
        return self.model.init_cache(self.spec.batch, self.spec.max_len,
                                     self.spec.kv_dtype)

    def gather_view(self, storage: Storage, table: torch.Tensor,
                    num_pages: int) -> Storage:
        """The storage itself: decode attends its first ``plan.bucket``
        rows (``ops.decode_attention``) and writes its row in place."""
        return storage

    def scatter_view(self, storage: Storage, view: Storage,
                     table: torch.Tensor, num_pages: int) -> None:
        """Nothing to write back: the view is the storage."""

    def decode_positions(self, positions: torch.Tensor,
                         num_pages: int) -> torch.Tensor:
        return positions

    def write_token(self, storage: Storage, view: Storage,
                    table: torch.Tensor, positions: torch.Tensor,
                    num_pages: int) -> None:
        """Nothing to write back: the view is the storage."""

    def write_rows(self, storage: Storage, view: Storage,
                   table: torch.Tensor, start: torch.Tensor,
                   count: torch.Tensor, max_rows: int,
                   num_pages: int) -> None:
        """Nothing to write back: the view is the storage, and rejected
        rows lie above the slot's rolled-back ``kv_len``."""

    def write_slot(self, storage: Storage, view: Storage,
                   table: torch.Tensor, slot: int, num_pages: int, *,
                   first_page: int = 0) -> None:
        """Copy rows [first_page * page, Lb) of a batch-1 view ``(layers,
        1, Lb, ...)`` into the same rows of slot ``slot``, one copy per
        tensor of the view over every layer (an encdec view holds the
        self cache alone: the cross cache stays as it is)."""
        lo = first_page * self.spec.page_size
        for name, rows in view.items():
            leaf = storage[name]
            if isinstance(leaf, ops.SeqShards):
                leaf.write_slot(slot, lo, rows[:, 0, lo:])
            else:
                leaf[:, slot, lo:rows.shape[2]] = rows[:, 0, lo:]

    def zero_slot(self, storage: Storage, slot: int) -> None:
        """Zero slot ``slot``'s rows of every tensor (data and scales)."""
        for t in storage.values():
            if isinstance(t, ops.SeqShards):
                t.zero_slot(slot)
            else:
                t[:, slot].zero_()

    def storage_bytes(self) -> int:
        return self.dense_bytes()


class PagedKVCache(CacheLayout):
    """Fixed-size pages in one pool per tensor, per-slot page tables.

    Page 0 is the trash page (:data:`repro_torch.cache.spec.TRASH_PAGE`):
    table entries past a slot's allocation, and every entry of a free
    slot, point at it, so a dead slot's lockstep writes land there and a
    gather of an unallocated tail reads rows that ``kv_len`` masks."""

    kind = "paged"

    def _paged_shape(self, shape):
        return ((shape[0], self.spec.pool_pages, self.spec.page_size)
                + tuple(shape[3:]))

    def _shape(self, name: str):
        s = self.shapes[name][0]
        return self._paged_shape(s) if name in self.paged else s

    def init_storage(self) -> Storage:
        dev = self.model.device
        return {name: torch.zeros(self._shape(name), dtype=dt, device=dev)
                for name, (_, dt) in self.shapes.items()}

    # --- full-batch decode view ---------------------------------------------

    def gather_view(self, storage: Storage, table: torch.Tensor,
                    num_pages: int) -> Storage:
        """Every slot's first ``num_pages`` pages, as new dense tensors
        ``(layers, B, num_pages * page_size, *rest)``; a tensor that does
        not page is its own view."""
        return {name: (ops.gather_pages(leaf, table, num_pages=num_pages,
                                        axis=1)
                       if name in self.paged else leaf)
                for name, leaf in storage.items()}

    def scatter_view(self, storage: Storage, view: Storage,
                     table: torch.Tensor, num_pages: int) -> None:
        """Write a whole full-batch view back into every slot's first
        ``num_pages`` pages (the inverse of :meth:`gather_view`).  The
        engine writes back only what a launch produced
        (:meth:`write_token`, :meth:`write_slot`); this is the general
        form."""
        for name in self.paged:
            ops.scatter_pages(storage[name], view[name], table,
                              num_pages=num_pages, axis=1)

    def decode_positions(self, positions: torch.Tensor,
                         num_pages: int) -> torch.Tensor:
        """Clamp each slot's write row into the ``num_pages``-page view.
        Only a dead slot's stale position can lie past it; its table row
        is the trash page and its output is ignored."""
        return positions.clamp(max=num_pages * self.spec.page_size - 1)

    def write_token(self, storage: Storage, view: Storage,
                    table: torch.Tensor, positions: torch.Tensor,
                    num_pages: int) -> None:
        """Write back only the page holding each slot's row
        ``positions[b]`` (a decode step changes one row a slot, so
        scattering the whole view would rewrite ``view_len`` rows for
        nothing).  Dead slots' table rows point at the trash page, so
        their stale writes land there."""
        ps = self.spec.page_size
        pidx = positions.long() // ps                            # (B,)
        dst = table.gather(1, pidx[:, None])[:, 0].long()
        rows = torch.arange(pidx.shape[0], device=pidx.device)
        for name in self.paged:
            v = view[name]
            vp = v.view(v.shape[:2] + (num_pages, ps) + v.shape[3:])
            sel = ops.bit_view(vp)[:, rows, pidx]   # (layers, B, ps, ...)
            ops.bit_view(storage[name]).index_copy_(1, dst, sel)

    def write_rows(self, storage: Storage, view: Storage,
                   table: torch.Tensor, start: torch.Tensor,
                   count: torch.Tensor, max_rows: int,
                   num_pages: int) -> None:
        """Write back only the pages overlapping each slot's rows
        [start[b], start[b] + count[b]): a verify step's accepted rows.

        ``max_rows`` bounds a slot's row count, so its rows straddle at
        most ``ceil(max_rows / page_size) + 1`` pages.  Pages of that span
        that lie wholly past the accepted rows, or past the view, go to
        the trash page instead: that is how rejected draft rows never
        reach storage (the host then rolls ``kv_len`` back).  Rows below
        ``start`` on the first page go back with their gathered values,
        unchanged."""
        ps = self.spec.page_size
        span = -(-int(max_rows) // ps) + 1
        start = start.to(device=table.device, dtype=torch.int64)
        first = start // ps                                      # (B,)
        pidx = first[:, None] + torch.arange(span, device=table.device)
        end = start + count.to(device=table.device, dtype=torch.int64)
        commit = (pidx * ps < end[:, None]) & (pidx < num_pages)
        pidx = pidx.clamp(max=num_pages - 1)
        dst = torch.where(commit, table.gather(1, pidx).long(), TRASH_PAGE)
        rows = torch.arange(pidx.shape[0], device=table.device)[:, None]
        for name in self.paged:
            v = view[name]
            vp = v.view(v.shape[:2] + (num_pages, ps) + v.shape[3:])
            sel = ops.bit_view(vp)[:, rows, pidx]   # (layers, B, span, ps..)
            ops.bit_view(storage[name]).index_copy_(
                1, dst.reshape(-1), sel.flatten(1, 2))

    # --- batch-1 slot view (fused and suffix prefill) -----------------------

    def slot_view(self, storage: Storage, table: torch.Tensor, slot: int,
                  num_pages: int) -> Storage:
        """Slot ``slot``'s batch-1 view: its first ``num_pages`` pages of
        every tensor that pages, its column of every other."""
        row = table[slot:slot + 1]
        return {name: (ops.gather_pages(leaf, row, num_pages=num_pages,
                                        axis=1)
                       if name in self.paged else leaf[:, slot:slot + 1])
                for name, leaf in storage.items()}

    def write_slot(self, storage: Storage, view: Storage,
                   table: torch.Tensor, slot: int, num_pages: int, *,
                   first_page: int = 0) -> None:
        """Scatter pages [first_page, num_pages) of a batch-1 view
        ``(layers, 1, rows, ...)`` into slot ``slot``'s pages.  A view
        that ends inside its last page (a prompt bucket cut at a
        ``max_len`` the page size does not divide) is zero-padded to it.
        Suffix prefill passes the page holding its first row, so the
        adopted prefix pages, which other owners read, are not written.
        Only the tensors that page are written (an encdec view holds the
        self cache alone)."""
        ps = self.spec.page_size
        row = table[slot:slot + 1, first_page:num_pages]
        lo, hi = first_page * ps, num_pages * ps
        for name in self.paged:
            leaf = storage[name]
            part = view[name][:, :, lo:hi]
            short = hi - lo - part.shape[2]
            if short:
                pad = part.new_zeros(part.shape[:2] + (short,)
                                     + part.shape[3:])
                part = torch.cat([part, pad], dim=2)
            ops.scatter_pages(leaf, part, row,
                              num_pages=num_pages - first_page, axis=1)

    # --- page copies (prefix sharing) ---------------------------------------

    def copy_page(self, storage: Storage, src: int, dst: int) -> None:
        """Copy pool page ``src`` to ``dst`` in every layer of every
        tensor.  Backs copy-on-write and copy-on-adopt: the manager
        queues (src, dst) pairs and the engine applies them before any
        gather can read ``dst``."""
        for name in self.paged:
            raw = ops.bit_view(storage[name])
            raw[:, dst].copy_(raw[:, src])

    # --- admission reset ----------------------------------------------------

    def zero_slot(self, storage: Storage, slot: int) -> None:
        """Zero slot ``slot``'s column of every tensor that does not page
        (encdec's cross K / V must not leak across requests).  Paged
        tensors need no reset: a freshly allocated page holds stale rows
        only at positions >= the new request's ``kv_len``, which every
        consumer masks."""
        for name, leaf in storage.items():
            if name not in self.paged:
                leaf[:, slot].zero_()

    # --- sizing -------------------------------------------------------------

    def storage_bytes(self) -> int:
        return sum(_nbytes(self._shape(name), dt)
                   for name, (_, dt) in self.shapes.items())
