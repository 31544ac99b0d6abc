"""CacheManager: resolves a CacheSpec into a layout + owns residency.

Counterpart of ``repro.cache.manager``, copied (its bookkeeping is numpy
on the host).  Two differences: :meth:`CacheManager.table_device`
uploads the page table as an int32 tensor to the model's device, and
:meth:`CacheManager.register_prefix` never evicts, to make room under
``prefix_capacity``, a page of the prompt it is registering (the
reference can, and then frees a page its slot still holds).  The manager is
the pure-Python half of the cache subsystem: it tracks per-slot resident
lengths (``kv_len``, the source of truth the Planner's resident-length
buckets come from), and, for the paged layout, the free-list, per-slot
page tables, per-page refcounts and the prefix trie.  The serving engine
owns the device tensors and asks the manager *where* things live; the
layout supplies the gather and the writes.

Page-table discipline:

- page 0 is the trash page; a freshly-initialized or released slot's
  whole table row points there;
- allocation is per-slot prefix-contiguous: slot ``i`` holding ``n``
  resident rows owns table entries ``[0, pages_for(n))``;
- allocation is all-or-nothing (a partial grab is rolled back), so a
  ``False`` from :meth:`reserve` / :meth:`ensure` leaves no state to
  clean up — the engine turns it into the per-request
  ``cache_capacity`` finish.

Page lifetime (``share_prefix``):

Every data page carries a refcount: +1 per slot-table reference and +1
when the prefix trie anchors it.  :meth:`release` DECREMENTS instead of
freeing — a page returns to the free list only at refcount zero, so a
finished request's prefix pages survive as long as the trie (or an
adopter) holds them.  Writes go through a copy-on-write guard
(:meth:`ensure` / the growth path): dirtying a page with
``refcount > 1`` first moves the writer onto a fresh private page and
queues a device-side page copy the engine applies
(:meth:`drain_copies` -> ``PagedKVCache.copy_page``) before the next
gather.  Admission maps a prompt's shared prefix onto existing pages
(:meth:`admit_prompt`) and indexes the finished prefill back into the
trie (:meth:`register_prefix`); trie-only pages (``refcount == 1``) are
reclaimed leaf-first LRU when the free list runs dry.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cache.layout import CacheLayout, DenseLayout, PagedKVCache
from repro_torch.cache.prefix import PrefixTrie
from repro_torch.cache.spec import TRASH_PAGE, CacheSpec

_LAYOUTS = {"dense": DenseLayout, "paged": PagedKVCache}


class CacheManager:
    """Residency bookkeeping + layout resolution for one engine."""

    def __init__(self, model, spec: CacheSpec, *, label: str = ""):
        self.spec = spec
        # names the owner in conservation messages and describe() (a
        # sharded engine's shard: "shard{d}")
        self.label = label
        self.layout: CacheLayout = _LAYOUTS[spec.layout](model, spec)
        self.B = spec.batch
        self.kv_len = np.zeros(self.B, np.int32)
        self._table = np.full((self.B, max(1, spec.slot_pages)),
                              TRASH_PAGE, np.int32)
        self._allocated = np.zeros(self.B, np.int32)   # prefix page count
        self._free: List[int] = list(range(spec.total_pages, 0, -1)) \
            if spec.layout == "paged" else []
        self._table_dev = None                         # dirty => None
        # per-page reference counts (index 0 = the trash page, pinned
        # at zero: it is never allocated, never freed, never shared)
        self.refcount = np.zeros(spec.pool_pages if spec.layout == "paged"
                                 else 1, np.int32)
        self.trie: Optional[PrefixTrie] = (
            PrefixTrie(spec.page_size, spec.prefix_capacity)
            if spec.layout == "paged" and spec.share_prefix else None)
        # (src, dst) device copies queued by COW / copy-on-adopt; the
        # engine drains and applies them BEFORE the next gather touches
        # dst (until the copy lands, dst holds garbage)
        self._pending_copies: List[Tuple[int, int]] = []
        # observability (benchmarks/prefix_ab reads these)
        self.prefix_hits = 0            # admissions that reused >= 1 row
        self.prefix_shared_rows = 0     # prompt rows served from the trie
        self.prefix_copies = 0          # copy-on-adopt + COW page copies
        self.pages_allocated_total = 0  # free-list pops, ever

    # --- storage ------------------------------------------------------------

    @property
    def is_paged(self) -> bool:
        return self.spec.layout == "paged"

    def init_storage(self):
        return self.layout.init_storage()

    def table_device(self) -> torch.Tensor:
        """Device mirror of the page table, an int32 tensor on the
        model's device, re-uploaded only when an allocation / release
        dirtied it (not per decode step)."""
        if self._table_dev is None:
            self._table_dev = torch.from_numpy(self._table.copy()).to(
                self.layout.model.device)
        return self._table_dev

    # --- residency ----------------------------------------------------------

    def note_write(self, slot: int, pos: int) -> None:
        """Record that row ``pos`` of ``slot`` is now resident."""
        self.kv_len[slot] = max(self.kv_len[slot], pos + 1)

    def truncate(self, slot: int, length: int) -> None:
        """Roll a slot's resident length back to ``length``.  Pages are
        not freed: the slot still owns its extent, the next write
        rewrites the rows, and every attention path masks rows at or past
        ``kv_len``, so conservation holds with the pages still owned."""
        self.kv_len[slot] = min(self.kv_len[slot], max(int(length), 0))

    def resident_max(self) -> int:
        """Largest per-slot resident length (the planner's summary)."""
        return int(self.kv_len.max()) if self.B else 0

    def release(self, slot: int) -> None:
        """Drop a finished slot's references: resident length to zero,
        per-page refcounts decremented (a page frees only at zero — the
        trie or an adopter may still hold it), table row to the trash
        page (a dead slot still rides the lockstep launch — its writes
        must land in trash).

        Idempotent: releasing an already-released slot is a no-op.  A
        double-finish (e.g. a streamed handle also swept by ``drain()``)
        must not double-decrement — under refcounting that would free
        pages other owners still read, silently aliasing two live slots.
        """
        self.kv_len[slot] = 0
        n = int(self._allocated[slot])
        if not n:                       # already released: nothing held
            return
        for p in self._table[slot, :n][::-1]:
            self._unref(int(p))
        self._table[slot, :n] = TRASH_PAGE
        self._allocated[slot] = 0
        self._table_dev = None

    def _unref(self, page: int) -> None:
        if page == TRASH_PAGE:
            return
        self.refcount[page] -= 1
        assert self.refcount[page] >= 0, f"page {page} over-released"
        if self.refcount[page] == 0:
            self._free.append(page)

    # --- page accounting ----------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, length: int) -> int:
        return self.spec.pages_for(length)

    def max_request_pages(self) -> int:
        """Largest allocation a single request may ever be GRANTED: the
        slot-table width, capped at the pool itself — a slot can never
        hold more pages than exist, so admission math against the
        uncapped table width would admit pool-filling prompts that
        deadlock the FIFO head on their first decode-token page."""
        return min(self.spec.slot_pages, self.spec.total_pages)

    def _evictable_pages(self) -> int:
        """Trie-only pages (``refcount == 1``): reclaimable leaf-first."""
        if self.trie is None:
            return 0
        return sum(1 for p in self.trie.pages() if self.refcount[p] == 1)

    def _evict_one(self, keep=()) -> bool:
        """Reclaim one trie-only page onto the free list (never one of
        ``keep``)."""
        if self.trie is None:
            return False
        p = self.trie.pop_evictable(
            lambda pg: self.refcount[pg] == 1 and pg not in keep)
        if p is None:
            return False
        self._unref(p)                  # trie's reference was the last
        return True

    def _pop_page(self) -> Optional[int]:
        if not self._free and not self._evict_one():
            return None
        p = self._free.pop()
        self.refcount[p] = 1
        self.pages_allocated_total += 1
        return p

    def can_reserve(self, length: int) -> bool:
        """Whether a fresh slot could hold ``length`` rows right now
        (counting trie-only pages, which reclaim on demand)."""
        if not self.is_paged:
            return True
        return self.pages_for(length) <= \
            len(self._free) + self._evictable_pages()

    def reserve(self, slot: int, length: int) -> bool:
        """Grow ``slot``'s allocation to cover ``length`` rows
        (all-or-nothing)."""
        if not self.is_paged:
            return True
        return self._grow(slot, self.pages_for(length))

    def ensure(self, slot: int, pos: int) -> bool:
        """Make row ``pos`` of ``slot`` writable (allocating its page if
        needed, copy-on-writing it if shared).  ``False`` = pool
        exhausted: the engine finishes the request with
        ``finish_reason='cache_capacity'``."""
        if not self.is_paged:
            return pos < self.spec.max_len
        j = pos // self.spec.page_size
        if not self._grow(slot, j + 1):
            return False
        return self._make_writable(slot, j, j + 1)

    def _grow(self, slot: int, need: int) -> bool:
        have = int(self._allocated[slot])
        if need <= have:
            return True
        if need - have > len(self._free) + self._evictable_pages():
            return False
        for j in range(have, need):
            p = self._pop_page()
            assert p is not None, "availability check raced the pool"
            self._table[slot, j] = p
        self._allocated[slot] = need
        self._table_dev = None
        return True

    def _make_writable(self, slot: int, j0: int, j1: int) -> bool:
        """Copy-on-write every shared page among ``slot``'s table
        entries ``[j0, j1)``: a write must never dirty a page another
        slot (or the trie) still reads."""
        for j in range(j0, min(j1, int(self._allocated[slot]))):
            src = int(self._table[slot, j])
            if src == TRASH_PAGE or self.refcount[src] <= 1:
                continue
            dst = self._pop_page()
            if dst is None:
                return False
            self.refcount[src] -= 1     # still > 0: others hold it
            self._table[slot, j] = dst
            self._pending_copies.append((src, dst))
            self.prefix_copies += 1
            self._table_dev = None
        return True

    def drain_copies(self) -> List[Tuple[int, int]]:
        """Take the queued (src, dst) device page copies.  The engine
        MUST apply them (``PagedKVCache.copy_page``) before the next
        gather that could read a dst page — a COW'd page holds garbage
        until its copy lands."""
        out, self._pending_copies = self._pending_copies, []
        return out

    # --- prefix sharing -----------------------------------------------------

    def can_admit(self, prompt: Sequence[int]) -> bool:
        """Page-budget admission gate, counting only the NEW pages a
        prompt needs: matched full pages are adopted (refcount++, no
        pool cost) — but adopting a trie-only page also pins it, so
        pages that are both "matched" and "evictable" can't be counted
        twice."""
        if not self.is_paged:
            return True
        if self.trie is None:
            return self.can_reserve(len(prompt))
        m = self.trie.match(prompt, touch=False)
        need = self.spec.pages_for(len(prompt)) - m.full_pages
        pinned = sum(1 for p in m.pages if self.refcount[p] == 1)
        return need <= len(self._free) + self._evictable_pages() - pinned

    def admit_prompt(self, slot: int, prompt: Sequence[int]
                     ) -> Optional[int]:
        """Map ``prompt``'s shared prefix onto existing pages and
        reserve fresh pages for the rest (all-or-nothing; a failure
        rolls the slot back and returns None — callers gate on
        :meth:`can_admit` first).

        Returns the number of ALREADY-VALID leading rows: the engine's
        suffix prefill starts there.  Full-page matches are adopted in
        place (refcount++); a boundary match additionally allocates one
        private page and queues a device copy from the donor
        ("copy-on-adopt"), leaving only the final prompt row — whose
        logits are never cached — to recompute.
        """
        n = len(prompt)
        if not self.is_paged or self.trie is None:
            return 0 if self.reserve(slot, n) else None
        assert int(self._allocated[slot]) == 0, \
            "admit_prompt needs a released slot"
        ps = self.spec.page_size
        m = self.trie.match(prompt)
        copies: List[Tuple[int, int]] = []
        for j, p in enumerate(m.pages):         # adopt full shared pages
            self._table[slot, j] = p
            self.refcount[p] += 1
        self._allocated[slot] = m.full_pages
        if m.pages:
            self._table_dev = None
        shared = m.full_pages * ps
        if m.boundary_page is not None:
            # privatize the donor's boundary page: rows
            # [shared, shared + boundary_rows) become valid on arrival
            # of the device copy (drained by the engine pre-prefill)
            if self._grow(slot, m.full_pages + 1):
                copies.append((m.boundary_page,
                               int(self._table[slot, m.full_pages])))
                shared += m.boundary_rows
            # on grow failure fall through: the final _grow below also
            # fails and rolls everything back
        if not self._grow(slot, self.spec.pages_for(n)) or \
                not self._make_writable(slot, shared // ps,
                                        (n - 1) // ps + 1):
            self.release(slot)                  # rollback (refcounts too)
            return None
        if shared:
            self.prefix_hits += 1
            self.prefix_shared_rows += shared
            self.prefix_copies += len(copies)
        self._pending_copies.extend(copies)
        return shared

    def register_prefix(self, slot: int, prompt: Sequence[int]) -> int:
        """Index ``slot``'s freshly prefilled prompt into the trie
        (FULL pages only — a partial page's tail rows are garbage).
        Newly anchored pages gain a trie reference; at
        ``prefix_capacity`` the LRU trie-only pages are evicted to make
        room, and extension stops if none can be.  Returns the number of
        pages newly anchored."""
        if self.trie is None:
            return 0
        full = len(prompt) // self.spec.page_size
        if not full:
            return 0
        pages = [int(p) for p in self._table[slot, :full]]
        keep = set(pages)

        def can_add() -> bool:
            cap = self.trie.capacity
            if cap is None or self.trie.anchored < cap:
                return True
            # never the prompt's own pages: a node this call anchored
            # has no trie reference counted until insert returns, so it
            # looks trie-only while the slot still reads it (the
            # reference evicts it, freeing a live page)
            return self._evict_one(keep)

        new = self.trie.insert(prompt, pages, can_add=can_add)
        for p in new:
            self.refcount[p] += 1
        return len(new)

    def reset_prefix(self) -> int:
        """Drop every trie anchor (pages free once unreferenced
        elsewhere).  Returns the number of anchors dropped."""
        if self.trie is None:
            return 0
        dropped = 0
        while self._evict_one():
            dropped += 1
        # anything left is adopter-pinned; detach anchors anyway so the
        # trie is empty and the pages free when their adopters finish
        remaining = self.trie.pop_evictable(lambda pg: True)
        while remaining is not None:
            self._unref(remaining)
            dropped += 1
            remaining = self.trie.pop_evictable(lambda pg: True)
        return dropped

    # --- invariants ---------------------------------------------------------

    def check_conservation(self) -> None:
        """Assert the page-conservation invariants (tests / benchmarks):

        - refcount[p] == slot-table references within allocated
          prefixes + (1 if the trie anchors p);
        - referenced + free partitions the data pool exactly (every page
          is live xor free — ``sum(refcounts of live pages)`` counts
          each shared page once per owner, so the distinct-live count is
          what conservation is stated over);
        - a page reachable from two slots has refcount >= 2;
        - the trash page is never refcounted, never free-listed, never
          inside an allocated prefix.
        """
        who = f"[{self.label}] " if self.label else ""
        rc = np.zeros_like(self.refcount)
        owners: Dict[int, int] = {}
        for i in range(self.B):
            for j in range(int(self._allocated[i])):
                p = int(self._table[i, j])
                assert p != TRASH_PAGE, \
                    f"{who}slot {i} allocated prefix holds the trash page"
                rc[p] += 1
                owners[p] = owners.get(p, 0) + 1
        if self.trie is not None:
            for p in self.trie.pages():
                rc[p] += 1
        assert (rc == self.refcount).all(), \
            f"{who}refcount drift: expected {rc.tolist()}, " \
            f"have {self.refcount.tolist()}"
        for p, k in owners.items():
            if k >= 2:
                assert self.refcount[p] >= 2, \
                    f"{who}page {p} in {k} slots with refcount " \
                    f"{int(self.refcount[p])}"
        live = {int(p) for p in np.nonzero(self.refcount)[0]}
        free = set(self._free)
        assert len(free) == len(self._free), \
            f"{who}free list holds duplicates"
        assert not (live & free), \
            f"{who}pages both live and free: {live & free}"
        assert TRASH_PAGE not in free and TRASH_PAGE not in live
        assert len(live) + len(free) == self.spec.total_pages, \
            f"{who}pool leak: {len(live)} live + {len(free)} free != " \
            f"{self.spec.total_pages}"

    # --- observability ------------------------------------------------------

    def describe(self) -> Dict[str, object]:
        d: Dict[str, object] = {
            "layout": self.spec.layout,
            "kv_dtype": self.spec.kv_dtype,
        }
        if self.label:
            d["label"] = self.label
        d.update({
            "storage_bytes": self.layout.storage_bytes(),
            "dense_bytes": self.layout.dense_bytes(),
            "resident_max": self.resident_max(),
        })
        if self.is_paged:
            d.update(page_size=self.spec.page_size,
                     total_pages=self.spec.total_pages,
                     free_pages=len(self._free),
                     allocated=[int(a) for a in self._allocated])
            if self.trie is not None:
                d.update(share_prefix=True,
                         prefix_anchored_pages=self.trie.anchored,
                         prefix_hits=self.prefix_hits,
                         prefix_shared_rows=self.prefix_shared_rows,
                         prefix_copies=self.prefix_copies,
                         pages_allocated_total=self.pages_allocated_total)
        return d
