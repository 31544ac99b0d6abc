"""CacheSpec: the declarative input to the cache subsystem.

Counterpart of ``repro.cache.spec``, copied (it is framework-neutral).
A spec says WHAT cache an engine runs (family, capacity, dtype, layout)
and nothing about HOW the tensors are arranged; a
:class:`~repro_torch.cache.layout.CacheLayout`, resolved by the
:class:`~repro_torch.cache.manager.CacheManager`, arranges them.

Two layouts:

- ``dense`` — the ``(layers, B, max_len, ...)`` tensors of
  ``Model.init_cache``.
- ``paged`` — fixed-size pages in a shared pool plus per-slot page
  tables: per-request capacity, ragged per-slot residency, and decode
  views sized by the RESIDENT-length bucket instead of the padded slot
  capacity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

LAYOUTS = ("dense", "paged")

# Page 0 of every pool is the trash page: unallocated page-table entries
# point at it, so gathers of a slot's unallocated tail read (masked)
# garbage and scatters of that tail land somewhere harmless.
TRASH_PAGE = 0


@dataclass(frozen=True)
class CacheSpec:
    """One engine's KV-cache storage, declaratively.

    ``page_budget`` is the number of DATA pages in the pool (the trash
    page is extra); ``None`` sizes it dense-equivalently — every slot
    can hold ``max_len`` rows, so nothing a dense engine could serve is
    refused.  Smaller budgets oversubscribe slots against each other:
    admission then gates on free pages and a mid-flight allocation
    failure surfaces as a per-request ``cache_capacity`` finish.

    ``share_prefix`` (paged only) turns on per-page refcounts plus a
    token-keyed prefix trie in the
    :class:`~repro_torch.cache.manager.CacheManager`:
    admission maps a request's shared prompt prefix onto already-
    resident pages (zero prefill compute for the shared part) and pages
    copy-on-write when a write would dirty a page another owner still
    reads.  ``prefix_capacity`` bounds how many pages the trie may keep
    anchored (None = unbounded); anchored-only pages are evicted
    leaf-first LRU when the pool runs dry or the bound is hit.
    """
    family: str
    batch: int
    max_len: int
    kv_dtype: str = "bfloat16"
    layout: str = "dense"
    page_size: int = 64
    page_budget: Optional[int] = None
    share_prefix: bool = False
    prefix_capacity: Optional[int] = None

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(
                f"unknown cache layout {self.layout!r}; known: {LAYOUTS}")
        if self.batch < 1 or self.max_len < 1:
            raise ValueError(f"bad cache extent: batch={self.batch}, "
                             f"max_len={self.max_len}")
        if self.layout == "paged":
            if self.page_size < 1:
                raise ValueError(f"page_size must be >= 1, "
                                 f"got {self.page_size}")
            if self.page_budget is not None and self.page_budget < 1:
                raise ValueError(f"page_budget must be >= 1, "
                                 f"got {self.page_budget}")
            if self.prefix_capacity is not None \
                    and self.prefix_capacity < 1:
                raise ValueError(f"prefix_capacity must be >= 1, "
                                 f"got {self.prefix_capacity}")
        elif self.share_prefix:
            raise ValueError(
                "share_prefix needs per-slot page tables to map shared "
                "prefixes onto; use layout='paged'")

    # --- derived extents ----------------------------------------------------

    @property
    def slot_pages(self) -> int:
        """Page-table width: pages a single slot can ever hold."""
        return -(-self.max_len // self.page_size)

    @property
    def total_pages(self) -> int:
        """Data pages in the pool (excluding the trash page)."""
        if self.page_budget is not None:
            return self.page_budget
        return self.batch * self.slot_pages

    @property
    def pool_pages(self) -> int:
        """Pool allocation size: data pages + the trash page."""
        return self.total_pages + 1

    def pages_for(self, length: int) -> int:
        """Pages needed to hold ``length`` resident rows."""
        return -(-max(0, int(length)) // self.page_size)

    def view_pages(self, view_len: int) -> int:
        """Pages a gather covering ``view_len`` rows spans (capped at the
        slot-table width — a view can never exceed a slot's capacity)."""
        return min(-(-int(view_len) // self.page_size), self.slot_pages)
