"""The KV-cache subsystem (counterpart of ``repro.cache``): CacheSpec ->
CacheManager -> CacheLayout.

- :class:`CacheSpec`: WHAT cache (family, capacity, dtype, layout).
- :class:`CacheLayout`: HOW it sits on the card, :class:`DenseLayout`
  or :class:`PagedKVCache` (fixed-size pages, per-slot page tables).
- :class:`CacheManager`: residency bookkeeping (per-slot ``kv_len``,
  free-list page allocation, the page table's device mirror) and, under
  ``share_prefix``, per-page refcounts, copy-on-write and the
  :class:`PrefixTrie`.
"""
from repro_torch.cache.layout import (  # noqa: F401
    CacheLayout,
    DenseLayout,
    PagedKVCache,
)
from repro_torch.cache.manager import CacheManager  # noqa: F401
from repro_torch.cache.prefix import PrefixMatch, PrefixTrie  # noqa: F401
from repro_torch.cache.spec import (  # noqa: F401
    LAYOUTS,
    TRASH_PAGE,
    CacheSpec,
)
from repro_torch.kernels.ops import PagedKV  # noqa: F401
