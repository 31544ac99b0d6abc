"""PrefixTrie: token-keyed index of shareable KV pages.

Counterpart of ``repro.cache.prefix``, copied (it is pure Python).  The
host-side half of prefix sharing (vLLM PagedAttention / SGLang
RadixAttention lineage, page-granular like vLLM rather than
arbitrary-split radix): one trie node per FULL page of a previously
prefilled prompt, keyed by that page's ``page_size`` token ids.  A node
chain from the root therefore names a token prefix AND the exact pages
holding its K/V rows — admission walks the new prompt down the chain and
adopts every matched page instead of recomputing it.

Refcounts live in the
:class:`~repro_torch.cache.manager.CacheManager` (the trie never
touches them): every anchored node holds one reference on its page, so a
page can outlive the request that prefilled it.  Two match grades:

- **full-page** — the prompt's next ``page_size`` tokens equal a child's
  key: the child's page is adopted in place (refcount++, no copy);
- **boundary** — the prompt ends mid-page but a child's key STARTS with
  the remaining tokens: the child's page holds a superset of the rows
  the prompt needs, so the manager copies it into a fresh private page
  ("copy-on-adopt" — the donor stays anchored for future full matches).

Eviction is leaf-first LRU over nodes whose page the manager reports as
trie-only (``refcount == 1``): an in-use chain's ancestors are all
pinned by their adopters' refcounts, so evictable nodes always form
whole subtrees and leaf-first removal reaches every one of them.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple


class _Node:
    """One full page of a cached prefix: key = its page of token ids."""

    __slots__ = ("key", "page", "parent", "children", "last_use")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_use = 0


class PrefixMatch:
    """What a prompt can reuse: adopted pages + an optional copy donor."""

    __slots__ = ("pages", "boundary_page", "boundary_rows")

    def __init__(self, pages: List[int], boundary_page: Optional[int],
                 boundary_rows: int):
        self.pages = pages              # full-page adoptions, in order
        self.boundary_page = boundary_page  # copy-on-adopt donor (or None)
        self.boundary_rows = boundary_rows  # rows the donor covers

    @property
    def full_pages(self) -> int:
        return len(self.pages)


class PrefixTrie:
    """Page-granular prefix index over previously prefilled prompts."""

    def __init__(self, page_size: int, capacity: Optional[int] = None):
        assert page_size >= 1
        self.page_size = page_size
        self.capacity = capacity        # max anchored pages (None = inf)
        self.root = _Node((), -1, None)
        self.anchored = 0               # live (non-root) node count
        self._clock = 0                 # logical LRU time

    # --- lookup -------------------------------------------------------------

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_use = self._clock

    def match(self, tokens: Sequence[int], *,
              touch: bool = True) -> PrefixMatch:
        """Longest reusable prefix of ``tokens``.

        Full-page matching is capped at ``(len(tokens) - 1) // page_size``
        pages: the LAST prompt token's logits are never cached, so at
        least one row must always be recomputed by the suffix prefill.
        The boundary donor (when present) covers every remaining row but
        that last one — ``boundary_rows == len(tokens) - full_rows - 1``
        is implied and stored explicitly for the caller's arithmetic.
        """
        ps = self.page_size
        n = len(tokens)
        pages: List[int] = []
        node = self.root
        cap = max(0, (n - 1) // ps)     # full pages adoptable
        while len(pages) < cap:
            j = len(pages)
            key = tuple(tokens[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                break
            if touch:
                self._touch(child)
            pages.append(child.page)
            node = child
        rest = tuple(tokens[len(pages) * ps:])
        # a donor must cover rows [0, len(rest) - 1) of the remainder in
        # ONE page, so len(rest) <= ps is implied: a longer rest's first
        # ps tokens would have been a full-page child (checked above)
        if 2 <= len(rest) <= ps:        # >= 1 copied row + the recomputed one
            for key, child in node.children.items():
                if key[:len(rest)] == rest:
                    if touch:
                        self._touch(child)
                    return PrefixMatch(pages, child.page, len(rest) - 1)
        return PrefixMatch(pages, None, 0)

    # --- insertion ----------------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int], *,
               can_add: Optional[Callable[[], bool]] = None) -> List[int]:
        """Index ``tokens``' FULL pages, returning the pages newly
        anchored (the caller owns their refcounts).  Existing nodes are
        deduped — a re-prefilled identical prefix anchors nothing new
        and the prompt's own copy of the page stays private.  ``can_add``
        is consulted before each new node (the manager's capacity /
        eviction hook); a False stops extension at that depth.
        """
        ps = self.page_size
        full = len(tokens) // ps
        assert len(pages) >= full, "insert needs one page per full chunk"
        node = self.root
        new: List[int] = []
        for j in range(full):
            key = tuple(tokens[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                if can_add is not None and not can_add():
                    break
                child = _Node(key, int(pages[j]), node)
                node.children[key] = child
                self.anchored += 1
                new.append(child.page)
            self._touch(child)
            node = child
        return new

    # --- eviction -----------------------------------------------------------

    def _iter_nodes(self) -> Iterator[_Node]:
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def pages(self) -> Iterator[int]:
        """Every anchored page (conservation checks read this)."""
        for node in self._iter_nodes():
            yield node.page

    def pop_evictable(self, evictable: Callable[[int], bool]
                      ) -> Optional[int]:
        """Detach the LRU LEAF whose page the predicate allows (the
        manager passes ``refcount == 1``, i.e. trie-only) and return its
        page; None when nothing qualifies.  Interior nodes become leaves
        as their subtrees drain, so repeated calls walk whole chains."""
        victim: Optional[_Node] = None
        for node in self._iter_nodes():
            if node.children or not evictable(node.page):
                continue
            if victim is None or node.last_use < victim.last_use:
                victim = node
        if victim is None:
            return None
        del victim.parent.children[victim.key]
        self.anchored -= 1
        return victim.page

    def __len__(self) -> int:
        return self.anchored
