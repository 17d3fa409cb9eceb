"""Page allocator and radix prefix trie for the paged KV cache.

The port's own copy of ``rlo_tpu/serving/pages.py`` (the JAX package's
module is free of JAX, but the port imports nothing of it): host-side
bookkeeping for the paged ``DecodeServer``. The device holds one global
pool of ``page_size``-token seq-minor KV pages per layer
(``rlo_tpu_torch.models.paged``); this module owns which page belongs to
whom.

Invariants (the copy-on-write refcount rules, enforced here and relied
on by the device side):

  - Page 0 is the NULL page: never allocated, never freed, refcount
    pinned at 0. Masked or inactive cache writes are dropped (the offset
    sentinel); nothing real ever maps it.
  - A page with refcount 1 has exactly one owner and is writable by it.
  - A page with refcount > 1 is SHARED and read-only: a party that needs
    to write it copies it first (allocate a fresh page, device-copy,
    swap its own mapping, release the original). The one sanctioned
    exception: the request that REGISTERED a partial-tail trie entry
    keeps write rights to the lanes BEYOND the registered prefix length
    (the entry vouches only for its own ``len`` leading lanes; see
    ``PrefixTrie.register``).
  - The trie holds its own refcount on every page it references, so
    prefix-cache pages outlive their registering request; eviction
    (``PrefixTrie.evict``) only drops entries whose pages nobody else
    references (refcount == 1).

Everything here is deterministic (LIFO free list, insertion-ordered trie
walks), so two servers fed the same requests make the same decisions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

NULL_PAGE = 0  # rlo-prover: lane-pinned (device sentinel: paged.py)


class PageError(RuntimeError):
    """Allocator misuse (double free, retain of a free page) — always
    a caller bug, never load-dependent."""


class PageAllocator:
    """Fixed pool of ``n_pages`` KV pages with a LIFO free list and
    per-page refcounts. ``alloc`` returns ``None`` under exhaustion
    (admission backpressure), never raises."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(
                f"need at least 2 pages (page 0 is the null page), "
                f"got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be positive, got "
                             f"{page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        # LIFO: pop() hands out 1, 2, 3, ... on a fresh pool, and the
        # most recently freed page is reused first — deterministic and
        # cache-friendly
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._ref: List[int] = [0] * n_pages
        self.allocs = 0
        self.frees = 0
        self.alloc_failures = 0
        self.peak_in_use = 0  # high-water mark, for pool sizing

    # ---- queries -----------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def refcount(self, page: int) -> int:
        return self._ref[page]

    # ---- lifecycle ---------------------------------------------------
    def alloc(self) -> Optional[int]:
        """One fresh page at refcount 1, or None when the pool is
        exhausted (the caller applies backpressure / eviction)."""
        if not self._free:
            self.alloc_failures += 1
            return None
        page = self._free.pop()
        self._ref[page] = 1
        self.allocs += 1
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return page

    def retain(self, page: int) -> None:
        """One more reference to a live page (prefix sharing / trie)."""
        if page == NULL_PAGE or not 0 < page < self.n_pages:
            raise PageError(f"retain of invalid page {page}")
        if self._ref[page] <= 0:
            raise PageError(f"retain of free page {page}")
        self._ref[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; returns True when the page went back to
        the free list."""
        if page == NULL_PAGE or not 0 < page < self.n_pages:
            raise PageError(f"release of invalid page {page}")
        if self._ref[page] <= 0:
            raise PageError(f"double free of page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
            self.frees += 1
            return True
        return False

    def stats(self) -> Dict[str, int]:
        return {"n_pages": self.n_pages, "page_size": self.page_size,
                "pages_in_use": self.pages_in_use,
                "pages_free": self.free_pages,
                "pages_peak": self.peak_in_use,
                "allocs": self.allocs, "frees": self.frees,
                "alloc_failures": self.alloc_failures}


class _Node:
    __slots__ = ("children", "partials")

    def __init__(self):
        # full-page edges: chunk tokens -> (page, child node)
        self.children: Dict[Tuple[int, ...], Tuple[int, "_Node"]] = {}
        # partial tails registered at this depth: tokens -> page; the
        # entry vouches ONLY for its len(tokens) leading lanes
        self.partials: Dict[Tuple[int, ...], int] = {}


class PrefixTrie:
    """Radix-style prefix index keyed on ``page_size``-token chunks.

    ``match`` finds the longest cached prefix of a prompt (full-page
    edges, then the longest registered partial tail); ``register``
    records a freshly prefilled prompt's pages (first-wins per chunk:
    identical tokens at identical positions produce bit-identical K/V,
    so whichever physical page got there first serves everyone).
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._root = _Node()
        self.entries = 0

    def match(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest shared prefix of ``prompt``: returns (pages,
        covered) where ``pages`` maps table indexes 0..len(pages)-1 and
        ``covered`` is the number of prefix tokens they hold (the last
        page may be partial). Pages are NOT retained here — the caller
        retains the ones it actually maps."""
        prompt = tuple(int(t) for t in prompt)
        ps = self.page_size
        node = self._root
        pages: List[int] = []
        off = 0
        while off + ps <= len(prompt):
            hit = node.children.get(prompt[off:off + ps])
            if hit is None:
                break
            pages.append(hit[0])
            node = hit[1]
            off += ps
        rest = prompt[off:]
        best: Optional[Tuple[Tuple[int, ...], int]] = None
        for toks, page in node.partials.items():
            if len(toks) <= len(rest) and rest[:len(toks)] == toks \
                    and (best is None or len(toks) > len(best[0])):
                best = (toks, page)
        if best is not None:
            pages.append(best[1])
            off += len(best[0])
        return pages, off

    def register(self, prompt: Sequence[int], plen: int,
                 pages_by_index: Sequence[int],
                 allocator: PageAllocator) -> int:
        """Record a prefilled prompt's pages: one edge per FULL page
        chunk, plus the tail (``plen % page_size`` tokens, if any) as a
        partial entry. Each newly registered page is ``retain``ed (the
        trie's own reference). Existing entries win (identical tokens
        => identical K/V). Returns the number of pages newly
        registered."""
        prompt = tuple(int(t) for t in prompt)[:plen]
        ps = self.page_size
        node = self._root
        added = 0
        n_full = plen // ps
        for i in range(n_full):
            chunk = prompt[i * ps:(i + 1) * ps]
            hit = node.children.get(chunk)
            if hit is None:
                page = int(pages_by_index[i])
                allocator.retain(page)
                child = _Node()
                node.children[chunk] = (page, child)
                added += 1
                node = child
            else:
                node = hit[1]
        tail = prompt[n_full * ps:plen]
        if tail and tail not in node.partials:
            page = int(pages_by_index[n_full])
            allocator.retain(page)
            node.partials[tail] = page
            added += 1
        self.entries += added
        return added

    def evict(self, allocator: PageAllocator, need: int) -> int:
        """Free up to ``need`` pages by dropping entries only the trie
        still references (refcount == 1). Leaf-most first (an interior
        edge is only evictable once its subtree is gone — removing it
        earlier would orphan the descendants' retains), partials before
        full-page edges, insertion order within a level; repeated
        passes until satisfied or nothing is evictable. Returns pages
        actually freed."""
        freed = 0
        progress = True
        while freed < need and progress:
            progress = False
            stack: List[Tuple[_Node, Optional[_Node],
                              Optional[Tuple[int, ...]]]] = \
                [(self._root, None, None)]
            # post-order: collect (node, parent, edge) deepest-first
            order: List[Tuple[_Node, Optional[_Node],
                              Optional[Tuple[int, ...]]]] = []
            while stack:
                node, parent, edge = stack.pop()
                order.append((node, parent, edge))
                for chunk, (_, child) in node.children.items():
                    stack.append((child, node, chunk))
            for node, parent, edge in reversed(order):
                if freed >= need:
                    break
                for toks in [t for t, p in node.partials.items()
                             if allocator.refcount(p) == 1]:
                    page = node.partials.pop(toks)
                    allocator.release(page)
                    self.entries -= 1
                    freed += 1
                    progress = True
                    if freed >= need:
                        break
                if (freed < need and parent is not None
                        and not node.children and not node.partials):
                    page = parent.children[edge][0]
                    if allocator.refcount(page) == 1:
                        del parent.children[edge]
                        allocator.release(page)
                        self.entries -= 1
                        freed += 1
                        progress = True
        return freed
