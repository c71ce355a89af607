"""Radix index over shared KV-cache prompt prefixes (SGLang-style).

Compound LLM applications re-feed identical prefixes constantly: every
stage of a job shares the application's system prompt, sibling tasks of
one stage share the stage prompt, and repeated jobs of one app template
share everything but a small suffix.  Re-prefilling those tokens wastes
both compute (the prefill FLOPs) and memory (duplicate KV pages).

:class:`RadixPrefixIndex` maps **token blocks** — page-sized runs of
prompt tokens — to the physical KV pages that already hold their K/V.
It is a radix tree with one page per node: a child edge is keyed by the
tuple of ``page_size`` tokens the page stores, so a root-to-node path
spells out a prompt prefix in whole pages.  Only *full* prompt pages
are ever indexed (a partially-filled page's content would change as its
owner decodes, invalidating the key).

The index stores page **ids**, never refcounts — ownership lives in the
:class:`~repro_torch.serving.paged_cache.PageAllocator`.  The contract with
the engine:

- ``match(prompt)`` returns the longest chain of indexed pages whose
  token blocks prefix the prompt; the engine ``adopt``\\ s them
  (refcount +1) and skips their tokens during chunked prefill;
- ``insert(prompt, pages)`` registers a finished prefill's full prompt
  pages; already-present blocks keep their existing page (first writer
  wins), and the engine ``mark_indexed``\\ s only the newly registered
  ones;
- ``evict(...)`` pops least-recently-used **leaf** entries whose pages
  have no live owner (refcount 0 — dormant), so eviction can never pull
  a page out from under a running request, and interior prefixes stay
  connected;
- ``remap(mapping)`` renumbers pages after an allocator ``defrag``.
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class _Node:
    """One indexed page: a token-block edge in the radix tree."""

    __slots__ = ("block", "page", "children", "parent", "last_use", "seq")

    def __init__(
        self,
        block: Optional[Tuple[int, ...]],
        page: int,
        parent: Optional["_Node"],
        seq: int = 0,
    ) -> None:
        self.block = block          # page_size-token key (None at the root)
        self.page = page            # physical page id (-1 at the root)
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_use = 0
        self.seq = seq              # creation order: deterministic LRU ties


class RadixPrefixIndex:
    """Token-block radix tree mapping prompt prefixes to KV page lists.

    Parameters
    ----------
    page_size : int
        Tokens per KV page; blocks are keyed at this granularity.
    """

    def __init__(self, page_size: int) -> None:
        self.page_size = int(page_size)
        self._root = _Node(None, -1, None)
        self._clock = 0                      # logical LRU time
        self._seq = 0                        # node-creation counter
        self._n_pages = 0
        self.hits = 0                        # match() calls that found >=1 page
        self.hit_tokens = 0                  # cumulative tokens matched
        self.evictions = 0                   # pages evicted under pressure

    # -- capacity ------------------------------------------------------------
    @property
    def cached_pages(self) -> int:
        """Number of pages currently registered in the index.

        Returns
        -------
        int
            Indexed page count (live + dormant alike).
        """
        return self._n_pages

    @property
    def cached_tokens(self) -> int:
        """Tokens of reusable prefix KV currently resident.

        This is the per-replica "prefix-hit estimate" the scheduler's
        cache-aware placement term consumes.

        Returns
        -------
        int
            ``cached_pages × page_size``.
        """
        return self._n_pages * self.page_size

    # -- blocks --------------------------------------------------------------
    def _blocks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        ps = self.page_size
        n = len(tokens) // ps                # full blocks only
        return [tuple(tokens[i * ps:(i + 1) * ps]) for i in range(n)]

    # -- match ---------------------------------------------------------------
    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest-prefix match of ``tokens`` against indexed blocks.

        Parameters
        ----------
        tokens : sequence of int
            The prompt; only its full page-sized blocks participate.

        Returns
        -------
        list of int
            Physical page ids of the matched prefix, outermost first
            (possibly empty).  Matched nodes' LRU stamps are refreshed
            root-to-leaf so a match protects the whole chain.  The
            ``hits``/``hit_tokens`` statistics are *not* bumped here —
            an admission that later fails would inflate them once per
            retry; the engine calls :meth:`record_hit` only when the
            matched pages are actually adopted.
        """
        self._clock += 1
        node = self._root
        pages: List[int] = []
        for block in self._blocks(tokens):
            child = node.children.get(block)
            if child is None:
                break
            child.last_use = self._clock
            pages.append(child.page)
            node = child
        return pages

    def record_hit(self, n_pages: int) -> None:
        """Count one successful prefix adoption of ``n_pages`` pages.

        Parameters
        ----------
        n_pages : int
            Pages adopted (0 is ignored).
        """
        if n_pages > 0:
            self.hits += 1
            self.hit_tokens += n_pages * self.page_size

    # -- insert --------------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> List[int]:
        """Register a prefilled prompt's full pages under their blocks.

        Parameters
        ----------
        tokens : sequence of int
            The full prompt whose prefill just completed.
        pages : sequence of int
            The request's physical pages for the prompt's full blocks,
            in order (``len(tokens) // page_size`` entries; extra
            entries are ignored).

        Returns
        -------
        list of int
            Page ids *newly* registered by this call — the engine must
            ``mark_indexed`` exactly these.  Blocks already present
            keep their existing page (first writer wins), which is
            loss-free because identical tokens at identical positions
            produce identical KV.
        """
        self._clock += 1
        node = self._root
        fresh: List[int] = []
        for block, page in zip(self._blocks(tokens), pages):
            child = node.children.get(block)
            if child is None:
                self._seq += 1
                child = _Node(block, int(page), node, seq=self._seq)
                node.children[block] = child
                self._n_pages += 1
                fresh.append(int(page))
            child.last_use = self._clock
            node = child
        return fresh

    # -- evict ---------------------------------------------------------------
    def evict(
        self,
        max_pages: int,
        evictable: Callable[[int], bool],
    ) -> List[int]:
        """Pop up to ``max_pages`` LRU leaf entries with dormant pages.

        Parameters
        ----------
        max_pages : int
            Upper bound on pages to evict this call.
        evictable : callable
            ``page_id -> bool``; typically
            ``lambda p: allocator.refcount(p) == 0`` so pages still
            owned by a live request are never pulled.

        Returns
        -------
        list of int
            Evicted page ids, LRU-first.  The engine must
            ``unmark_indexed`` them to return them to the free list.
        """
        # one tree walk builds the leaf frontier; evicting a leaf may
        # promote its parent into the frontier, so the whole call is
        # O(nodes + evicted·log leaves) instead of a rescan per page
        heap = [
            (n.last_use, n.seq, n)
            for n in self._iter_nodes()
            if not n.children
        ]
        heapq.heapify(heap)
        out: List[int] = []
        while heap and len(out) < max_pages:
            _, _, victim = heapq.heappop(heap)
            if not evictable(victim.page):
                continue  # pinned by a live owner; blocks its ancestors
            del victim.parent.children[victim.block]
            self._n_pages -= 1
            out.append(victim.page)
            parent = victim.parent
            if parent is not self._root and not parent.children:
                heapq.heappush(heap, (parent.last_use, parent.seq, parent))
        self.evictions += len(out)
        return out

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    # -- maintenance ---------------------------------------------------------
    def remap(self, mapping: Dict[int, int]) -> None:
        """Renumber pages after an allocator defrag.

        Parameters
        ----------
        mapping : dict of int to int
            ``{old_id: new_id}`` as returned by
            :meth:`~repro_torch.serving.paged_cache.PageAllocator.defrag`;
            pages absent from the mapping kept their id.
        """
        for n in self._iter_nodes():
            n.page = mapping.get(n.page, n.page)

    def drop(self) -> List[int]:
        """Clear the whole index (e.g. before a weight swap).

        Returns
        -------
        list of int
            Every page id that was registered; the engine must
            ``unmark_indexed`` them all.
        """
        pages = [n.page for n in self._iter_nodes()]
        self._root.children.clear()
        self._n_pages = 0
        return pages
