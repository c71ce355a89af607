"""Block-table page allocator for the paged KV cache.

Pages are position-independent fixed-size chunks of KV storage; the
allocator hands out physical page ids and enforces the invariants the
engine's correctness rests on:

- every page carries a **refcount** — the number of live owners whose
  block tables reference it.  Exclusive ownership (refcount 1) is the
  historical regime; shared prefixes and copy-on-write forks raise it;
- every acquisition (:meth:`alloc`, :meth:`fork`, :meth:`adopt`) is
  balanced by exactly one :meth:`free` (no leaks, no double frees) —
  violations raise immediately instead of corrupting caches;
- a page whose refcount drops to zero returns to the free list *unless*
  it is marked **indexed** (registered in a
  :class:`~repro_torch.serving.prefix_cache.RadixPrefixIndex`): indexed pages
  become *dormant* — content retained, re-sharable via :meth:`adopt`,
  reclaimed to the free list only when the index evicts them
  (:meth:`unmark_indexed`) under memory pressure.

Page 0 is reserved as the *trash page*: padding rows in a decode batch
point their block tables at it, so their (discarded) writes can never
land in a live request's pages.

``defrag`` compacts the content-bearing set (live + dormant) onto the
lowest physical page ids (improving DMA locality after heavy churn) and
returns the old→new mapping so the engine can permute pools and patch
block tables and the prefix index.

Live migration composes from these primitives: the source engine
``free``\\ s a request's pages after gathering their contents into a
:class:`~repro_torch.serving.paged_engine.MigrationTicket`, and the
destination ``alloc``\\ s fresh pages to scatter the KV back in — the
invariants above guarantee the handoff can neither leak nor alias, and
shared prefix pages survive on the source as long as any other owner
(or the index) still holds them.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Set

from ..analysis.kvsan import KVSanitizer


TRASH_PAGE = 0


def _env_sanitize() -> bool:
    """Resolve the ``REPRO_SANITIZE`` environment default."""
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


class PageAllocator:
    """Refcounting free-list allocator over ``num_pages`` KV pages.

    Every physical page (except the reserved trash page 0) is in exactly
    one of three states:

    - **free** — on the free list, content dead, allocatable;
    - **live** — refcount ≥ 1, owned by one or more sequences;
    - **dormant** — refcount 0 but marked indexed (prefix-cache
      resident): content retained, acquirable via :meth:`adopt`,
      reclaimable via :meth:`unmark_indexed`.

    Parameters
    ----------
    num_pages : int
        Total physical pages including the reserved trash page 0;
        must be at least 2.
    page_size : int
        Tokens of KV per page.
    sanitize : bool, optional
        Attach a :class:`~repro_torch.analysis.kvsan.KVSanitizer` that
        mirrors every transition in shadow state and additionally
        validates engine-side events (writes, block tables, migration
        tickets), raising :class:`~repro_torch.analysis.kvsan.KVSanError` on
        ownership violations.  Observation-only: clean runs are
        byte-identical with it on or off.  Defaults to the
        ``REPRO_SANITIZE`` environment variable (any value other than
        empty/``0`` enables it).

    Raises
    ------
    ValueError
        If ``num_pages < 2`` (there would be no allocatable page).
    """

    def __init__(
        self,
        num_pages: int,
        page_size: int,
        sanitize: Optional[bool] = None,
    ) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # pop() -> low ids first
        self._owner: Dict[int, int] = {}  # page id -> owner tag (first live owner)
        self._ref: Dict[int, int] = {}    # page id -> live-owner count (>= 1)
        self._indexed: Set[int] = set()   # pages registered in a prefix index
        if sanitize is None:
            sanitize = _env_sanitize()
        #: the attached shadow-state sanitizer (None when disabled)
        self.sanitizer: Optional[KVSanitizer] = (
            KVSanitizer(num_pages, page_size) if sanitize else None
        )

    # -- capacity ------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        """Number of pages currently available for allocation.

        Returns
        -------
        int
            Free-list length (trash and dormant pages are never counted).
        """
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Number of pages currently owned by requests (refcount ≥ 1).

        Returns
        -------
        int
            Live page count.
        """
        return len(self._ref)

    @property
    def dormant_pages(self) -> int:
        """Number of refcount-0 pages retained by the prefix index.

        These are reclaimable under pressure: the engine evicts them
        from the index (LRU) and calls :meth:`unmark_indexed` to return
        them to the free list.

        Returns
        -------
        int
            Indexed pages with no live owner.
        """
        return sum(1 for p in self._indexed if p not in self._ref)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to store ``n_tokens`` tokens of KV.

        Parameters
        ----------
        n_tokens : int
            Token count (negative values are treated as 0).

        Returns
        -------
        int
            ``ceil(n_tokens / page_size)``.
        """
        return -(-max(0, n_tokens) // self.page_size)

    def can_alloc(self, n: int) -> bool:
        """Check whether ``n`` pages can be allocated atomically.

        Parameters
        ----------
        n : int
            Requested page count.

        Returns
        -------
        bool
            True when the free list holds at least ``n`` pages (dormant
            pages do not count — reclaim them first).
        """
        return n <= len(self._free)

    # -- refcount queries ----------------------------------------------------
    def refcount(self, page: int) -> int:
        """Return the live-owner count of ``page`` (0 for free/dormant).

        Parameters
        ----------
        page : int
            Physical page id.

        Returns
        -------
        int
            Number of live owners currently referencing the page.
        """
        return self._ref.get(page, 0)

    def is_indexed(self, page: int) -> bool:
        """Check whether ``page`` is registered in a prefix index.

        Indexed pages must be treated as read-only by the engine: a
        write would desynchronize the index's token-block key from the
        page's KV content, so writers copy-on-write first.

        Parameters
        ----------
        page : int
            Physical page id.

        Returns
        -------
        bool
            True when the page is index-registered (live or dormant).
        """
        return page in self._indexed

    # -- alloc/free ----------------------------------------------------------
    def alloc(self, n: int, owner: int = -1) -> Optional[List[int]]:
        """Atomically allocate ``n`` fresh pages at refcount 1.

        Parameters
        ----------
        n : int
            Page count; the request is all-or-nothing (no partial
            allocation is ever observable).
        owner : int, optional
            Opaque owner tag recorded per page (typically the sequence
            row); queried via :meth:`owned_by` and reported in error
            messages.

        Returns
        -------
        list of int or None
            The allocated physical page ids (lowest-id-first), or
            ``None`` when the free list cannot satisfy the request.
        """
        if n > len(self._free):
            return None
        pages = [self._free[-(i + 1)] for i in range(n)]
        if self.sanitizer is not None:
            self.sanitizer.on_alloc(pages, owner)
        del self._free[len(self._free) - n:]
        for p in pages:
            self._owner[p] = owner
            self._ref[p] = 1
        return pages

    def fork(self, pages: List[int], owner: int = -1) -> List[int]:
        """Copy-on-write fork: add an owner to already-live pages.

        Increments each page's refcount without copying any KV.  The
        new owner shares the physical pages until it writes; the engine
        detects the write (``refcount > 1`` or :meth:`is_indexed`) and
        copies the page first, so forks are O(1) until divergence.

        Parameters
        ----------
        pages : list of int
            Live page ids (refcount ≥ 1).
        owner : int, optional
            Owner tag of the forked copy (informational).

        Returns
        -------
        list of int
            The same page ids, now co-owned (balanced by one
            :meth:`free` from the new owner).

        Raises
        ------
        ValueError
            If any page is not currently live — forking a free or
            dormant page would alias dead or index-owned content
            (use :meth:`adopt` for dormant prefix pages).
        """
        for p in pages:
            if p not in self._ref:
                raise ValueError(
                    f"fork of non-live page {p} (refs: {self._ref})"
                )
        if self.sanitizer is not None:
            self.sanitizer.on_fork(pages, owner)
        for p in pages:
            self._ref[p] += 1
        return list(pages)

    def adopt(self, pages: List[int], owner: int = -1) -> List[int]:
        """Acquire index-registered prefix pages on a cache hit.

        Works for both live shared pages (another request still holds
        the prefix — refcount +1) and dormant ones (the prefix outlived
        its last owner — refcount 0 → 1, content still valid).

        Parameters
        ----------
        pages : list of int
            Indexed page ids returned by a prefix-index match.
        owner : int, optional
            Owner tag recorded when reviving a dormant page.

        Returns
        -------
        list of int
            The same page ids, now co-owned by ``owner`` (balanced by
            one :meth:`free`).

        Raises
        ------
        ValueError
            If any page is not index-registered — adopting an arbitrary
            page would alias content the index never vouched for.
        """
        for p in pages:
            if p not in self._indexed:
                raise ValueError(
                    f"adopt of non-indexed page {p} (indexed: "
                    f"{sorted(self._indexed)})"
                )
        if self.sanitizer is not None:
            self.sanitizer.on_adopt(pages, owner)
        for p in pages:
            if p in self._ref:
                self._ref[p] += 1
            else:
                self._ref[p] = 1
                self._owner[p] = owner
        return list(pages)

    def free(self, pages: List[int]) -> None:
        """Drop one ownership reference per page.

        A page whose refcount reaches 0 returns to the free list,
        unless it is index-registered — then it turns dormant (content
        retained for future :meth:`adopt`) until the index evicts it.

        Parameters
        ----------
        pages : list of int
            Page ids previously handed out by :meth:`alloc`,
            :meth:`fork`, or :meth:`adopt`.

        Raises
        ------
        ValueError
            On a double free (including a duplicate page id within one
            call) or a page this allocator never allocated — the error
            fires *before* any state is corrupted.
        """
        if self.sanitizer is not None:
            # validates fully before either side mutates, with journal
            # context the allocator's own error below cannot provide
            self.sanitizer.on_free(pages)
        counts: Dict[int, int] = {}
        for p in pages:
            counts[p] = counts.get(p, 0) + 1
        for p, c in counts.items():
            if self._ref.get(p, 0) < c:
                raise ValueError(
                    f"double free / foreign page {p} x{c} "
                    f"(refs: {self._ref})"
                )
        for p, c in counts.items():
            self._ref[p] -= c
            if self._ref[p] == 0:
                del self._ref[p]
                del self._owner[p]
                if p not in self._indexed:
                    self._free.append(p)

    # -- prefix-index registration -------------------------------------------
    def mark_indexed(self, pages: List[int]) -> None:
        """Register pages as prefix-index residents.

        Indexed pages survive their last :meth:`free` as dormant pages
        instead of returning to the free list.

        Parameters
        ----------
        pages : list of int
            Live page ids being inserted into the radix index.

        Raises
        ------
        ValueError
            If any page is not live — indexing a free page would pin
            dead content.
        """
        for p in pages:
            if p not in self._ref:
                raise ValueError(f"cannot index non-live page {p}")
        if self.sanitizer is not None:
            self.sanitizer.on_mark_indexed(pages)
        self._indexed.update(pages)

    def unmark_indexed(self, pages: List[int]) -> None:
        """Deregister index-evicted pages; dormant ones become free.

        Called by the engine after the radix index evicts entries (LRU,
        under memory pressure).  Pages still live (refcount ≥ 1) merely
        lose their indexed mark and will free normally later.

        Parameters
        ----------
        pages : list of int
            Page ids the index just evicted.

        Raises
        ------
        ValueError
            If any page was not index-registered.
        """
        for p in pages:
            if p not in self._indexed:
                raise ValueError(f"page {p} is not indexed")
        if self.sanitizer is not None:
            self.sanitizer.on_unmark_indexed(pages)
        for p in pages:
            self._indexed.discard(p)
            if p not in self._ref:
                self._free.append(p)

    def owned_by(self, owner: int) -> List[int]:
        """List the pages held under an owner tag.

        With sharing, only the *first* live owner's tag is recorded —
        exclusive pages behave exactly as before; shared pages report
        under whichever owner acquired them first.

        Parameters
        ----------
        owner : int
            The tag passed to :meth:`alloc` / :meth:`adopt`.

        Returns
        -------
        list of int
            Sorted page ids currently tagged with ``owner``.
        """
        return sorted(p for p, o in self._owner.items() if o == owner)

    def check_no_leaks(self, allow_indexed: bool = True) -> None:
        """Assert that every ownership reference has been returned.

        Call when the engine is idle (e.g. at the end of a test or
        after a migration handoff); a failure names the leaked pages.

        Parameters
        ----------
        allow_indexed : bool, optional
            When True (default), dormant prefix-cache pages are not
            leaks — they are accounted (free + dormant must cover the
            pool).  Pass False to additionally require an empty index
            (e.g. after an explicit cache drop).

        Raises
        ------
        AssertionError
            If any page is still live, the accounting does not cover
            the pool, or (with ``allow_indexed=False``) dormant pages
            remain.
        """
        if self.sanitizer is not None:
            self.sanitizer.crosscheck(self)
        if self._ref:
            raise AssertionError(f"leaked pages: {sorted(self._ref)}")
        dormant = self.dormant_pages
        if not allow_indexed and dormant:
            raise AssertionError(
                f"dormant indexed pages remain: "
                f"{sorted(p for p in self._indexed if p not in self._ref)}"
            )
        assert len(self._free) + dormant == self.num_pages - 1

    # -- defrag --------------------------------------------------------------
    def defrag(self) -> Dict[int, int]:
        """Compact content-bearing pages (live + dormant) onto low ids.

        The caller must apply the mapping to the physical pools
        (permute page rows), every live block table, and the prefix
        index before the next kernel call.

        Returns
        -------
        dict of int to int
            ``{old_id: new_id}`` for every page that moved (identity
            entries are omitted; empty when already compact).
        """
        live = sorted(set(self._ref) | self._indexed)
        mapping = {old: new for new, old in enumerate(live, start=1)}
        self._owner = {mapping[p]: o for p, o in self._owner.items()}
        self._ref = {mapping[p]: r for p, r in self._ref.items()}
        self._indexed = {mapping[p] for p in self._indexed}
        self._free = list(
            range(self.num_pages - 1, len(live), -1)
        )
        moved = {o: n for o, n in mapping.items() if o != n}
        if self.sanitizer is not None:
            self.sanitizer.on_defrag(moved)
        return moved
