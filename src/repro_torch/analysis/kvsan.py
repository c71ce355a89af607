"""KV-page sanitizer ("kvsan"): shadow-state tracking for the paged KV pool.

Llumnix-style lossless migration, copy-on-write prefix sharing, and
preemption-by-eviction all rest on the same handful of page-ownership
invariants.  The :class:`~repro_torch.serving.paged_cache.PageAllocator`
enforces the alloc/free balance itself, but it cannot see *writes* —
the engine scatters KV into pages it believes it owns exclusively, and
a missing copy-on-write or a stale block table corrupts a co-owner's
(or the prefix index's) KV silently: the bug surfaces rounds later as a
wrong token, far from its cause.

``PageAllocator(sanitize=True)`` attaches a :class:`KVSanitizer` that
mirrors every allocator transition in an independent shadow state and
additionally receives engine-side events (block-table registration,
per-page write notifications, migration-ticket refcounts).  It raises
:class:`KVSanError` — with a journal of the most recent page operations
for context — on:

- **use-after-free** — a write to a page with no live owner;
- **double free / refcount underflow** — validated *before* any state
  (shadow or allocator) mutates;
- **CoW bypass** — a write to a shared (refcount > 1) or
  index-registered page without copy-on-write;
- **block-table aliasing** — an exclusively-owned page appearing in two
  rows' block tables;
- **ticket drift** — a migration ticket whose recorded
  ``page_refcounts`` disagree with allocator state at export time;
- **scale-pool mismatch** — with int8 KV pages, exporting (or adopting
  into a ticket) a page whose per-page scales were never written: its
  int8 payload would dequantize through stale scales on the importer;
- **EDF violation** — draining the paged engine's waiting queue past a
  strictly-more-urgent (lower priority value) request;
- **shadow divergence** — :meth:`crosscheck` compares the shadow
  against the allocator's own books (run from ``check_no_leaks``).

The sanitizer only *observes*: a clean run with ``sanitize=True`` is
byte-identical to ``sanitize=False`` (asserted by the mutation suite in
``tests/test_analysis.py``).  Set ``REPRO_SANITIZE=1`` to switch it on
fleet-wide — nightly CI runs the paged-engine/prefix-cache/migration
suites that way.

Stdlib-only on purpose: importable wherever the allocator is.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Sequence, Set


class KVSanError(ValueError):
    """A page-ownership invariant was violated.

    Subclasses :class:`ValueError` so call sites (and tests) that guard
    against the allocator's own errors keep working when the sanitizer
    reports first with more context.
    """


class KVSanitizer:
    """Shadow page-ownership state mirroring one ``PageAllocator``.

    Parameters
    ----------
    num_pages : int
        Pool size including the reserved trash page 0.
    page_size : int
        Tokens per page (reported in messages only).
    journal_len : int, optional
        Number of recent operations kept for error context.
    """

    def __init__(
        self, num_pages: int, page_size: int, journal_len: int = 24
    ) -> None:
        self.num_pages = num_pages
        self.page_size = page_size
        self._ref: Dict[int, int] = {}
        self._indexed: Set[int] = set()
        self._free: Set[int] = set(range(1, num_pages))
        self._tables: Dict[int, List[int]] = {}   # row -> block-table pages
        self._scaled: Set[int] = set()   # pages with written per-page scales
        self._journal: Deque[str] = deque(maxlen=journal_len)
        self._op = 0
        #: writes validated (clean-run observability)
        self.writes_checked = 0

    # -- internals -----------------------------------------------------------
    def _log(self, msg: str) -> None:
        self._op += 1
        self._journal.append(f"#{self._op} {msg}")

    def _fail(self, msg: str) -> None:
        tail = "\n    ".join(self._journal) or "(empty)"
        raise KVSanError(
            f"kvsan: {msg}\n  recent page ops:\n    {tail}"
        )

    def _rows_holding(self, page: int) -> List[int]:
        return sorted(
            row for row, pages in self._tables.items() if page in pages
        )

    # -- allocator transitions (called BEFORE the allocator mutates) ---------
    def on_alloc(self, pages: Sequence[int], owner: int) -> None:
        """Mirror an ``alloc``: pages must come off the free set."""
        for p in pages:
            if p not in self._free:
                state = "live" if p in self._ref else (
                    "dormant" if p in self._indexed else "unknown"
                )
                self._fail(
                    f"alloc handed out non-free page {p} ({state}) "
                    f"to owner {owner}"
                )
        for p in pages:
            self._free.discard(p)
            self._ref[p] = 1
        self._log(f"alloc {list(pages)} owner={owner}")

    def on_fork(self, pages: Sequence[int], owner: int) -> None:
        """Mirror a ``fork``: every page must be live."""
        for p in pages:
            if p not in self._ref:
                self._fail(f"fork of non-live page {p} by owner {owner}")
        for p in pages:
            self._ref[p] += 1
        self._log(f"fork {list(pages)} owner={owner}")

    def on_adopt(self, pages: Sequence[int], owner: int) -> None:
        """Mirror an ``adopt``: every page must be index-registered."""
        for p in pages:
            if p not in self._indexed:
                self._fail(f"adopt of non-indexed page {p} by owner {owner}")
        for p in pages:
            self._ref[p] = self._ref.get(p, 0) + 1
        self._log(f"adopt {list(pages)} owner={owner}")

    def on_free(self, pages: Sequence[int]) -> None:
        """Mirror a ``free``; validates fully before mutating anything.

        Raises
        ------
        KVSanError
            On a double free (including duplicate ids within one call),
            a foreign page, or a refcount underflow — *before* either
            the shadow or the allocator changes state.
        """
        counts: Dict[int, int] = {}
        for p in pages:
            counts[p] = counts.get(p, 0) + 1
        for p, c in counts.items():
            have = self._ref.get(p, 0)
            if have < c:
                kind = "double free" if p in self._free or have == 0 \
                    else "refcount underflow"
                self._fail(
                    f"{kind} of page {p} (freeing x{c}, live refcount "
                    f"{have}; holders: rows {self._rows_holding(p)})"
                )
        for p, c in counts.items():
            self._ref[p] -= c
            if self._ref[p] == 0:
                del self._ref[p]
                if p not in self._indexed:
                    self._free.add(p)
                    self._scaled.discard(p)  # freed content is garbage again
        self._log(f"free {list(pages)}")

    def on_mark_indexed(self, pages: Sequence[int]) -> None:
        """Mirror ``mark_indexed``: pages must be live."""
        for p in pages:
            if p not in self._ref:
                self._fail(f"mark_indexed of non-live page {p}")
        self._indexed.update(pages)
        self._log(f"mark_indexed {list(pages)}")

    def on_unmark_indexed(self, pages: Sequence[int]) -> None:
        """Mirror ``unmark_indexed``: dormant pages return to free."""
        for p in pages:
            if p not in self._indexed:
                self._fail(f"unmark_indexed of non-indexed page {p}")
        for p in pages:
            self._indexed.discard(p)
            if p not in self._ref:
                self._free.add(p)
                self._scaled.discard(p)  # freed content is garbage again
        self._log(f"unmark_indexed {list(pages)}")

    def on_defrag(self, mapping: Dict[int, int]) -> None:
        """Remap the shadow state after an allocator ``defrag``."""
        remap = lambda p: mapping.get(p, p)  # noqa: E731
        self._ref = {remap(p): r for p, r in self._ref.items()}
        self._indexed = {remap(p) for p in self._indexed}
        self._scaled = {remap(p) for p in self._scaled}
        self._tables = {
            row: [remap(p) for p in pages]
            for row, pages in self._tables.items()
        }
        live = set(self._ref) | self._indexed
        self._free = set(range(1, self.num_pages)) - live
        self._log(f"defrag moved={len(mapping)}")

    # -- engine-side events --------------------------------------------------
    def note_table(self, row: int, pages: Sequence[int]) -> None:
        """Register row's block-table pages; detect exclusive aliasing."""
        self._tables[row] = list(pages)
        for p in pages:
            holders = self._rows_holding(p)
            if len(holders) > self._ref.get(p, 0):
                self._fail(
                    f"block-table aliasing: page {p} appears in rows "
                    f"{holders} but has refcount {self._ref.get(p, 0)}"
                )

    def drop_table(self, row: int) -> None:
        """Forget row's block table (row released or exported)."""
        self._tables.pop(row, None)

    def note_write(self, row: int, page: int, quantized: bool = False) -> None:
        """Validate one engine write into ``page`` on behalf of ``row``.

        Parameters
        ----------
        row : int
            The writing sequence row.
        page : int
            The physical page written.
        quantized : bool, optional
            True on int8-KV engines: the write also updated the page's
            per-page scale pool entries, so the page joins the shadow
            ``scaled`` set that :meth:`validate_scale_export` checks.

        Raises
        ------
        KVSanError
            When the page is free (use-after-free), not owned at all,
            shared or index-registered (copy-on-write bypass), absent
            from the row's registered block table, or exclusively owned
            yet present in another row's table (aliasing).
        """
        if page in self._free:
            self._fail(
                f"use-after-free: row {row} wrote to freed page {page}"
            )
        ref = self._ref.get(page, 0)
        if ref == 0:
            self._fail(
                f"use-after-free: row {row} wrote to page {page} with no "
                f"live owner (dormant={page in self._indexed})"
            )
        if ref > 1:
            self._fail(
                f"copy-on-write bypass: row {row} wrote to shared page "
                f"{page} (refcount {ref}, holders: rows "
                f"{self._rows_holding(page)})"
            )
        if page in self._indexed:
            self._fail(
                f"copy-on-write bypass: row {row} wrote to "
                f"index-registered page {page} — its content must keep "
                "matching the radix index's token-block key"
            )
        table = self._tables.get(row)
        if table is not None and page not in table:
            self._fail(
                f"stray write: page {page} is not in row {row}'s "
                f"registered block table {table}"
            )
        holders = self._rows_holding(page)
        if holders and holders != [row]:
            self._fail(
                f"block-table aliasing: exclusive page {page} written by "
                f"row {row} but registered to rows {holders}"
            )
        if quantized:
            self._scaled.add(page)
        self.writes_checked += 1

    def note_scale_copy(self, src: int, dst: int) -> None:
        """Mirror a copy-on-write page copy's effect on the scale pools.

        The engine's CoW copies every pool leaf — including ``k_s``/
        ``v_s`` on int8 engines — so ``dst`` inherits ``src``'s scale
        validity.  A no-op when ``src`` has no recorded scales.
        """
        if src in self._scaled:
            self._scaled.add(dst)
            self._log(f"scale-copy {src} -> {dst}")

    def validate_scale_export(self, pages: Sequence[int]) -> None:
        """Check every exported page carries written per-page scales.

        Called by ``export_request`` on int8-KV engines before the
        ticket leaves: an exported page whose scale-pool entries were
        never written would dequantize its int8 payload through stale
        scales on the importing replica — silent KV corruption that
        surfaces tokens later.

        Parameters
        ----------
        pages : sequence of int
            The exported pages, block-table order.

        Raises
        ------
        KVSanError
            Naming the first page with no recorded quantized write.
        """
        for p in pages:
            if p not in self._scaled:
                self._fail(
                    f"scale-pool mismatch: exporting page {p} but its "
                    "per-page scales were never written (int8 payload "
                    "would dequantize through stale scales)"
                )

    def validate_ticket(
        self, pages: Sequence[int], refcounts: Optional[Sequence[int]]
    ) -> None:
        """Check a migration ticket's refcounts against shadow state.

        Parameters
        ----------
        pages : sequence of int
            The exported pages, block-table order.
        refcounts : sequence of int, optional
            ``MigrationTicket.page_refcounts`` as recorded at export.

        Raises
        ------
        KVSanError
            When the recorded refcounts disagree with the shadow's live
            counts — the ticket was built from stale allocator state.
        """
        if refcounts is None:
            return
        if len(refcounts) != len(pages):
            self._fail(
                f"migration ticket covers {len(pages)} pages but records "
                f"{len(refcounts)} refcounts"
            )
        for p, rc in zip(pages, refcounts):
            have = self._ref.get(p, 0)
            if rc != have:
                self._fail(
                    f"migration ticket refcount drift: page {p} recorded "
                    f"at {rc} but allocator holds {have} — the ticket was "
                    "built from stale state"
                )

    def check_edf_drain(
        self, chosen_priority: float, waiting_priorities: Iterable[float]
    ) -> None:
        """Assert the waiting queue drains earliest-deadline-first.

        Parameters
        ----------
        chosen_priority : float
            Priority of the request just re-admitted.
        waiting_priorities : iterable of float
            Priorities still waiting *after* the choice.

        Raises
        ------
        KVSanError
            If some still-waiting request is strictly more urgent than
            the one admitted.
        """
        for p in waiting_priorities:
            if p < chosen_priority:
                self._fail(
                    f"EDF violation: re-admitted priority "
                    f"{chosen_priority} while priority {p} still waits"
                )

    # -- cross-validation ----------------------------------------------------
    def crosscheck(self, allocator) -> None:
        """Compare the shadow against the allocator's own books.

        Parameters
        ----------
        allocator : PageAllocator
            The allocator this sanitizer shadows.

        Raises
        ------
        KVSanError
            On any divergence in refcounts, the indexed set, or the
            free list — evidence of an allocator-internal bug or a
            state mutation that bypassed the sanitizer hooks.
        """
        if dict(allocator._ref) != self._ref:
            self._fail(
                f"shadow refcount divergence: allocator {allocator._ref} "
                f"vs shadow {self._ref}"
            )
        if set(allocator._indexed) != self._indexed:
            self._fail(
                f"shadow index divergence: allocator "
                f"{sorted(allocator._indexed)} vs shadow "
                f"{sorted(self._indexed)}"
            )
        if set(allocator._free) != self._free:
            self._fail(
                f"shadow free-list divergence: allocator "
                f"{sorted(allocator._free)} vs shadow {sorted(self._free)}"
            )
