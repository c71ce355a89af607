"""Cross-replica live-migration policy (Llumnix-style rebalancing).

The mechanism lives in :class:`~repro_torch.serving.paged_engine.PagedLLMEngine`
(:meth:`export_request` / :meth:`import_request`, a lossless KV handoff
through each engine's :class:`~repro_torch.serving.paged_cache.PageAllocator`);
this module supplies the *policy*: when to move which request where.

:class:`Rebalancer` watches a fleet of paged replicas and migrates the
youngest decoding request away from replicas that are KV-starved —
evicted requests stuck in ``waiting``, or free pages below a watermark —
onto the peer with the most headroom.  Moving the youngest request
mirrors the engines' LIFO eviction order: the request the source would
sacrifice next is exactly the one worth relocating, turning a would-be
recompute restart (lost tokens, repeated prefill) into a zero-loss move.

A hysteresis margin keeps a migrated request from ping-ponging back: the
destination must be strictly healthier than the source *after* paying
for the incoming pages.
"""

from __future__ import annotations

from typing import List, Sequence

from .paged_engine import PagedLLMEngine


def migrate_request(
    src: PagedLLMEngine, dst: PagedLLMEngine, row: int
) -> bool:
    """Move one decoding request from ``src`` to ``dst``.

    Exports the request's KV pages from ``src`` (dropping its
    references there) and imports them into ``dst``; a successful move
    is lossless — the greedy continuation is token-for-token identical.
    If the destination refuses at the last moment, the ticket is
    re-imported into the source; should even that fail (with prefix
    sharing, pages the export released may have stayed alive for
    co-owners, so the free list did not necessarily regrow by
    ``n_pages``), the request falls back to a recompute-style restart
    in the source's ``waiting`` queue — decode progress is lost in that
    corner, but the request never is, and no allocator leaks either
    way.

    Parameters
    ----------
    src : PagedLLMEngine
        Source replica; ``row`` must be decoding there.
    dst : PagedLLMEngine
        Destination replica; must share ``page_size``, model config,
        and weights with ``src``.
    row : int
        The sequence row to move.

    Returns
    -------
    bool
        True when the request now runs on ``dst``; False when the
        destination is incompatible/full or the move was rolled back
        onto ``src``.
    """
    # geometry/model compatibility first: export only once the ticket is
    # guaranteed importable somewhere, so a request can never be stranded
    if (
        dst.page_size != src.page_size
        or dst.cfg.name != src.cfg.name
        or dst.max_len < src.max_len
    ):
        return False
    need = len(src.seq_pages[row])
    if not dst.can_accept_migration(need):
        return False
    ticket = src.export_request(row)
    if dst.import_request(ticket):
        return True
    # Destination raced out of capacity between check and import: put the
    # request back where it came from.  With prefix sharing the pages it
    # freed may have stayed alive for co-owners (refcount > 1 entries in
    # ticket.page_refcounts), so the rollback import can itself fail — in
    # that case fall back to a recompute-style restart on the source: the
    # decode progress is lost but the request never is.
    if src.import_request(ticket):
        src.migrations_in -= 1   # a rollback is not a real migration
        src.migrations_out -= 1
        return False
    ticket.req.out_tokens.clear()
    ticket.req.started_at = -1.0
    src.waiting.appendleft(ticket.req)
    src.preemptions += 1
    src.migrations_out -= 1
    return False


class Rebalancer:
    """Detect overloaded replicas and live-migrate requests off them.

    Parameters
    ----------
    engines : sequence of PagedLLMEngine
        The replica fleet.  Non-paged engines (no allocator) are
        ignored — slot engines cannot hand their KV over.
    low_watermark : float, optional
        A replica is *pressured* when its free-page fraction drops to
        this level or below (or when evicted requests sit in its
        ``waiting`` queue — the strongest starvation signal).
    hysteresis_pages : int, optional
        The destination must keep this many pages free *after*
        absorbing the migrated request and still be better off than the
        source, preventing ping-pong.
    max_moves_per_step : int, optional
        Migration budget per :meth:`step` call (migration gathers KV to
        host memory; bounding it keeps the decode loop responsive).
    """

    def __init__(
        self,
        engines: Sequence[PagedLLMEngine],
        low_watermark: float = 0.25,
        hysteresis_pages: int = 2,
        max_moves_per_step: int = 1,
    ) -> None:
        self.engines: List[PagedLLMEngine] = [
            e for e in engines if hasattr(e, "allocator")
        ]
        self.low_watermark = float(low_watermark)
        self.hysteresis_pages = int(hysteresis_pages)
        self.max_moves_per_step = int(max_moves_per_step)
        self.migrations = 0

    def pressured(self, eng: PagedLLMEngine) -> bool:
        """Check whether a replica needs relief.

        Parameters
        ----------
        eng : PagedLLMEngine
            The replica to inspect.

        Returns
        -------
        bool
            True when evicted requests are queued on it, or its free
            pages are at/below the low watermark of its pool.
        """
        if eng.waiting:
            return True
        total = max(1, eng.num_pages - 1)
        # dormant prefix pages are reclaimable headroom, not pressure
        free = eng.allocator.free_pages + eng.allocator.dormant_pages
        return free <= self.low_watermark * total

    def step(self) -> int:
        """Run one rebalancing pass over the fleet.

        For each pressured replica (most-starved first), try to move
        its youngest decoding request to the peer with the most free
        pages, subject to the hysteresis margin.

        Returns
        -------
        int
            Number of migrations performed this pass (also accumulated
            into :attr:`migrations`).
        """
        if len(self.engines) < 2:
            return 0
        moves = 0
        order = sorted(self.engines, key=lambda e: e.allocator.free_pages)
        for src in order:
            if moves >= self.max_moves_per_step:
                break
            if not self.pressured(src):
                continue
            row = src.youngest_active_row()
            if row is None:
                continue
            # +1 page: the request will grow on arrival; do not migrate
            # onto a destination that would immediately evict it.
            need = len(src.seq_pages[row]) + 1
            best = None
            src_free = (
                src.allocator.free_pages + src.allocator.dormant_pages
            )
            for dst in self.engines:
                if dst is src or not dst.can_accept_migration(need):
                    continue
                # dormant prefix pages are reclaimable headroom on both
                # sides of the comparison (0 without a prefix cache), so
                # a cache-warm destination is not scored as full
                after = (
                    dst.allocator.free_pages
                    + dst.allocator.dormant_pages
                    - need
                )
                if after < self.hysteresis_pages:
                    continue
                if after <= src_free:
                    continue  # destination would end up no healthier
                if best is None or after > best[0]:
                    best = (after, dst)
            if best is None:
                continue
            if migrate_request(src, best[1], row):
                moves += 1
        self.migrations += moves
        return moves
