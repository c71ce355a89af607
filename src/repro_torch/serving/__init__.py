"""Serving runtime of the port: the paged continuous-batching engine.

:class:`PagedLLMEngine` — paged KV pool + block tables (vLLM-style),
capacity-based admission, chunked prefill, preemption-by-eviction,
shared-prefix reuse and live migration through :class:`MigrationTicket`.
The slot engine, the fleet and the rebalancer are not ported yet.
"""

from .engine import Request
from .paged_cache import PageAllocator, TRASH_PAGE
from .prefix_cache import RadixPrefixIndex
from .paged_engine import MigrationTicket, PagedLLMEngine

__all__ = [
    "PagedLLMEngine", "Request", "PageAllocator", "TRASH_PAGE",
    "RadixPrefixIndex", "MigrationTicket",
]
