"""Serving runtime of the port: continuous-batching engines + compound-job testbed.

Two interchangeable executors:
- :class:`LLMEngine` — slot-based (dense per-slot KV, max_batch slots);
- :class:`PagedLLMEngine` — paged KV pool + block tables (vLLM-style),
  capacity-based admission, chunked prefill, preemption-by-eviction,
  shared-prefix reuse and live migration through :class:`MigrationTicket`.

Multi-replica serving: :class:`ServingCluster` drives N replicas,
honouring the scheduler's per-task placement hints, and — when
``migrate=True`` — runs a :class:`Rebalancer` that live-migrates
decoding requests off KV-starved replicas onto peers with headroom.
"""

from .engine import LLMEngine, Request
from .paged_cache import PageAllocator, TRASH_PAGE
from .prefix_cache import RadixPrefixIndex
from .paged_engine import MigrationTicket, PagedLLMEngine
from .config import ServeConfig, build_engines
from .migration import Rebalancer, migrate_request
from .cluster import ServingCluster, TestbedResult

__all__ = [
    "LLMEngine", "PagedLLMEngine", "Request", "PageAllocator", "TRASH_PAGE",
    "RadixPrefixIndex", "MigrationTicket", "Rebalancer", "migrate_request",
    "ServeConfig", "ServingCluster", "TestbedResult", "build_engines",
]
