"""Paged KV-cache continuous-batching engine (the vLLM-style executor).

Replaces the slot engine's ``max_batch`` pre-allocated dense caches with
a pooled page store + per-request block tables:

- **admission** is capacity-based: a request is admitted when a sequence
  row is free AND the page pool can hold its prompt plus one decode
  token — not when a whole ``max_len`` slot is free, so the realistic
  concurrency is bounded by *actual* KV usage, not worst-case reservation;
- **chunked prefill**: prompts are processed ``prefill_chunk`` tokens per
  engine step, interleaved with decode, so a long prompt never stalls
  every running decode stream;
- **decode** batches all running rows each step (padded to a power-of-two
  bucket, as in the JAX engine, so the kernels see the same shapes;
  padding rows write to the reserved trash page) through the paged
  decode-attention kernel;
- **preemption-by-eviction**: when decode needs a fresh page and the pool
  is dry, the youngest request is evicted — its pages freed, its request
  requeued for recompute-style restart — so older requests always run to
  completion (no livelock, matching vLLM's LIFO recompute policy);
- **shared-prefix KV reuse** (``prefix_cache=True``): finished prefills
  register their full prompt pages in a
  :class:`~repro_torch.serving.prefix_cache.RadixPrefixIndex`; admission
  longest-prefix-matches the incoming prompt, ``adopt``\\ s the cached
  pages (refcount +1, zero copies) and starts chunked prefill after
  them, so shared system prompts and repeated compound-app stages pay
  prefill once per replica instead of once per request.  Writes into a
  shared or indexed page copy-on-write first, refcount-0 prefix pages
  are evicted LRU under memory pressure (before any live request is
  preempted), and greedy decode output is token-for-token identical to
  the cacheless engine;
- **live migration** (Llumnix-style): a *decoding* request can be packed
  into a :class:`MigrationTicket` — its KV pages gathered to host memory,
  freed on the source — and resumed on a peer engine that allocates fresh
  pages and scatters the KV back in.  Because the KV content is moved
  bit-for-bit and greedy decode is deterministic, the migrated request
  continues token-for-token as if it had never moved (no recompute, no
  lost progress);
- the measured per-batch-size step latency keeps feeding the Eq. 2
  batching-aware calibration profile exactly like the slot engine.

Port of ``repro/serving/paged_engine.py``: the host logic is the JAX
engine's, line for line.  What changes is the device side: the model
runs eagerly on ``device`` (the CUDA device unless the caller passes
``device="cpu"``), and the KV pools (int8 pools with their scale pools
too) are updated in place instead of through donated jitted updaters.
"""

from __future__ import annotations

import itertools
import math
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..bridge import params_to, tensor_from_numpy, tensor_to_numpy
from ..device import DeviceLike, resolve_device
from ..kernels import ops
from ..kernels.paged_attention import (
    check_block_table_bounds,
    check_scale_pool_finite,
)
from ..models import init_params
from ..models.config import ModelConfig
from ..models.paged import (
    KV_DTYPES,
    init_paged_pools,
    paged_decode_step,
    paged_prefill_chunk,
    supports_paged,
)
from ..models.transformer import _scan_layout
from .engine import LatencyProfileMixin, Request, refuse_encoder_families
from .paged_cache import PageAllocator, TRASH_PAGE
from .prefix_cache import RadixPrefixIndex


# Fleet-global admission stamp: comparable across engines so migrated
# requests keep their original age in any waiting queue they land in.
_ARRIVAL_SEQ = itertools.count()


def _bucket(b: int, cap: int) -> int:
    """Smallest power of two >= b (capped): few distinct decode shapes."""
    out = 1
    while out < b:
        out *= 2
    return min(out, cap)


@dataclass
class MigrationTicket:
    """Self-contained handoff state of one mid-decode request.

    Produced by :meth:`PagedLLMEngine.export_request` and consumed by
    :meth:`PagedLLMEngine.import_request`.  Holding a ticket means
    holding the *only* copy of the request's KV: the source engine has
    already returned its pages to its allocator, so a dropped ticket
    loses decode progress (the request itself can still be restarted
    recompute-style).

    Attributes
    ----------
    req : Request
        The in-flight request, including tokens generated so far.
    last_token : int
        The most recent greedy token — the next decode step's input.
    length : int
        Tokens currently materialized in the KV cache (prompt + decoded).
    kv : dict
        ``{layer_pattern_pos: {"k"|"v": ndarray}}`` — per-layer KV of
        the owned pages, shape ``(n_sb, n_pages, page_size, K, hd)``,
        gathered to host memory in block-table order (bfloat16 pages
        as float32 arrays, which hold their values exactly).  On int8-KV
        engines the dict additionally carries the per-page scale pools
        (``"k_s"``/``"v_s"``, ``(n_sb, n_pages, page_size, K)``
        float32) — the int8 payload is meaningless without them.
    kv_dtype : str
        Source engine's page storage dtype (``"fp32"`` or ``"int8"``);
        source and destination must agree, else the importer would
        reinterpret the payload bytes.
    n_pages : int
        Number of pages in :attr:`kv` (and to allocate on import).
    page_size : int
        Tokens per page; source and destination must agree.
    max_len : int
        Source engine's per-sequence token limit; the destination's
        must be at least as large, else the continuation could hit the
        destination's length cutoff early and silently truncate.
    model : str
        Source engine's model-config name; replicas must match (live
        migration assumes identical weights on both ends).
    page_refcounts : list of int, optional
        Refcount of each exported page *at export time*, block-table
        order.  Entries > 1 mean the page was a shared prefix page:
        the source kept it alive for its co-owners (or its radix
        index) and the ticket carries a private copy of its content.
        ``None`` on tickets from engines without prefix caching.
    """

    req: Request
    last_token: int
    length: int
    kv: Dict[str, Dict[str, np.ndarray]]
    n_pages: int
    page_size: int
    max_len: int
    model: str
    page_refcounts: Optional[List[int]] = None
    kv_dtype: str = "fp32"


class PagedLLMEngine(LatencyProfileMixin):
    """One LLM executor with continuous batching over paged KV.

    Parameters
    ----------
    cfg : ModelConfig
        Model architecture; must satisfy :func:`supports_paged`.
    max_seqs : int, optional
        Maximum concurrent sequence rows (decode batch bound).
    max_len : int, optional
        Maximum tokens per sequence (prompt + generated).
    page_size : int, optional
        Tokens per KV page.
    num_pages : int, optional
        Physical page-pool size (page 0 is the reserved trash page).
        Defaults to no oversubscription: every row can reach
        ``max_len``.  Smaller pools trade capacity for eviction churn —
        this is the knob heterogeneous replicas differ in.
    seed : int, optional
        Parameter-init seed (ignored when ``params`` is given).
    params : dict, optional
        Pre-built model weights (a tree of tensors, copied to ``device``
        when they lie elsewhere).  Replicas that participate in live
        migration must share identical weights.
    greedy : bool, optional
        Greedy decoding (the only mode the engines currently use).
    prefill_chunk : int, optional
        Prompt tokens processed per engine step (chunked prefill).
    prefix_cache : bool, optional
        Enable shared-prefix KV reuse: a radix index over full prompt
        pages, adopted copy-free at admission, with copy-on-write on
        divergence and LRU eviction of dormant prefix pages under
        pressure.  Off by default — the cacheless engine is the
        byte-exact historical behaviour.
    kv_dtype : str, optional
        Page storage dtype: ``"fp32"`` (the model's compute dtype —
        byte-identical to the historical engine) or ``"int8"``
        (quantized pages with per-page scale pools, dequantized inside
        the int8 paged-attention kernels).  Defaults to the
        ``REPRO_KV_DTYPE`` environment variable, else ``"fp32"``.
    sanitize : bool, optional
        Run the KV-page sanitizer: the allocator mirrors every page
        transition in shadow state, every kernel-bound write and block
        table is ownership-checked (use-after-free, CoW bypass,
        aliasing), decode block tables are bounds-checked against the
        pool, and migration tickets are validated at export.
        Observation-only — clean runs are byte-identical either way.
        Defaults to the ``REPRO_SANITIZE`` environment variable.
    device : str or torch.device, optional
        Where the weights, pools and model run.  ``None`` means the
        CUDA device, and raises when there is none; pass ``"cpu"`` for
        the plain PyTorch path.  On a CUDA device the kernels are built
        (at first use) and loaded here, never inside :meth:`step`.

    Attributes
    ----------
    decode_steps, prefill_chunks : int
        Batched decode steps and prefill chunks run so far; each runs
        every layer's kernels once (the launch accounting of
        ``chip_smoke.py`` rests on them).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        max_seqs: int = 32,
        max_len: int = 256,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        seed: int = 0,
        params: Optional[Any] = None,
        greedy: bool = True,
        prefill_chunk: int = 64,
        prefix_cache: bool = False,
        sanitize: Optional[bool] = None,
        kv_dtype: Optional[str] = None,
        device: DeviceLike = None,
    ) -> None:
        refuse_encoder_families(cfg)
        if not supports_paged(cfg):
            raise ValueError(
                f"config {cfg.name!r} is not paged-KV compatible; "
                "use the slot LLMEngine"
            )
        if kv_dtype is None:
            kv_dtype = os.environ.get("REPRO_KV_DTYPE", "fp32")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}"
            )
        self.kv_dtype = kv_dtype
        self.cfg = cfg
        self.max_seqs = max_seqs
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_seq = -(-max_len // page_size)
        if num_pages is None:
            num_pages = 1 + max_seqs * self.pages_per_seq  # no oversubscription
        if num_pages - 1 < self.pages_per_seq:
            raise ValueError(
                "page pool smaller than one max_len sequence: "
                f"{num_pages - 1} < {self.pages_per_seq} pages"
            )
        self.num_pages = num_pages
        self.greedy = greedy
        self.prefill_chunk = prefill_chunk
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            ops.load_kernels()  # the one-time build stays out of step()
        self.params = (
            params_to(params, self.device) if params is not None
            else init_params(cfg, seed, self.device)
        )

        self.allocator = PageAllocator(num_pages, page_size, sanitize=sanitize)
        self._san = self.allocator.sanitizer
        self.pools = init_paged_pools(
            cfg, num_pages, page_size, kv_dtype, device=self.device
        )
        self.block_tables = np.full(
            (max_seqs, self.pages_per_seq), TRASH_PAGE, np.int32
        )
        self.lengths = np.zeros((max_seqs,), np.int64)
        self._tokens = np.zeros((max_seqs,), np.int32)
        self.seq_pages: Dict[int, List[int]] = {}
        self.free_rows: List[int] = list(range(max_seqs))
        self.active: Dict[int, Request] = {}       # row -> decoding request
        self.prefilling: Dict[int, Tuple[Request, int]] = {}  # row -> (req, pos)
        self.waiting: Deque[Request] = deque()     # evicted, awaiting re-admit
        self.preemptions = 0
        self.migrations_in = 0                     # requests imported live
        self.migrations_out = 0                    # requests exported live
        self.prefix_index: Optional[RadixPrefixIndex] = (
            RadixPrefixIndex(page_size) if prefix_cache else None
        )
        self.prefill_skipped_tokens = 0            # prompt tokens never re-run
        self.cow_copies = 0                        # copy-on-write page copies
        self.decode_steps = 0                      # batched decode steps run
        self.prefill_chunks = 0                    # prefill chunks run
        self._admit_seq = 0
        self._row_seq: Dict[int, int] = {}
        self._init_latency()

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host int array as a tensor on the engine's device (a copy)."""
        return torch.from_numpy(np.array(arr, np.int32)).to(self.device)

    # -- admission ----------------------------------------------------------
    @property
    def batch_size(self) -> int:
        """Number of requests currently held (decoding + prefilling).

        Returns
        -------
        int
            Active plus prefilling rows; excludes the evicted ``waiting``
            queue.
        """
        return len(self.active) + len(self.prefilling)

    @property
    def max_batch(self) -> int:
        """Maximum concurrent requests (interface parity with the slot engine).

        Returns
        -------
        int
            ``max_seqs``.
        """
        return self.max_seqs

    @property
    def free_token_capacity(self) -> int:
        """Tokens of KV the pool can still hold (drives placement).

        Returns
        -------
        int
            ``free_pages × page_size`` — the per-replica headroom the
            scheduler's placement score and the rebalancer both consult.
        """
        return self.allocator.free_pages * self.page_size

    @property
    def page_bytes(self) -> int:
        """Bytes of pool storage one physical page costs across all layers.

        Counts every pool leaf — K and V for each layer position and
        superblock, plus the per-page scale pools on int8 engines — so
        ``num_pages × page_bytes`` is the engine's true KV footprint.
        This is the unit equal-*byte*-budget comparisons (fig11) and
        ``ServeConfig.kv_budget_bytes`` sizing are denominated in.

        Returns
        -------
        int
            Per-page bytes (pools are shaped ``(n_sb, P, ...)``; the
            page axis is axis 1).
        """
        total = 0
        for pool in self.pools["blocks"].values():
            for arr in pool.values():
                total += arr.numel() * arr.element_size() // arr.shape[1]
        return total

    @classmethod
    def pages_for_byte_budget(
        cls,
        cfg: ModelConfig,
        page_size: int,
        budget_bytes: int,
        kv_dtype: str = "fp32",
    ) -> int:
        """Pool size (pages, incl. the trash page) fitting a byte budget.

        The equal-byte-budget counterpart of picking ``num_pages``
        directly: an int8 page costs a 1-byte payload plus 4 bytes of
        scale per (slot, kv-head), for K and for V, against the compute
        dtype's bytes per element — ``2 (hd + 4)`` against ``4 hd``
        bytes a slot and kv head in bf16 (1.88× fewer at hd = 64:
        104,448 against 196,608 bytes a token for stablelm-1.6b's 24
        layers), ``8 hd`` in float32 (3.76× fewer) — so the same budget
        buys that many times the pages.

        Parameters
        ----------
        cfg : ModelConfig
            Model architecture (KV geometry and compute dtype).
        page_size : int
            Tokens per page.
        budget_bytes : int
            Total pool storage allowed, in bytes.
        kv_dtype : str, optional
            ``"fp32"`` or ``"int8"``.

        Returns
        -------
        int
            ``budget_bytes // page_bytes`` — how many physical pages
            (trash page included) the budget holds.
        """
        _, pat, n_sb = _scan_layout(cfg)
        K, hd = cfg.n_kv_heads, cfg.hd
        if kv_dtype == "int8":
            per_token = K * (hd * 1 + 4) * 2          # int8 k+v, f32 scales
        else:
            per_token = K * hd * cfg.tdtype.itemsize * 2
        per_page = pat * n_sb * page_size * per_token
        return int(budget_bytes // per_page)

    @property
    def reclaimable_token_capacity(self) -> int:
        """Tokens of KV held by evictable (dormant) prefix pages.

        Returns
        -------
        int
            ``dormant_pages × page_size`` — headroom recoverable by LRU
            prefix eviction before any live request must be preempted.
        """
        return self.allocator.dormant_pages * self.page_size

    @property
    def prefix_cached_tokens(self) -> Optional[int]:
        """Reusable prefix tokens resident in the radix index.

        This is the per-replica prefix-hit estimate surfaced to the
        scheduler's cache-aware placement term.

        Returns
        -------
        int or None
            ``RadixPrefixIndex.cached_tokens``, or ``None`` when prefix
            caching is disabled (so fleets without caches report no
            cache signal at all and placement degenerates exactly).
        """
        if self.prefix_index is None:
            return None
        return self.prefix_index.cached_tokens

    def can_admit(self) -> bool:
        """Cheap admission pre-filter.

        Returns
        -------
        bool
            True when a row is free, at least one page is free or
            reclaimable from the prefix cache, and no evicted request
            is waiting to re-enter.  :meth:`admit` may still refuse a
            multi-page prompt — callers must handle that.
        """
        return (
            not self.waiting
            and bool(self.free_rows)
            and (
                self.allocator.can_alloc(1)
                or self.allocator.dormant_pages > 0
            )
        )

    def admit(self, req: Request) -> bool:
        """Admit a request if the page pool can hold prompt + 1 token.

        Parameters
        ----------
        req : Request
            The request to admit; its prompt must fit ``max_len``.

        Returns
        -------
        bool
            False when the pool or rows are exhausted, or when evicted
            requests are waiting (they re-enter first — FIFO fairness
            after preemption).  The caller keeps the task pending and
            retries later.
        """
        if self.waiting:  # evicted requests re-enter first
            return False
        return self._place(req)

    def _place(self, req: Request) -> bool:
        plen = len(req.prompt)
        if plen + 1 > self.pages_per_seq * self.page_size:
            raise ValueError(f"prompt of {plen} tokens exceeds max_len")
        if not self.free_rows:
            return False
        need = self.allocator.pages_for(plen + 1)
        row = self.free_rows[0]
        cached: List[int] = []
        if self.prefix_index is not None:
            cached = self.prefix_index.match(req.prompt)
            if cached:
                cached = self.allocator.adopt(cached, owner=row)
        fresh = self._alloc(need - len(cached), owner=row)
        if fresh is None:
            # refusal must leave no partial state behind
            if cached:
                self.allocator.free(cached)
            return False
        self.free_rows.pop(0)
        if req.arrival_seq < 0:  # first placement anywhere in the fleet
            req.arrival_seq = next(_ARRIVAL_SEQ)
        if self.prefix_index is not None:
            self.prefix_index.record_hit(len(cached))
        pages = cached + fresh
        self.seq_pages[row] = pages
        self.block_tables[row] = TRASH_PAGE
        self.block_tables[row, : len(pages)] = pages
        if self._san is not None:
            self._san.note_table(row, pages)
        self.lengths[row] = 0
        # skip prefill over adopted pages, but always re-run at least the
        # last prompt token: its logits seed the first decode step
        start = min(len(cached) * self.page_size, plen - 1)
        self.prefill_skipped_tokens += start
        self.prefilling[row] = (req, start)
        self._admit_seq += 1
        self._row_seq[row] = self._admit_seq
        return True

    # -- page acquisition (prefix-cache aware) -------------------------------
    def _alloc(self, n: int, owner: int) -> Optional[List[int]]:
        """Allocate ``n`` fresh pages, reclaiming LRU prefix pages first.

        Dormant (refcount-0, index-retained) pages are strictly cheaper
        to sacrifice than any live request, so pressure always drains
        the prefix cache before :meth:`_evict_for` considers victims.

        Parameters
        ----------
        n : int
            Page count (0 returns an empty list).
        owner : int
            Owner tag for the allocator.

        Returns
        -------
        list of int or None
            Fresh pages, or ``None`` when even reclaiming cannot
            satisfy the request.
        """
        if n <= 0:
            return []
        pages = self.allocator.alloc(n, owner=owner)
        if pages is None and self._reclaim_prefix(n):
            pages = self.allocator.alloc(n, owner=owner)
        return pages

    def _reclaim_prefix(self, need_free: int) -> bool:
        """Evict LRU dormant prefix pages until ``need_free`` are free.

        Parameters
        ----------
        need_free : int
            Target free-list size.

        Returns
        -------
        bool
            True when any page was reclaimed.
        """
        if self.prefix_index is None:
            return False
        want = need_free - self.allocator.free_pages
        if want <= 0:
            return False
        evicted = self.prefix_index.evict(
            want, lambda p: self.allocator.refcount(p) == 0
        )
        if not evicted:
            return False
        self.allocator.unmark_indexed(evicted)
        return True

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one physical page's K/V across every layer pool.

        One indexed in-place copy per pool leaf (the scale pools of int8
        engines included), covering every superblock at once — O(page)
        work, never an O(pool) rebuild.
        """
        for pool in self.pools["blocks"].values():
            for arr in pool.values():
                arr[:, dst] = arr[:, src]
        if self._san is not None and self.kv_dtype == "int8":
            self._san.note_scale_copy(src, dst)
        self.cow_copies += 1

    def _ensure_exclusive(self, row: int, pi: int) -> bool:
        """Copy-on-write: make ``seq_pages[row][pi]`` safe to write.

        A page is writable only when this row is its sole owner AND it
        is not index-registered (an indexed page's content must keep
        matching its token-block key).  Otherwise a fresh page is
        allocated — evicting younger rows if the pool is dry — the
        content copied, and this row's reference moved over.

        Parameters
        ----------
        row : int
            The writing sequence row.
        pi : int
            Logical page index within the row's block table.

        Returns
        -------
        bool
            False when ``row`` itself had to be evicted to find room.
        """
        pages = self.seq_pages[row]
        if pi >= len(pages):
            return True                     # not materialized yet (grow's job)
        p = pages[pi]
        a = self.allocator
        if a.refcount(p) == 1 and not a.is_indexed(p):
            return True
        fresh = self._alloc(1, owner=row)
        while fresh is None:
            if not self._evict_for(row):
                return False
            fresh = self._alloc(1, owner=row)
        q = fresh[0]
        self._copy_page(p, q)
        pages[pi] = q
        self.block_tables[row, pi] = q
        if self._san is not None:
            self._san.note_table(row, pages)
        a.free([p])                          # drop our ref on the shared copy
        return True

    # -- eviction -----------------------------------------------------------
    def _evict_row(self, row: int) -> None:
        req = self.active.pop(row, None)
        if req is None:
            req, _ = self.prefilling.pop(row)
        # recompute-style restart: generated tokens are discarded
        req.out_tokens.clear()
        req.started_at = -1.0
        self.waiting.appendleft(req)
        self._release_row(row)
        self.preemptions += 1

    def _evict_for(self, row: int) -> bool:
        """Make room for ``row``: evict the youngest row *younger than*
        ``row``; if none exists, ``row`` itself is evicted (it is the
        youngest).  Strict age order means the oldest request always
        makes progress — mutual-eviction livelock is impossible.
        Returns False when ``row`` itself was evicted."""
        younger = [
            r for r in self._row_seq
            if r != row and self._row_seq[r] > self._row_seq[row]
        ]
        victim = max(younger, key=lambda r: self._row_seq[r]) if younger else row
        self._evict_row(victim)
        return victim != row

    def _release_row(self, row: int) -> None:
        if self._san is not None:
            self._san.drop_table(row)
        self.allocator.free(self.seq_pages.pop(row))
        self.block_tables[row] = TRASH_PAGE
        self.lengths[row] = 0
        del self._row_seq[row]
        self.free_rows.append(row)

    def _grow(self, row: int) -> bool:
        """Ensure the page holding position ``lengths[row]`` exists.
        Returns False when ``row`` itself had to be evicted (it was the
        youngest and the pool is dry); a lone row can always grow
        because the pool holds at least one full max_len sequence."""
        pi = int(self.lengths[row]) // self.page_size
        while pi >= len(self.seq_pages[row]):
            pages = self._alloc(1, owner=row)
            if pages is None:
                if not self._evict_for(row):
                    return False
                continue
            self.seq_pages[row].append(pages[0])
            self.block_tables[row, len(self.seq_pages[row]) - 1] = pages[0]
            if self._san is not None:
                self._san.note_table(row, self.seq_pages[row])
        # the write target must be exclusively ours (a page-aligned shared
        # prompt can leave the boundary page adopted from the index)
        return self._ensure_exclusive(row, pi)

    # -- prefill ------------------------------------------------------------
    def _run_prefill(self, budget: int) -> None:
        """Advance prompt processing by up to ``budget`` tokens.

        A row's chunk is never truncated by leftover budget, and a row
        resuming after a prefix-cache skip realigns to the chunk grid
        with one short first chunk — so ``past`` offsets stay on the
        same boundaries the cacheless engine uses (multiples of
        ``prefill_chunk``, plus one page-aligned resume point per
        distinct cached-prefix length).  That makes the final chunk of
        a partially-cached prompt bit-identical to the cacheless
        engine's final chunk, which is what the token-for-token
        differential guarantee rests on.
        """
        ps = self.page_size
        for row in sorted(self.prefilling, key=lambda r: self._row_seq[r]):
            if budget <= 0:
                break
            if row not in self.prefilling:
                continue  # evicted while an earlier row made room (CoW)
            req, pos = self.prefilling[row]
            plen = len(req.prompt)
            chunk = min(
                self.prefill_chunk - pos % self.prefill_chunk, plen - pos
            )
            if chunk > budget:
                break
            # copy-on-write before touching any shared/indexed page the
            # chunk will scatter into (adopted page-aligned prefixes)
            ok = True
            for pi in range(pos // ps, (pos + chunk - 1) // ps + 1):
                if not self._ensure_exclusive(row, pi):
                    ok = False
                    break
            if not ok:
                continue  # this row was evicted to make room; retry later
            if self._san is not None:
                for pi in range(pos // ps, (pos + chunk - 1) // ps + 1):
                    self._san.note_write(
                        row, self.seq_pages[row][pi],
                        quantized=self.kv_dtype == "int8",
                    )
            toks = self._to_device(np.asarray([req.prompt[pos : pos + chunk]]))
            bt = self._to_device(self.block_tables[row])
            logits, self.pools = paged_prefill_chunk(
                self.params, self.cfg, self.pools, toks, bt, pos
            )
            self.prefill_chunks += 1
            req.prefill_tokens += chunk
            pos += chunk
            budget -= chunk
            if pos == plen:
                first = int(np.argmax(tensor_to_numpy(logits[0, -1])))
                req.out_tokens.append(first)
                req.started_at = time.perf_counter()
                self._tokens[row] = first
                self.lengths[row] = plen
                del self.prefilling[row]
                self.active[row] = req
                self._register_prefix(row, req)
            else:
                self.prefilling[row] = (req, pos)

    def _register_prefix(self, row: int, req: Request) -> None:
        """Insert a finished prefill's full prompt pages into the index.

        Only pages fully covered by prompt tokens are registered —
        their content is immutable from here on (decode writes land in
        later pages) — and only pages not already present under the
        same token blocks (first writer wins).

        Parameters
        ----------
        row : int
            The row whose prefill just completed.
        req : Request
            Its request (source of the prompt tokens).
        """
        if self.prefix_index is None:
            return
        n_full = len(req.prompt) // self.page_size
        if n_full == 0:
            return
        fresh = self.prefix_index.insert(
            req.prompt, self.seq_pages[row][:n_full]
        )
        if fresh:
            self.allocator.mark_indexed(fresh)

    # -- decode loop --------------------------------------------------------
    def step(self) -> List[Request]:
        """Run one engine iteration.

        Re-admits evicted requests from ``waiting``, advances chunked
        prefill by one chunk budget, grows pages (evicting youngest-first
        when the pool is dry), then decodes one token for every running
        request through the paged-attention kernel.

        Returns
        -------
        list of Request
            Requests that finished this step (budget reached, stop
            token, or ``max_len``); their pages are already freed and
            ``on_finish`` callbacks already fired.
        """
        # deadline-aware re-admission: drain the waiting queue lowest
        # priority-value first, ties broken by *fleet arrival order*
        # (``arrival_seq``), NOT deque position — the deque reflects
        # eviction order (``appendleft``), and after a live migration a
        # younger-arrival request evicted late sits at the head, so a
        # positional tie-break would re-admit it ahead of an older
        # equal-deadline waiter.  With no SLOs anywhere (all priorities
        # inf) single-engine eviction preserves arrival order, so this
        # still degenerates to the historical FIFO ``popleft``
        # byte-for-byte.  Head-of-line blocking on a failed place is
        # intentional: admitting a lower-priority request past a stuck
        # urgent one would hand it the very pages the urgent one needs.
        while self.waiting and self.free_rows:
            req = min(
                self.waiting,
                key=lambda r: (
                    getattr(r, "priority", math.inf),
                    getattr(r, "arrival_seq", -1),
                ),
            )
            if not self._place(req):
                break
            self.waiting.remove(req)
            if self._san is not None:
                self._san.check_edf_drain(
                    getattr(req, "priority", math.inf),
                    [getattr(r, "priority", math.inf) for r in self.waiting],
                )
        if self.prefilling:
            self._run_prefill(self.prefill_chunk)
        if not self.active:
            return []

        # page growth (may evict); iterate oldest-first so eviction of a
        # younger row cannot starve an older one
        for row in sorted(self.active, key=lambda r: self._row_seq[r]):
            if row in self.active:  # may have been evicted by a prior grow
                self._grow(row)
        if not self.active:
            return []

        rows = sorted(self.active, key=lambda r: self._row_seq[r])
        b = len(rows)
        bucket = _bucket(b, self.max_seqs)
        idx = rows + [rows[0]] * (bucket - b)   # pad shape; padding masked below
        toks = np.asarray(self._tokens[idx], np.int32)
        bt = np.asarray(self.block_tables[idx], np.int32)
        lens = np.asarray(self.lengths[idx], np.int32)
        # padding rows: length 0, trash block table — writes land in page 0
        if bucket > b:
            toks[b:] = 0
            bt[b:] = TRASH_PAGE
            lens[b:] = 0

        if self._san is not None:
            # the incoming token writes at position lengths[row]: that
            # page must be exclusively owned, and the whole table must
            # stay inside the pool before the kernel reads from it
            check_block_table_bounds(
                bt, lens, self.num_pages, self.page_size, TRASH_PAGE
            )
            if self.kv_dtype == "int8":
                # spot-check one layer's scale pools: a NaN/non-positive
                # scale would multiply *valid* history, not masked slots
                pool0 = self.pools["blocks"]["0"]
                check_scale_pool_finite(
                    tensor_to_numpy(pool0["k_s"][0]),
                    tensor_to_numpy(pool0["v_s"][0]),
                    bt, lens, self.page_size,
                )
            for row in rows:
                pi = int(self.lengths[row]) // self.page_size
                self._san.note_write(
                    row, self.seq_pages[row][pi],
                    quantized=self.kv_dtype == "int8",
                )

        t0 = time.perf_counter()
        logits, self.pools = paged_decode_step(
            self.params, self.cfg, self.pools, self._to_device(toks),
            self._to_device(bt), self._to_device(lens),
        )
        # the clock is read once the logits are on the host (.cpu() waits
        # for the device), so l(b) covers the step's work, not its launches
        logits = tensor_to_numpy(logits)
        self.record_latency(b, time.perf_counter() - t0)
        self.decode_steps += 1

        finished: List[Request] = []
        for i, row in enumerate(rows):
            req = self.active[row]
            nxt = int(np.argmax(logits[i]))
            req.out_tokens.append(nxt)
            self._tokens[row] = nxt
            self.lengths[row] += 1
            limit = (
                len(req.out_tokens) >= req.max_new_tokens
                or (req.stop_token is not None and nxt == req.stop_token)
                or int(self.lengths[row]) >= self.max_len - 2
            )
            if limit:
                req.finished_at = time.perf_counter()
                finished.append(req)
                del self.active[row]
                self._release_row(row)
                if req.on_finish:
                    req.on_finish(req)
        return finished

    # -- live migration -----------------------------------------------------
    def youngest_active_row(self) -> Optional[int]:
        """Return the most recently admitted *decoding* row.

        The youngest row is the canonical migration candidate: it is the
        row the LIFO eviction policy would sacrifice next, so moving it
        to a peer replica converts a would-be recompute restart into a
        lossless handoff.

        Returns
        -------
        int or None
            Row index, or ``None`` when nothing is decoding.
        """
        if not self.active:
            return None
        return max(self.active, key=lambda r: self._row_seq[r])

    def can_accept_migration(self, n_pages: int) -> bool:
        """Check whether an incoming ticket of ``n_pages`` pages fits.

        Parameters
        ----------
        n_pages : int
            Page count of the candidate :class:`MigrationTicket`.

        Returns
        -------
        bool
            True when a sequence row is free, the pool can hand out
            ``n_pages`` at once (counting LRU-reclaimable dormant
            prefix pages), and the page count fits this engine's
            ``pages_per_seq`` geometry.
        """
        return (
            bool(self.free_rows)
            and n_pages <= self.pages_per_seq
            and n_pages
            <= self.allocator.free_pages + self.allocator.dormant_pages
        )

    def export_request(self, row: int) -> MigrationTicket:
        """Detach a decoding request: gather its KV, free its pages.

        The half of the Llumnix-style handoff that runs on the source
        replica.  After this returns, the engine holds no trace of the
        request — its pages are back in the allocator's free list (leak
        checked) and its row is reusable.  The caller owns the ticket
        and must either :meth:`import_request` it somewhere or accept
        losing the decode progress.

        Parameters
        ----------
        row : int
            An *active* (decoding) row.  Prefilling rows are not
            migratable — their KV is cheaper to recompute than to move.

        Returns
        -------
        MigrationTicket
            Host-side copy of the request state and KV pages.

        Raises
        ------
        ValueError
            If ``row`` is not currently decoding.
        """
        if row not in self.active:
            raise ValueError(f"row {row} is not decoding; cannot export")
        req = self.active.pop(row)
        pages = list(self.seq_pages[row])
        idx = self._to_device(np.asarray(pages)).long()
        # every pool leaf travels: K/V payload (bf16 pages as exact float32
        # arrays, int8 pages as int8) plus, on int8 engines, the per-page
        # scale pools the payload dequantizes through
        kv: Dict[str, Dict[str, np.ndarray]] = {
            j: {
                name: tensor_to_numpy(arr[:, idx])
                for name, arr in pool.items()
            }
            for j, pool in self.pools["blocks"].items()
        }
        ticket = MigrationTicket(
            req=req,
            last_token=int(self._tokens[row]),
            length=int(self.lengths[row]),
            kv=kv,
            n_pages=len(pages),
            page_size=self.page_size,
            max_len=self.max_len,
            model=self.cfg.name,
            # shared-page accounting: refcounts at export time (a value
            # > 1 means the page stays alive on the source for its
            # co-owners / prefix index; the ticket carries a copy)
            page_refcounts=[self.allocator.refcount(p) for p in pages],
            kv_dtype=self.kv_dtype,
        )
        if self._san is not None:
            self._san.validate_ticket(pages, ticket.page_refcounts)
            if self.kv_dtype == "int8":
                self._san.validate_scale_export(pages)
        self._release_row(row)
        self.migrations_out += 1
        return ticket

    def import_request(self, ticket: MigrationTicket) -> bool:
        """Resume an exported request on this replica.

        Allocates ``ticket.n_pages`` fresh pages from this engine's
        allocator, scatters the ticket's KV into the local pools at the
        new physical ids, rebuilds the block table, and resumes decode
        from ``ticket.last_token``.  Under greedy decoding with shared
        weights the continuation is token-for-token identical to an
        unmigrated run.

        Parameters
        ----------
        ticket : MigrationTicket
            State produced by a peer's :meth:`export_request`.  Must
            match this engine's ``page_size`` and model config.

        Returns
        -------
        bool
            False when no row/pages are available (the ticket remains
            valid — callers typically re-import into the source).

        Raises
        ------
        ValueError
            On a page-size, model, or max_len mismatch (an incompatible
            destination would corrupt the KV layout or silently
            truncate the continuation at its shorter length cutoff).
        """
        if ticket.page_size != self.page_size:
            raise ValueError(
                f"page_size mismatch: ticket {ticket.page_size} "
                f"vs engine {self.page_size}"
            )
        if ticket.model != self.cfg.name:
            raise ValueError(
                f"model mismatch: ticket {ticket.model!r} vs {self.cfg.name!r}"
            )
        if ticket.kv_dtype != self.kv_dtype:
            raise ValueError(
                f"kv_dtype mismatch: ticket {ticket.kv_dtype!r} vs engine "
                f"{self.kv_dtype!r} — the page payload bytes are not "
                "interchangeable"
            )
        if ticket.max_len > self.max_len:
            raise ValueError(
                f"max_len mismatch: ticket from a max_len={ticket.max_len} "
                f"engine cannot resume on max_len={self.max_len} without "
                "risking early truncation"
            )
        if ticket.n_pages > self.pages_per_seq or not self.free_rows:
            return False
        row = self.free_rows[0]
        pages = self._alloc(ticket.n_pages, owner=row)
        if pages is None:
            return False
        self.free_rows.pop(0)
        idx = self._to_device(np.asarray(pages)).long()
        for j, pool in self.pools["blocks"].items():
            for name, arr in pool.items():
                arr[:, idx] = tensor_from_numpy(
                    ticket.kv[j][name], self.device, arr.dtype
                )
        self.seq_pages[row] = pages
        self.block_tables[row] = TRASH_PAGE
        self.block_tables[row, : len(pages)] = pages
        if self._san is not None:
            self._san.note_table(row, pages)
            for p in pages:  # ticket KV scatters into every fresh page
                self._san.note_write(
                    row, p, quantized=self.kv_dtype == "int8"
                )
        self.lengths[row] = ticket.length
        self._tokens[row] = ticket.last_token
        self.active[row] = ticket.req
        self._admit_seq += 1
        self._row_seq[row] = self._admit_seq
        self.migrations_in += 1
        # the imported KV's prompt pages are as reusable as a local
        # prefill's: register them so peers of this replica hit too
        self._register_prefix(row, ticket.req)
        return True

    # -- maintenance --------------------------------------------------------
    def defrag(self) -> int:
        """Compact content-bearing pages onto the lowest physical ids.

        Permutes the KV pools and patches every live block table *and*
        the prefix index with the allocator's old→new mapping (dormant
        cached pages move too — their KV stays reusable), improving
        DMA locality after heavy admission/eviction churn.

        Returns
        -------
        int
            Number of pages moved (0 when already compact).
        """
        mapping = self.allocator.defrag()
        if not mapping:
            return 0
        perm = np.arange(self.num_pages)
        for old, new in mapping.items():
            perm[new] = old
        perm_t = self._to_device(perm).long()
        for pool in self.pools["blocks"].values():
            for arr in pool.values():
                arr.copy_(arr.index_select(1, perm_t))
        for row, pages in self.seq_pages.items():
            self.seq_pages[row] = [mapping.get(p, p) for p in pages]
            self.block_tables[row] = TRASH_PAGE
            self.block_tables[row, : len(self.seq_pages[row])] = self.seq_pages[row]
        if self.prefix_index is not None:
            self.prefix_index.remap(mapping)
        return len(mapping)
