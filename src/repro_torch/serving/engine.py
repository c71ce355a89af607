"""Request record and the measured-latency bookkeeping of the engines.

The parts of ``repro/serving/engine.py`` the paged engine needs:
:class:`Request` and :class:`LatencyProfileMixin`, which turns the
engine's measured per-step latencies into the per-token latency profile
l(b) the LLMSched scheduler reads through Eq. 2.  The slot engine
(``LLMEngine``) is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..core.calibration import LatencyProfile, measured_profile


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    stop_token: Optional[int] = None
    out_tokens: List[int] = field(default_factory=list)
    submitted_at: float = 0.0
    started_at: float = -1.0
    finished_at: float = -1.0
    on_finish: Optional[Callable[["Request"], None]] = None
    # prompt tokens actually run through prefill (cumulative across
    # recompute restarts; prefix-cache hits skip tokens and so reduce it)
    prefill_tokens: int = 0
    # admission urgency: lower drains first from a paged engine's
    # waiting queue (SLO jobs carry their scaled deadline — EDF);
    # inf (default) keeps the historical FIFO order byte-for-byte
    priority: float = math.inf
    # fleet-global first-admission stamp (set by the first engine that
    # places the request; preserved across eviction and migration).
    # Equal-priority waiting requests drain in this order — the deque
    # itself reflects *eviction* order, and a migrated-in request
    # evicted late would otherwise jump ahead of an older waiter.
    arrival_seq: int = -1

    def done(self) -> bool:
        return self.finished_at >= 0


class LatencyProfileMixin:
    """Measured l(b) bookkeeping shared by the slot and paged engines.

    ``_lat_samples`` maps batch size -> per-step latencies; the profile is
    refit only when new measurements arrived, so the returned object's
    identity is stable between measurements and schedulers can key
    calibration caches on it.
    """

    _lat_samples: Dict[int, List[float]]
    _profile_memo: Optional[Tuple[Tuple[Tuple[int, int], ...], Optional[LatencyProfile]]]

    def _init_latency(self) -> None:
        self._lat_samples = {}
        self._profile_memo = None

    def record_latency(self, batch: int, dt: float) -> None:
        self._lat_samples.setdefault(batch, []).append(dt)

    def latency_profile(self) -> Optional[LatencyProfile]:
        """Measured l(b): per-token step latency per batch size (Eq. 2).
        The first sample per batch size is dropped (first-call warm-up)."""
        fp = tuple(sorted((b, len(v)) for b, v in self._lat_samples.items()))
        if self._profile_memo is not None and self._profile_memo[0] == fp:
            return self._profile_memo[1]
        samples = {
            b: (v[1:] if len(v) > 1 else v)
            for b, v in self._lat_samples.items()
            if v
        }
        prof = measured_profile(samples) if samples else None
        self._profile_memo = (fp, prof)
        return prof
