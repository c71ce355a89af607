"""Batching-aware duration calibration (paper §IV-B, Eq. 2).

The duration of an LLM task depends on the number of concurrently batched
requests on its executor.  The paper profiles the average per-token decode
latency ``l(b)`` at each batch size b and rescales a duration estimate
``d_r`` recorded at batch size ``b_r`` to a target batch size ``b_t``:

    d_t = d_r * l(b_t) / l(b_r)                                  (Eq. 2)

The paged engine records its own step latencies on the device it runs on
and fits l(b) from them (``measured_profile``).  ``roofline_profile`` is
the JAX package's analytic l(b) with the same arithmetic, for one H100:
its default memory rate is the card's (:data:`H100_HBM_BW`), and it has
no default step overhead (the JAX package's 2e-5 s was set for its
TPU): the caller gives one, measured on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

import numpy as np

#: HBM3 rate of one NVIDIA H100 80GB HBM3 (SXM, 700 W power limit), bytes/s,
#: from its data sheet: the port's one copy of this figure (the dry run's
#: roofline terms and ``chip_smoke.py``'s bounds read it from here)
H100_HBM_BW = 3.35e12


@dataclass
class LatencyProfile:
    """Per-token decode latency l(b) for batch sizes 1..max_batch."""

    batch_sizes: np.ndarray
    latency: np.ndarray  # seconds per generated token, per request

    def __post_init__(self) -> None:
        self.batch_sizes = np.asarray(self.batch_sizes, dtype=np.int64)
        self.latency = np.asarray(self.latency, dtype=np.float64)
        order = np.argsort(self.batch_sizes)
        self.batch_sizes = self.batch_sizes[order]
        self.latency = self.latency[order]

    def l(self, b: int) -> float:
        """l(b) with linear interpolation / edge clamping."""
        b = max(1, int(b))
        return float(np.interp(b, self.batch_sizes, self.latency))

    def calibrate(self, d_r: float, b_r: int, b_t: int) -> float:
        """Eq. (2): rescale duration d_r observed at batch b_r to batch b_t."""
        lr = self.l(b_r)
        if lr <= 0:
            return d_r
        return d_r * self.l(b_t) / lr


def roofline_profile(
    weight_bytes: float,
    kv_bytes_per_request: float,
    hbm_bw: float = H100_HBM_BW,
    max_batch: int = 256,
    step_overhead_s: Optional[float] = None,
) -> LatencyProfile:
    """Analytic l(b) for a memory-bound decode step on one H100.

    One decode step streams all weights once plus each request's KV cache;
    per-token latency for a single request in a batch of b is the step time
    (weights amortized over the batch, KV not amortized).

    ``step_overhead_s`` (seconds a step spends beyond its bytes) has no
    default: give the one measured on the card (``chip_smoke.py``'s
    ``dryrun`` phase prints it beside its own l(b)).
    """
    if step_overhead_s is None:
        raise ValueError("roofline_profile needs step_overhead_s, measured on the card")
    bs = np.arange(1, max_batch + 1)
    step_time = (weight_bytes + bs * kv_bytes_per_request) / hbm_bw + step_overhead_s
    return LatencyProfile(batch_sizes=bs, latency=step_time)


def measured_profile(samples: Mapping[int, Sequence[float]]) -> LatencyProfile:
    """Build a profile from measured {batch_size: [per-token latencies]}."""
    bs = sorted(samples)
    lat = [float(np.mean(samples[b])) for b in bs]
    return LatencyProfile(batch_sizes=np.array(bs), latency=np.array(lat))
