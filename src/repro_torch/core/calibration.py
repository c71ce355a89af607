"""Batching-aware duration calibration (paper §IV-B, Eq. 2).

The duration of an LLM task depends on the number of concurrently batched
requests on its executor.  The paper profiles the average per-token decode
latency ``l(b)`` at each batch size b and rescales a duration estimate
``d_r`` recorded at batch size ``b_r`` to a target batch size ``b_t``:

    d_t = d_r * l(b_t) / l(b_r)                                  (Eq. 2)

The port keeps only the measured profile: the paged engine records its
own step latencies on the device it runs on and fits l(b) from them.
(The JAX package's analytic ``roofline_profile`` defaults to a TPU
memory rate and is not copied.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np


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


def measured_profile(samples: Mapping[int, Sequence[float]]) -> LatencyProfile:
    """Build a profile from measured {batch_size: [per-token latencies]}."""
    bs = sorted(samples)
    lat = [float(np.mean(samples[b])) for b in bs]
    return LatencyProfile(batch_sizes=np.array(bs), latency=np.array(lat))
