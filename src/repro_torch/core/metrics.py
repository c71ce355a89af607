"""Unified run-metrics schema shared by the simulator and the testbed.

Before the SLO PR the two runtimes kept hand-synchronized result shapes
(``SimResult`` in :mod:`repro_torch.sim.simulator`, ``TestbedResult`` in
:mod:`repro_torch.serving.cluster`) whose fields drifted one kwarg at a time.
:class:`RunMetrics` is the single schema both now return (the old names
remain as aliases), so the parity canaries and the fig7/fig8/fig9
benchmark writers consume one type instead of two.

SLO accounting: when jobs carry :class:`repro_torch.core.dag.SLO` objectives,
the runtimes record per-job tier/deadline/attainment and
:meth:`RunMetrics.goodput` reports the paper-style *goodput* —
the fraction of finished jobs that met their deadline — overall and per
tier.  SLO-less runs leave the SLO fields empty and ``goodput`` returns
``None``, keeping pre-SLO artifacts byte-compatible.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class RunMetrics:
    """Aggregate outcome of one simulator or testbed run.

    Attributes
    ----------
    jcts : list of float
        Per-job completion times (finish − arrival) in runtime seconds.
    jct_by_job : dict
        ``job_id → JCT`` for cross-run rank comparisons.
    sched_overhead_s : list of float
        Seconds spent inside ``scheduler.schedule`` per round.
    makespan : float
        Total runtime seconds from start to last completion.
    preemptions : int
        Evictions/requeues (KV overflow, executor failure).
    reissues : int
        Speculative straggler re-issues (simulator only).
    migrations : int
        Live cross-replica LLM-task/KV moves.
    tokens_generated : int
        Decoded tokens across all engines (testbed only).
    prefill_tokens : float
        Prompt tokens actually run through prefill.
    prefill_saved_tokens : float
        Prompt tokens skipped via shared-prefix KV reuse.
    prefill_by_job : dict
        ``job_id → prefilled tokens`` (sim↔testbed cache parity).
    tier_by_job : dict
        ``job_id → SLO tier`` for jobs that carried an SLO.
    deadline_by_job : dict
        ``job_id → absolute deadline`` (workload clock).
    slo_met_by_job : dict
        ``job_id → bool`` — deadline attainment of finished SLO jobs.
    retractions : int
        Queued-but-undispatched scheduling decisions revisited after an
        evidence-version bump (SLO-aware schedulers only).
    cost_by_job : dict
        ``job_id → accumulated serving cost`` in cost units (per-token
        tier price × generated tokens, summed over every completed LLM
        attempt *including* attempts a quality gate rejected — wasted
        spend is real spend).  Empty when the fleet has no tier table.
    quality_by_job : dict
        ``job_id → bool`` — whether every gated LLM stage of the job
        was ultimately accepted by the quality gate (a stage that
        exhausts the cascade at the top tier and still fails marks the
        job ``False``).  Empty when no gate ran.
    escalations : int
        Cascade retries: gate-rejected stages re-enqueued one model
        tier up.
    """

    jcts: List[float] = field(default_factory=list)
    jct_by_job: Dict[int, float] = field(default_factory=dict)
    sched_overhead_s: List[float] = field(default_factory=list)
    makespan: float = 0.0
    preemptions: int = 0
    reissues: int = 0
    migrations: int = 0
    tokens_generated: int = 0
    prefill_tokens: float = 0.0
    prefill_saved_tokens: float = 0.0
    prefill_by_job: Dict[int, float] = field(default_factory=dict)
    # --- SLO / deadline bookkeeping (empty for SLO-less runs) ---------
    tier_by_job: Dict[int, str] = field(default_factory=dict)
    deadline_by_job: Dict[int, float] = field(default_factory=dict)
    slo_met_by_job: Dict[int, bool] = field(default_factory=dict)
    retractions: int = 0
    # --- cost / cascade bookkeeping (empty for single-tier runs) ------
    cost_by_job: Dict[int, float] = field(default_factory=dict)
    quality_by_job: Dict[int, bool] = field(default_factory=dict)
    escalations: int = 0

    @property
    def avg_jct(self) -> float:
        """Mean job completion time in seconds (0.0 when empty)."""
        return float(np.mean(self.jcts)) if self.jcts else 0.0

    @property
    def p95_jct(self) -> float:
        """95th-percentile job completion time in seconds."""
        return float(np.percentile(self.jcts, 95)) if self.jcts else 0.0

    @property
    def avg_overhead_ms(self) -> float:
        """Mean scheduler invocation latency in milliseconds."""
        return (
            1e3 * float(np.mean(self.sched_overhead_s))
            if self.sched_overhead_s
            else 0.0
        )

    def goodput(self, tier: Optional[str] = None) -> Optional[float]:
        """SLO attainment: fraction of SLO jobs that met their deadline.

        Parameters
        ----------
        tier : str, optional
            Restrict to one tier (``interactive`` / ``batch`` /
            ``best_effort``); ``None`` aggregates every SLO job.

        Returns
        -------
        float or None
            Attainment in [0, 1], or ``None`` when no (matching) job
            carried an SLO — distinguishing "no SLOs" from "all missed".
        """
        ids = [
            j
            for j in self.slo_met_by_job
            if tier is None or self.tier_by_job.get(j) == tier
        ]
        if not ids:
            return None
        return float(np.mean([self.slo_met_by_job[j] for j in ids]))

    def goodput_by_tier(self) -> Dict[str, float]:
        """Per-tier SLO attainment over the tiers present in this run.

        Every tier that appears in ``tier_by_job`` appears in the
        result.  A tier whose jobs all went unfinished (preempted,
        demoted, still queued at cutoff) has attained nothing —
        it reports ``0.0`` rather than being silently omitted, so
        benchmark aggregations never mistake "all missed" for
        "tier absent".
        """
        tiers = sorted(set(self.tier_by_job.values()))
        out: Dict[str, float] = {}
        for t in tiers:
            g = self.goodput(t)
            out[t] = 0.0 if g is None else g
        return out

    @property
    def total_cost(self) -> float:
        """Summed serving cost across jobs (0.0 without a tier table)."""
        return float(sum(self.cost_by_job.values()))

    def cost_efficiency(self) -> Optional[float]:
        """Quality-accepted finished jobs per unit of serving cost.

        The numerator counts finished jobs whose every gated stage was
        ultimately accepted (all finished jobs when no gate ran), so a
        pool that is merely cheap cannot win by emitting rejected
        output; the denominator is :attr:`total_cost`.

        Returns
        -------
        float or None
            Accepted jobs per cost unit, or ``None`` when the run
            recorded no cost (no tier table — efficiency undefined).
        """
        total = self.total_cost
        if total <= 0.0:
            return None
        if self.quality_by_job:
            ok = sum(
                1
                for j in self.jct_by_job
                if self.quality_by_job.get(j, True)
            )
        else:
            ok = len(self.jct_by_job)
        return ok / total
