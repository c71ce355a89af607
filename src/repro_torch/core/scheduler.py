"""Uncertainty-aware scheduler — Algorithm 1 of the paper (§IV-D).

Schedulers are shared between the discrete-event simulator (`repro_torch.sim`)
and the real serving runtime (`repro_torch.serving`): both call
:meth:`Scheduler.schedule` with the current unfinished jobs and a
:class:`ClusterView`, and dispatch tasks greedily from the returned
preference lists (``T_r`` for regular executors, ``T_l`` for LLM
executors) onto free capacity.

Since the multi-replica PR, :class:`ClusterView` additionally carries
per-replica KV headroom (``llm_free_tokens``) and :class:`Decision`
carries a *placement* map assigning each LLM task to a specific engine
replica.  :class:`LLMSched` fills the map with an uncertainty- and
fragmentation-aware score (high-entropy jobs land where KV headroom is
largest); runtimes that ignore the map — and schedulers that never fill
it — keep the historical least-loaded behaviour.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .calibration import LatencyProfile
from .dag import SLO_TIERS, Job, Stage, StageType, Task
from .profiler import ProfileStore

# Key type of Decision.placement: (job_id, stage_name, task index).
TaskKey = Tuple[int, str, int]


def task_key(task: Task) -> TaskKey:
    """Return the stable identity of ``task`` used by placement maps.

    Parameters
    ----------
    task : Task
        Any runtime task.

    Returns
    -------
    tuple of (int, str, int)
        ``(job_id, stage_name, index)`` — unique within a workload and
        stable across scheduling rounds (unlike ``id(task)``).
    """
    return (task.job_id, task.stage_name, task.index)


@dataclass
class ClusterView:
    """What the scheduler may observe about the cluster.

    Attributes
    ----------
    now : float
        Current (simulated or wall-clock) time in seconds.
    free_regular : int
        Number of idle regular-executor slots.
    llm_loads : list of (int, int)
        Per-LLM-replica ``(running batch size, max batch size)``.
    latency_profile : LatencyProfile, optional
        Measured ``l(b)`` per-token decode latency, for Eq. 2 batching
        calibration.  ``None`` before any measurement exists.
    llm_free_tokens : list of int, optional
        Per-LLM-replica free KV capacity in *tokens* (free pages ×
        page size for paged engines).  ``None`` when the runtime has no
        paged KV accounting (e.g. the simulator or the slot engine);
        placement then falls back to pure load balancing.
    llm_prefix_hit_tokens : list of int, optional
        Per-LLM-replica estimate of reusable prefix KV in *tokens*
        (the radix index's resident cached tokens for paged engines
        with prefix caching; the modeled shared-prompt residency in the
        simulator).  A task landing on a replica with more resident
        prefix tokens is more likely to skip prefill work.  ``None``
        when no replica runs a prefix cache — the placement score then
        degenerates exactly to its cache-blind form (an all-zero list
        degenerates identically).
    llm_model_costs : list of float, optional
        Per-LLM-replica serving cost in *cost units per generated
        token* (the model-zoo tier table,
        :func:`repro_torch.models.zoo.cost_per_token`).  Present only when
        every replica's model resolves to a known tier; a homogeneous
        fleet (all costs equal) contributes nothing to the placement
        score, so cost-blind trajectories are byte-identical.
    """

    now: float
    free_regular: int
    # per-LLM-executor (running batch size, max batch size)
    llm_loads: List[Tuple[int, int]]
    latency_profile: Optional[LatencyProfile] = None
    # per-LLM-executor free KV capacity in tokens (None: not paged)
    llm_free_tokens: Optional[List[int]] = None
    # per-LLM-executor resident reusable-prefix tokens (None: no cache)
    llm_prefix_hit_tokens: Optional[List[int]] = None
    # per-LLM-executor cost per generated token (None: single-tier or
    # unresolved models)
    llm_model_costs: Optional[List[float]] = None

    def llm_free_slots(self) -> int:
        """Return the total number of free batch slots across replicas.

        Returns
        -------
        int
            Sum over replicas of ``max_batch - batch``.
        """
        return sum(max(0, mb - b) for b, mb in self.llm_loads)

    def current_batch(self) -> int:
        """Return the largest running batch size across replicas.

        Returns
        -------
        int
            ``max(batch)`` over replicas, 0 when there are none.
        """
        return max((b for b, _ in self.llm_loads), default=0)

    def target_batch(self) -> int:
        """Return the batch size an incoming task is likely to run at.

        Used as ``b_t`` in the paper's Eq. 2 batching-aware latency
        calibration: the least-loaded replica's batch plus one.

        Returns
        -------
        int
            Expected batch size for the next admitted task (≥ 1).
        """
        if not self.llm_loads:
            return 1
        b, mb = min(self.llm_loads, key=lambda t: t[0])
        return min(b + 1, mb)

    @classmethod
    def assemble(
        cls,
        now: float,
        free_regular: int,
        llm_loads: Sequence[Tuple[int, int]],
        latency_profile: Optional[LatencyProfile] = None,
        llm_free_tokens: Optional[Sequence[Optional[int]]] = None,
        llm_prefix_hit_tokens: Optional[Sequence[Optional[int]]] = None,
        llm_model_costs: Optional[Sequence[Optional[float]]] = None,
    ) -> "ClusterView":
        """Build a view — the single construction point for both runtimes.

        ``ServingCluster`` and ``ClusterSim`` used to assemble the field
        list by hand, which is how optional per-replica fields can
        silently drift between the two.  This helper owns the shared
        gating rule: an optional per-replica list containing *any*
        ``None`` or non-finite entry (some replica cannot report the
        signal, or reports garbage) collapses to ``None`` for the whole
        fleet, so schedulers never see a partially-populated signal; a
        list whose length disagrees with ``llm_loads`` raises — a
        misaligned signal would silently score replica *i* with replica
        *j*'s headroom, which is worse than no signal at all.

        Parameters
        ----------
        now : float
            Current runtime time in seconds.
        free_regular : int
            Idle regular-executor slots.
        llm_loads : sequence of (int, int)
            Per-replica ``(batch, max_batch)``.
        latency_profile : LatencyProfile, optional
            Measured/modeled ``l(b)``.
        llm_free_tokens : sequence of int or None, optional
            Per-replica free KV tokens (entries may be ``None``).
        llm_prefix_hit_tokens : sequence of int or None, optional
            Per-replica resident prefix tokens (entries may be ``None``).
        llm_model_costs : sequence of float or None, optional
            Per-replica cost per generated token (entries may be
            ``None`` for replicas whose model has no tier entry).

        Returns
        -------
        ClusterView
            The gated, fully-constructed view.

        Raises
        ------
        ValueError
            When an optional per-replica list is not one-entry-per-
            replica.
        """
        llm_loads = list(llm_loads)

        def gate(name, vals):
            if vals is None:
                return None
            vals = list(vals)
            if len(vals) != len(llm_loads):
                raise ValueError(
                    f"{name} has {len(vals)} entries for "
                    f"{len(llm_loads)} replicas — per-replica signals "
                    "must align with llm_loads"
                )
            if any(v is None or not math.isfinite(v) for v in vals):
                return None
            return vals

        return cls(
            now=now,
            free_regular=free_regular,
            llm_loads=llm_loads,
            latency_profile=latency_profile,
            llm_free_tokens=gate("llm_free_tokens", llm_free_tokens),
            llm_prefix_hit_tokens=gate(
                "llm_prefix_hit_tokens", llm_prefix_hit_tokens
            ),
            llm_model_costs=gate("llm_model_costs", llm_model_costs),
        )


@dataclass
class Decision:
    """Ordered scheduling preference lists (Algorithm 1 output).

    Attributes
    ----------
    regular : list of Task
        Tasks for regular executors, most-preferred first.
    llm : list of Task
        Tasks for LLM executors, most-preferred first.
    placement : dict
        Optional map from :func:`task_key` to a replica index in
        ``ClusterView.llm_loads``.  Runtimes treat it as a *hint*: a
        task whose placed replica cannot admit it falls back to the
        least-loaded admissible replica.  Schedulers that never call
        :meth:`place` leave it empty (historical behaviour).
    """

    regular: List[Task] = field(default_factory=list)
    llm: List[Task] = field(default_factory=list)
    placement: Dict[TaskKey, int] = field(default_factory=dict)

    def place(self, task: Task, replica: int) -> None:
        """Record that ``task`` should run on LLM replica ``replica``.

        Parameters
        ----------
        task : Task
            An LLM task present in :attr:`llm`.
        replica : int
            Index into ``ClusterView.llm_loads``.
        """
        self.placement[task_key(task)] = replica

    def replica_for(self, task: Task) -> Optional[int]:
        """Return the placed replica index for ``task``.

        Parameters
        ----------
        task : Task
            The task being dispatched.

        Returns
        -------
        int or None
            The replica hint, or ``None`` when the scheduler did not
            place this task (caller should use its own fallback).
        """
        return self.placement.get(task_key(task))


@dataclass
class _SloPlan:
    """One job's plan-ahead snapshot, pinned to an evidence version.

    The calibrated remaining-duration bounds are frozen when the plan is
    made; only the runtime clock advances against them between evidence
    events.  Slack therefore shrinks *monotonically* on static evidence,
    which is what makes retraction convergent (a job can move toward
    urgent/infeasible as time passes but never oscillate back without a
    new-evidence bump).
    """

    version: int          # Job.evidence_version the bounds were cached at
    calib: Tuple          # calibration signature (profile epoch, b_t)
    lo_raw: float         # batch-1 optimistic remaining duration (s) —
                          # the true best case, used for the provable-miss
                          # (infeasibility) test so batching slowdown can
                          # never falsely condemn a winnable job
    lo_cal: float         # calibrated optimistic remaining duration (s)
    hi_cal: float         # calibrated pessimistic remaining duration (s)


class Scheduler:
    """Abstract scheduler interface shared by the sim and the testbed."""

    name = "base"

    def schedule(self, jobs: Sequence[Job], view: ClusterView) -> Decision:
        """Produce ordered dispatch preference lists for one round.

        Parameters
        ----------
        jobs : sequence of Job
            All unfinished jobs currently known to the runtime.
        view : ClusterView
            Observable cluster state at this scheduling instant.

        Returns
        -------
        Decision
            Preference-ordered task lists (and optional placement).
        """
        raise NotImplementedError

    # Hook for schedulers that learn online (Decima).
    def observe_completion(self, job: Job, now: float) -> None:  # pragma: no cover
        """Notify the scheduler that ``job`` finished at time ``now``.

        Parameters
        ----------
        job : Job
            The job that just completed.
        now : float
            Completion time in runtime seconds.
        """
        pass


# ---------------------------------------------------------------------------
# LLMSched (Algorithm 1)
# ---------------------------------------------------------------------------
class LLMSched(Scheduler):
    """ε-greedy combination of uncertainty reduction and SRTF.

    ``use_bn=False``           → "LLMSched w/o BN" ablation (historical means).
    ``epsilon=0``              → "LLMSched w/o uncertainty" ablation (pure SRTF).
    ``incremental=True``       → cross-round caching: per-job BN evidence,
    remaining-duration bases, duration bounds, and uncertainty scores are
    memoized against ``Job.evidence_version`` and recomputed only for jobs
    the runtime reported events for (stage completion, dispatch, reveal).
    Emits decisions identical to ``incremental=False``; the flag only
    moves work out of the per-round hot path.

    Multi-replica placement: after building the preference lists, each
    LLM task is assigned a replica with the score

    ``score(e) = w_u · kv_headroom(e) − (1 − w_u) · load(e)
    + w_c · prefix_hit(e) − w_m · (1 − ρ) · cost(e)``

    where ``w_u = 0.25 + 0.5·u`` and ``u ∈ [0, 1]`` is the job's
    normalized duration-bound width (entropy proxy).  Certain jobs
    (``u → 0``) weight the load term — they bin-pack tightly for low
    decode latency; uncertain jobs (``u → 1``) weight KV headroom —
    their unpredictable expansion needs room to grow without triggering
    eviction.  ``prefix_hit(e)`` is the replica's resident reusable-
    prefix tokens (``ClusterView.llm_prefix_hit_tokens``) normalized by
    the fleet maximum, weighted by the fixed cache weight ``w_cache``:
    compound-app tasks steered to the replica already holding their
    shared prompt's KV skip that prefill entirely.  When the view
    carries no prefix info (``None``) the term is omitted, and when it
    is all-zero the term contributes exactly ``0.0`` to every
    candidate — either way the score is bit-identical to the
    cache-blind form, so seeded trajectories are unchanged.  When the
    view has no KV accounting (``llm_free_tokens is None``), placement
    degenerates to least-loaded-by-absolute-batch (prefix residency
    breaking ties ahead of the index when known, which the all-zero
    and ``None`` cases again leave byte-identical) — including
    heterogeneous ``max_batch`` fleets — preserving the historical
    dispatcher behaviour byte-for-byte.

    Cost-aware model routing (heterogeneous pools): when the view
    carries per-replica per-token costs (``llm_model_costs``, from the
    model-zoo tier table) *and* they differ across the fleet, the score
    gains ``− w_m · (1 − ρ) · ĉ(e)`` where ``ĉ(e)`` is the replica's
    cost normalized by the fleet maximum and ``ρ ∈ [0, 1]`` is the
    stage's routing signal — the mean of the job's duration-bound
    uncertainty ``u`` and the stage's cached BN uncertainty reduction
    ``R̂`` normalized by this round's maximum.  The term is a price
    penalty scaled by how *routine* the stage is: stages expected to
    reduce much uncertainty (or belonging to wide-bound jobs) have
    ``ρ → 1`` and place cost-indifferently — the evidence they produce
    is worth the premium — while routine stages (``ρ → 0``) crowd onto
    the cheap tiers, keeping premium capacity free for work that earns
    it.  That is uncertainty-reduction-per-cost routing.  A homogeneous fleet (costs absent or all equal)
    contributes exactly nothing, so single-tier trajectories are
    byte-identical to the cost-blind scheduler.  Cascade re-admission:
    a task whose ``tier_floor`` was raised by a failed quality gate is
    only placed on replicas whose cost *rank* meets the floor — the
    retry provably runs one tier up.  Floors are also *learned* per
    (app, stage template): once a stage type has been escalated to
    rank ``r``, later first attempts of the same type start at ``r``
    directly, skipping the attempts a deterministic gate is guaranteed
    to reject (cost-aware routing only — the ``w_model = 0`` ablation
    keeps paying them, which is exactly the frontier gap fig10
    measures).

    SLO-tiered deadline scheduling: jobs carrying a
    :class:`repro_torch.core.dag.SLO` are scheduled against their absolute
    deadline with three mechanisms (all inert — byte-identical decisions
    — when no job in the system carries an SLO):

    - **plan-ahead** — each SLO job's remaining-duration bounds
      (``AppProfile.job_bounds``, cached per evidence version) are
      calibrated by the measured ``l(b)`` latency model and projected
      against its deadline over the next ``plan_ahead_s`` seconds;
    - **deadline-miss-aware ordering** — provably infeasible jobs (the
      *optimistic* bound already overshoots the deadline) are demoted
      below all feasible work so they stop claiming KV pages first;
      tight-slack ``interactive`` jobs whose deadline falls inside the
      window are boosted ahead of the SRTF order (EDF among
      themselves), and ``batch`` jobs are boosted only once their
      *pessimistic* bound projects a miss; ``best_effort`` jobs are
      never boosted.  Placement still uses the uncertainty/KV score —
      boosted jobs simply reserve headroom first, and demoted jobs are
      left unplaced (no KV reservation);
    - **retraction** — the plan snapshot is pinned per
      ``Job.evidence_version``: when the runtime bumps a job's version
      (stage completion, reveal, dispatch), the queued-but-undispatched
      plan is *retracted* and rebuilt from the tightened bounds
      (``retractions`` counts these).  Running tasks are never
      retracted — preference lists only ever contain pending tasks, so
      token-equality and migration invariants are untouched.

    Parameters
    ----------
    profiles : ProfileStore
        Fitted per-application BN profiles (duration + structure).
    epsilon : float, optional
        Exploration probability of Algorithm 1's ε-greedy merge.
    sampling_ratio : float, optional
        Fraction of an explored stage's tasks dispatched immediately.
    use_bn : bool, optional
        Use Bayesian-network posteriors (``False``: historical means).
    seed : int, optional
        Seed of the exploration RNG.
    incremental : bool, optional
        Enable cross-round caching keyed by ``Job.evidence_version``.
    plan_ahead_s : float, optional
        Plan-ahead window W in seconds: only deadlines within
        ``now + W`` can trigger an urgency boost.  Infeasibility
        demotion applies regardless of the window.
    slo_aware : bool, optional
        Gate the SLO machinery entirely.  ``False`` makes the scheduler
        deadline-blind even on SLO-carrying workloads (identical
        decisions to an SLO-less run) — the ablation baseline the
        goodput benchmark compares against.
    check_invariants : bool, optional
        Validate every decision against the declarative invariant
        catalog in :mod:`repro_torch.analysis.invariants` (no running-task
        retraction, demoted jobs unplaced, placement bounds, plan
        snapshots pinned to current evidence/calibration, EDF order of
        the urgent bucket), raising
        :class:`~repro_torch.analysis.invariants.InvariantViolation` on the
        first bad round.  Observation-only: the decision stream is
        identical with checking on or off.
    """

    name = "llmsched"

    #: Tokens of KV headroom assumed consumed by one placed-but-not-yet-
    #: running LLM task (the scheduler cannot see true output lengths,
    #: which are ground truth hidden until completion).
    kv_reserve_tokens = 64

    #: Weight of the cache-affinity term in the placement score.  Small
    #: relative to the uncertainty/load terms: prefix reuse is a cost
    #: saving, not a correctness constraint, and must not override KV
    #: headroom for high-uncertainty jobs.
    w_cache = 0.2

    #: Weight of the cost-aware routing term on heterogeneous pools.
    #: ``0.0`` yields the cost-blind router ablation (placement ignores
    #: tier prices; tier floors from cascade escalation still bind).
    w_model = 0.3

    def __init__(
        self,
        profiles: ProfileStore,
        epsilon: float = 0.3,
        sampling_ratio: float = 0.3,
        use_bn: bool = True,
        seed: int = 0,
        incremental: bool = True,
        plan_ahead_s: float = 30.0,
        slo_aware: bool = True,
        check_invariants: bool = False,
    ) -> None:
        self.profiles = profiles
        self.epsilon = float(epsilon)
        self.sampling_ratio = float(sampling_ratio)
        self.use_bn = use_bn
        self.incremental = bool(incremental)
        self.plan_ahead_s = float(plan_ahead_s)
        self.slo_aware = bool(slo_aware)
        self.check_invariants = bool(check_invariants)
        # urgent-bucket sort keys of the latest round, recorded for the
        # EDF invariant (None until _slo_order runs with checking on)
        self._last_urgent_keys: Optional[List[Tuple]] = None
        self.rng = np.random.default_rng(seed)
        # SLO plan-ahead state: per-job plan snapshots pinned to the
        # job's evidence version (see _SloPlan), plus public counters.
        self._slo_plans: Dict[int, _SloPlan] = {}
        self._demoted: set = set()
        #: queued plans revisited after an evidence/calibration change
        self.retractions = 0
        #: jobs newly classified provably deadline-infeasible
        self.demotions = 0
        # caches invalidated per-call; uncertainty scores are reused across
        # ε draws within one invocation.
        self._ur_cache: Dict[Tuple[int, str], float] = {}
        # calibration-context tracking: the latency profile object only
        # changes identity when new measurements arrive, so (epoch, b_t)
        # keys the batching-calibrated remaining-duration cache.
        self._last_profile = None
        self._calib_epoch = 0
        # cross-round ready-stage cache (readiness is pure within a
        # job's evidence version: it only changes on dispatch/completion/
        # reveal events, all of which bump the version)
        self._ready_cache: Dict[int, Tuple[int, List[Stage]]] = {}
        # learned cascade floors: (app, stage template) → the highest
        # tier rank a gate rejection has forced that stage type up to.
        # Future first attempts of the same type start there instead of
        # re-paying the doomed cheap attempts (cost-aware routing only;
        # stays empty on homogeneous or unpriced fleets).
        self._tier_prior: Dict[Tuple[str, str], int] = {}
        self._app_by_job: Dict[int, str] = {}

    # -- helpers -------------------------------------------------------------
    def _version(self, job: Job) -> Optional[int]:
        return job.evidence_version if self.incremental else None

    def _ready_stages(self, job: Job) -> List[Stage]:
        if not self.incremental:
            return job.ready_stages()
        v = job.evidence_version
        hit = self._ready_cache.get(job.job_id)
        if hit is not None and hit[0] == v:
            return hit[1]
        rs = job.ready_stages()
        self._ready_cache[job.job_id] = (v, rs)
        return rs

    def _calibrator(self, view: ClusterView) -> Callable[[Stage, float], float]:
        prof = view.latency_profile
        if prof is None:
            return lambda stage, est: est

        b_t = view.target_batch()

        def cal(stage: Stage, est: float) -> float:
            if stage.stype is StageType.LLM:
                # historical estimates are recorded at batch size 1
                return prof.calibrate(est, b_r=1, b_t=b_t)
            return est

        return cal

    def _calib_sig(self, view: ClusterView) -> Tuple:
        """Hashable token capturing everything the calibrator depends on."""
        prof = view.latency_profile
        if prof is None:
            return ("none",)
        if prof is not self._last_profile:
            self._last_profile = prof
            self._calib_epoch += 1
        return (self._calib_epoch, view.target_batch())

    def est_rd(self, job: Job, view: ClusterView) -> float:
        """Estimate ``job``'s remaining duration (SRTF key).

        Parameters
        ----------
        job : Job
            The job to estimate.
        view : ClusterView
            Cluster state — supplies ``now`` and the batching-aware
            latency calibration context (Eq. 2).

        Returns
        -------
        float
            Expected remaining seconds; ``inf`` when the application
            has no fitted profile.
        """
        p = self.profiles.get(job.app.name)
        if p is None:
            return float("inf")
        return p.est_remaining(
            job,
            view.now,
            calibrate=self._calibrator(view),
            use_bn=self.use_bn,
            version=self._version(job),
            calib_key=self._calib_sig(view),
        )

    def _uncert(self, job: Job, stage: Stage) -> float:
        return self._uncert_batch(job, [stage])[0]

    def _uncert_batch(self, job: Job, stages: Sequence[Stage]) -> List[float]:
        """R(stage) for several ready stages of one job, with one BN pass."""
        miss = [s for s in stages if (job.job_id, s.name) not in self._ur_cache]
        if miss:
            p = self.profiles.get(job.app.name)
            if p is None:
                vals = [0.0] * len(miss)
            else:
                vals = p.stage_uncertainty_reductions(
                    job, [s.name for s in miss], version=self._version(job)
                )
            for s, v in zip(miss, vals):
                self._ur_cache[(job.job_id, s.name)] = v
        return [self._ur_cache[(job.job_id, s.name)] for s in stages]

    @staticmethod
    def non_overlapping_sets(
        bounds: List[Tuple[float, float, Job]]
    ) -> List[List[Job]]:
        """Group jobs whose duration intervals overlap (line 5).

        Jobs within a group cannot be ordered with certainty; between
        groups the ordering is certain.

        Parameters
        ----------
        bounds : list of (float, float, Job)
            Per-job ``(lower, upper)`` remaining-duration bounds.

        Returns
        -------
        list of list of Job
            Overlap groups, ordered by lower bound.
        """
        if not bounds:
            return []
        los = np.asarray([b[0] for b in bounds], dtype=np.float64)
        his = np.asarray([b[1] for b in bounds], dtype=np.float64)
        return LLMSched._group_by_overlap(los, his, [b[2] for b in bounds])

    @staticmethod
    def _group_by_overlap(
        los: np.ndarray, his: np.ndarray, jobs: List[Job]
    ) -> List[List[Job]]:
        """Vectorized interval grouping: sort by (lo, hi), then break a
        group wherever an interval's lo exceeds the running max of hi."""
        n = len(jobs)
        if n == 0:
            return []
        order = np.lexsort((his, los))  # stable; primary lo, secondary hi
        slo = los[order]
        cummax = np.maximum.accumulate(his[order])
        starts = np.empty(n, dtype=bool)
        starts[0] = True
        if n > 1:
            starts[1:] = slo[1:] > cummax[:-1]
        gid = np.cumsum(starts) - 1
        groups: List[List[Job]] = [[] for _ in range(int(gid[-1]) + 1)]
        for k in range(n):
            groups[int(gid[k])].append(jobs[int(order[k])])
        return groups

    # -- Algorithm 1 -----------------------------------------------------------
    def schedule(self, jobs: Sequence[Job], view: ClusterView) -> Decision:
        """Run Algorithm 1 and return placement-annotated preferences.

        Parameters
        ----------
        jobs : sequence of Job
            All unfinished jobs.
        view : ClusterView
            Observable cluster state.

        Returns
        -------
        Decision
            SRTF/uncertainty ε-greedy merged task lists; every LLM task
            additionally carries a replica placement hint (see class
            docstring for the placement score).
        """
        self._ur_cache.clear()
        if self.check_invariants:
            self._last_urgent_keys = None
        jobs = [j for j in jobs if not j.done()]
        if not jobs:
            return Decision()

        # ready stages once per job per round (reused for S_t and S_u;
        # cached across rounds for jobs without new events)
        ready: Dict[int, List[Stage]] = {
            j.job_id: self._ready_stages(j) for j in jobs
        }

        # per-job remaining-duration bounds (Algorithm 1 line 5; also the
        # SLO plan-ahead input).  Cached per evidence version, so hoisting
        # the computation above the SRTF sort changes nothing numerically.
        n = len(jobs)
        los = np.empty(n, dtype=np.float64)
        his = np.empty(n, dtype=np.float64)
        for i, job in enumerate(jobs):
            p = self.profiles.get(job.app.name)
            lo, hi = (
                p.job_bounds(job, use_bn=self.use_bn, version=self._version(job))
                if p
                else (0.0, math.inf)
            )
            los[i] = lo
            his[i] = hi

        # lines 1-4: S_t — ready stages in SRTF order of their job;
        # SLO-aware deadline ordering reshuffles the *job* order (boost /
        # demote) only when at least one job actually carries an SLO —
        # SLO-less workloads keep the historical order byte-for-byte.
        j_t = sorted(jobs, key=lambda j: (self.est_rd(j, view), j.arrival_time))
        if self.slo_aware and any(j.slo is not None for j in jobs):
            j_t = self._slo_order(j_t, view, dict(zip(
                (j.job_id for j in jobs), zip(los, his)
            )))
        s_t: List[Stage] = []
        for job in j_t:
            s_t.extend(ready[job.job_id])

        # lines 5-10: S_u — stages by uncertainty reduction within
        # non-overlapping job groups (bounds gathered into numpy arrays)
        s_u: List[Stage] = []
        for group in self._group_by_overlap(los, his, list(jobs)):
            # only genuinely uncertainty-reducing stages are exploration
            # candidates (paper §IV-B: stages correlated with ≥1 other)
            scored: List[Tuple[float, Stage]] = []
            for job in group:
                rs = ready[job.job_id]
                if rs:
                    scored.extend(zip(self._uncert_batch(job, rs), rs))
            scored = [(r, s) for r, s in scored if r > 0.0]
            scored.sort(key=lambda t: -t[0])
            s_u.extend(s for _, s in scored)

        # lines 11-20: ε-greedy merge
        dec = self._merge(s_t, s_u)

        # multi-replica placement: duration-bound width as the entropy
        # proxy (same arrays that drove the grouping above)
        self._app_by_job = {j.job_id: j.app.name for j in jobs}
        self._place_llm(dec, view, self._job_uncertainty(jobs, los, his))

        if self.check_invariants:
            # imported lazily: the analysis package must stay optional
            # on the scheduling hot path
            from ..analysis.invariants import check_decision

            check_decision(self, jobs, view, dec)
        return dec

    # -- SLO plan-ahead / retraction ----------------------------------------
    def _slo_plan_for(
        self, job: Job, view: ClusterView, lo: float, hi: float
    ) -> _SloPlan:
        """Return the job's plan snapshot, retracting a stale one.

        The snapshot pins the calibrated duration bounds to the job's
        current ``evidence_version`` and calibration context.  A cached
        plan made under an older version (or a different measured
        ``l(b)`` epoch / target batch) is *retracted*: the queued
        decision it backed is revisited with fresh bounds.  Running
        tasks are untouched — plans only shape the ordering of pending
        tasks.

        Parameters
        ----------
        job : Job
            An unfinished job carrying an SLO.
        view : ClusterView
            Supplies the l(b) calibration context.
        lo, hi : float
            Raw (batch-1) remaining-duration bounds from the profile.

        Returns
        -------
        _SloPlan
            The current (possibly freshly rebuilt) snapshot.
        """
        sig = self._calib_sig(view)
        plan = self._slo_plans.get(job.job_id)
        if (
            plan is not None
            and plan.version == job.evidence_version
            and plan.calib == sig
        ):
            return plan
        if plan is not None:
            self.retractions += 1
        prof = view.latency_profile
        stretch = (
            prof.calibrate(1.0, b_r=1, b_t=view.target_batch())
            if prof is not None
            else 1.0
        )
        plan = _SloPlan(
            version=job.evidence_version,
            calib=sig,
            lo_raw=lo,
            lo_cal=lo * stretch,
            hi_cal=hi * stretch,
        )
        self._slo_plans[job.job_id] = plan
        return plan

    def _slo_order(
        self,
        j_t: List[Job],
        view: ClusterView,
        bounds: Dict[int, Tuple[float, float]],
    ) -> List[Job]:
        """Deadline-aware reorder of the SRTF job list (boost / demote).

        Three buckets, each preserving SRTF order internally unless
        stated: **urgent** SLO jobs — deadline inside the plan-ahead
        window AND at risk (the calibrated pessimistic bound projects a
        miss); interactive/batch only, never best-effort — move to the
        front in (tier, pessimistic-slack, deadline) order.  Jobs with
        comfortable slack stay in SRTF order even inside the window, so
        deadline pressure perturbs the JCT-optimal order no more than
        necessary.  **Infeasible** jobs (the *batch-1 optimistic* bound
        already overshoots the deadline — a provable miss even in the
        best case) move behind all feasible work; everything else keeps
        its SRTF position.

        Parameters
        ----------
        j_t : list of Job
            Jobs in SRTF order (the historical ordering).
        view : ClusterView
            Supplies ``now`` and the calibration context.
        bounds : dict
            ``job_id → (lo, hi)`` raw remaining-duration bounds.

        Returns
        -------
        list of Job
            The reordered job list.
        """
        now = view.now
        window_end = now + self.plan_ahead_s
        urgent: List[Tuple[int, float, float, float, Job]] = []
        normal: List[Job] = []
        infeasible: List[Job] = []
        demoted_now: set = set()
        for job in j_t:
            slo = job.slo
            if slo is None:
                normal.append(job)
                continue
            lo, hi = bounds[job.job_id]
            plan = self._slo_plan_for(job, view, lo, hi)
            remaining = slo.deadline - now
            if plan.lo_raw > remaining:
                # provable miss: even the batch-1 optimistic bound
                # overshoots — stop spending prime capacity (and KV
                # pages) on it
                demoted_now.add(job.job_id)
                if job.job_id not in self._demoted:
                    self.demotions += 1
                infeasible.append(job)
                continue
            at_risk = plan.hi_cal > remaining
            boost = (
                slo.deadline <= window_end
                and at_risk
                and slo.tier != "best_effort"
            )
            if boost:
                urgent.append((
                    SLO_TIERS.index(slo.tier),
                    remaining - plan.hi_cal,   # pessimistic slack
                    slo.deadline,
                    job.arrival_time,
                    job,
                ))
            else:
                normal.append(job)
        urgent.sort(key=lambda t: t[:4])
        self._demoted = demoted_now
        if self.check_invariants:
            self._last_urgent_keys = [t[:4] for t in urgent]
        return [t[4] for t in urgent] + normal + infeasible

    @staticmethod
    def _job_uncertainty(
        jobs: Sequence[Job], los: np.ndarray, his: np.ndarray
    ) -> Dict[int, float]:
        """Normalize duration-bound widths to per-job u ∈ [0, 1]."""
        widths = his - los
        finite = widths[np.isfinite(widths)]
        wmax = float(finite.max()) if finite.size else 0.0
        out: Dict[int, float] = {}
        for job, w in zip(jobs, widths):
            if not math.isfinite(w):
                out[job.job_id] = 1.0
            elif wmax <= 0.0:
                out[job.job_id] = 0.0
            else:
                out[job.job_id] = min(1.0, max(0.0, float(w) / wmax))
        return out

    def _place_llm(
        self,
        dec: Decision,
        view: ClusterView,
        uncertainty: Dict[int, float],
    ) -> None:
        """Assign each LLM task a replica via the routing score.

        Projects batch occupancy and KV headroom forward as tasks are
        placed, so one round's placements never overcommit a replica.
        Without ``llm_free_tokens`` *and* without differing per-replica
        costs the score reduces to least-loaded (prefix residency
        breaks ties when known, then lowest index) — identical to the
        pre-placement dispatchers whenever the view carries no (or
        all-zero) prefix info, keeping seeded single/multi-replica sim
        trajectories unchanged.  Tasks carrying a cascade
        ``tier_floor`` are restricted to replicas whose cost rank meets
        the floor whenever the fleet's tiers are known; on cost-aware
        heterogeneous fleets the floor a retry carries is also
        remembered per (app, stage template), so later first attempts
        of a proven-hard stage type start at the proven tier.
        """
        n = len(view.llm_loads)
        if n == 0 or not dec.llm:
            return
        proj_b = [b for b, _ in view.llm_loads]
        mbs = [mb for _, mb in view.llm_loads]
        free_tok = (
            list(view.llm_free_tokens)
            if view.llm_free_tokens is not None
            else None
        )
        hit_tok = view.llm_prefix_hit_tokens
        hit_norm = (
            [h / max(max(hit_tok), 1) for h in hit_tok]
            if hit_tok is not None
            else [0.0] * n
        )
        # cost signal: dense rank per replica (0 = cheapest tier) plus a
        # fleet-max-normalized cost.  A homogeneous fleet (or a view
        # without costs) gates the routing term off entirely — not
        # merely uniformly — so such runs are byte-identical to the
        # cost-blind score.
        costs = view.llm_model_costs
        cost_norm: Optional[List[float]] = None
        ranks = [0] * n
        if costs is not None and len(set(costs)) > 1:
            cmax = max(costs)
            order = sorted(set(costs))
            ranks = [order.index(c) for c in costs]
            if cmax > 0.0 and self.w_model != 0.0:
                cost_norm = [c / cmax for c in costs]
        tiers_known = costs is not None
        # round-max of the cached stage uncertainty reductions: the
        # normalizer of the routing signal ρ
        ur_max = max(self._ur_cache.values(), default=0.0)
        for t in dec.llm:
            if t.job_id in self._demoted:
                # provably deadline-infeasible: runs only on leftover
                # capacity — reserve no KV headroom for it (the set is
                # empty for SLO-less workloads, keeping this a no-op)
                continue
            floor = getattr(t, "tier_floor", 0)
            if cost_norm is not None:
                # escalation-floor learning (cost-aware routing only):
                # a cascade retry proves its stage *type* out-of-depth
                # below its floor, so future first attempts of the same
                # (app, stage) start at the proven tier instead of
                # re-paying the doomed cheap attempts
                key = (self._app_by_job.get(t.job_id, ""), t.stage_name)
                if floor > 0:
                    if floor > self._tier_prior.get(key, 0):
                        self._tier_prior[key] = floor
                else:
                    prior = self._tier_prior.get(key, 0)
                    if prior:
                        floor = t.tier_floor = prior  # runtimes honour it
            u = uncertainty.get(t.job_id, 0.5)
            w = 0.25 + 0.5 * u
            best = None
            if free_tok is None and cost_norm is None:
                # no KV accounting: exact least-loaded by absolute batch
                # (decode latency is l(b) in the absolute batch size) —
                # byte-identical to the historical dispatchers, including
                # heterogeneous max_batch fleets; resident prefix tokens
                # (when reported) only break exact-load ties
                cands = [
                    e for e in range(n)
                    if proj_b[e] < mbs[e]
                    and not (tiers_known and ranks[e] < floor)
                ]
                if cands:
                    best = min(
                        cands, key=lambda e: (proj_b[e], -hit_norm[e], e)
                    )
            else:
                if cost_norm is not None:
                    ur = self._ur_cache.get((t.job_id, t.stage_name), 0.0)
                    rhat = ur / ur_max if ur_max > 0.0 else 0.0
                    rho = 0.5 * (u + rhat)
                best_score = -math.inf
                for e in range(n):
                    if mbs[e] <= 0 or proj_b[e] >= mbs[e]:
                        continue
                    if tiers_known and ranks[e] < floor:
                        continue  # cascade retry must run one tier up
                    if free_tok is not None and free_tok[e] <= 0:
                        continue  # no KV left: placing guarantees refusal
                    load = proj_b[e] / mbs[e]
                    kv = (
                        free_tok[e] / max(max(free_tok), 1)
                        if free_tok is not None
                        else 0.0
                    )
                    score = (
                        w * kv
                        - (1.0 - w) * load
                        + self.w_cache * hit_norm[e]
                    )
                    if cost_norm is not None:
                        # premium capacity costs score in proportion to
                        # how *routine* the stage is: high-ρ stages are
                        # cost-indifferent (their evidence is worth the
                        # premium), routine ones crowd onto cheap tiers
                        score -= (
                            self.w_model * (1.0 - rho) * cost_norm[e]
                        )
                    if score > best_score + 1e-12:
                        best, best_score = e, score
            if best is None:
                continue  # every replica projected full; runtime retries
            dec.place(t, best)
            proj_b[best] += 1
            if free_tok is not None:
                free_tok[best] = max(0, free_tok[best] - self.kv_reserve_tokens)

    def observe_completion(self, job: Job, now: float) -> None:
        """Evict the finished job's slots from the cross-round caches.

        Parameters
        ----------
        job : Job
            The job that just completed.
        now : float
            Completion time (unused; interface parity).
        """
        self._ready_cache.pop(job.job_id, None)
        self._slo_plans.pop(job.job_id, None)
        self._demoted.discard(job.job_id)
        p = self.profiles.get(job.app.name)
        if p is not None:
            p.forget_job(job.job_id)

    def _merge(self, s_t: List[Stage], s_u: List[Stage]) -> Decision:
        dec = Decision()
        taken: set = set()
        deferred: List[Task] = []
        s_t = list(s_t)
        s_u = list(s_u)

        def pop_next(lst: List[Stage]) -> Optional[Stage]:
            while lst:
                s = lst.pop(0)
                if id(s) not in taken:
                    return s
            return None

        def attach(tasks: List[Task]) -> None:
            for t in tasks:
                (dec.llm if t.is_llm else dec.regular).append(t)

        while s_t and s_u:
            st = pop_next(s_t)
            su = pop_next(s_u)
            if st is None and su is None:
                break
            p = self.rng.random()
            if p < self.epsilon and su is not None:
                taken.add(id(su))
                pending = su.pending_tasks()
                if su is st:
                    # exploration pick coincides with the SRTF head: run it
                    # fully — sampling would only defer the exploit choice.
                    attach(pending)
                    continue
                k = max(1, math.ceil(self.sampling_ratio * len(pending)))
                attach(pending[:k])
                deferred.extend(pending[k:])
                if st is not None:
                    s_t.insert(0, st)  # not consumed this round
            elif st is not None:
                taken.add(id(st))
                attach(st.pending_tasks())
                if su is not None:
                    s_u.insert(0, su)
            elif su is not None:
                taken.add(id(su))
                attach(su.pending_tasks())

        # line 21: whatever list still has stages + sampled remainders
        for s in s_t + s_u:
            if id(s) not in taken:
                taken.add(id(s))
                attach(s.pending_tasks())
        attach(deferred)
        return dec
