"""Event-driven cluster simulator (paper §V "Simulator").

Models the provider's cluster:
- ``n_regular`` regular executors — one regular task each;
- ``n_llm`` LLM executors — up to ``max_batch`` concurrent LLM tasks.

LLM tasks are token streams: a task with T output tokens finishes after
its executor decodes T of its tokens.  The per-token latency depends on
the executor's *current* batch size via a :class:`LatencyProfile`, so —
exactly like the paper's simulator — the remaining duration of every
running LLM task is re-stretched whenever the batch composition changes.

Optional fault injection: executor failures re-queue running tasks
(checkpoint/restart at the scheduling layer) and straggler tasks are
re-issued once they exceed ``straggler_factor`` × their expected duration
(speculative execution), mirroring what the large-scale runtime needs.

Multi-replica serving is mirrored from ``repro_torch.serving``: ``max_batch``
may be a per-replica sequence (heterogeneous replicas), LLM dispatch
honours the scheduler's placement hints (``Decision.placement``), and
``kv_budget_tokens`` gives each replica a finite KV pool whose usage
grows as its tasks decode — the simulator analog of the paged engines'
page pools.  When a replica's KV overflows, its youngest task is
preempted (recompute restart: all decoded tokens lost), exactly like
the paged engine's LIFO eviction; with ``migrate=True`` the task is
instead live-migrated to the replica with the most KV headroom, paying
``migration_cost_s`` of decode-time stall (the KV transfer).  Without
KV budgets, ``migrate=True`` falls back to batch-gap rebalancing.
This lets fig7/fig9 sweep replica counts and migration on/off with the
same cost mechanics the testbed measures for real.

Shared-prefix reuse is mirrored too: with ``prompt_tokens_per_task``
set, every LLM task pays modeled prefill work, and ``prefix_cache=True``
lets a replica that already served the same application skip the shared
system-prompt tokens (per-replica LRU residency, capacity-capped) —
the discrete-event analog of the paged engines' radix prefix index.
Per-job prefill token totals are recorded so the sim↔testbed parity
canary can detect cache-model drift.
"""

from __future__ import annotations

import heapq
import math
import time as _time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.calibration import LatencyProfile
from ..core.dag import Job, Stage, Task, TaskState
from ..core.metrics import RunMetrics
from ..core.scheduler import ClusterView, Decision, Scheduler
from .workloads import (
    TOKEN_LATENCY_B1,
    GeneratedJob,
    get_generators,
    reveal_after_stage,
)


def default_latency_profile(max_batch: int = 16) -> LatencyProfile:
    """l(b) with l(1) = TOKEN_LATENCY_B1 and sub-linear growth in b —
    the memory-bound decode roofline (weights amortize, KV does not)."""
    bs = np.arange(1, max_batch + 1)
    # weights ≫ per-request KV: l(b) grows gently; matches H800 profiles
    lat = TOKEN_LATENCY_B1 * (0.85 + 0.15 * bs ** 0.7)
    return LatencyProfile(batch_sizes=bs, latency=lat)


@dataclass
class RunningLLMTask:
    task: Task
    remaining_tokens: float
    executor: int


# Backwards-compatible alias: the simulator's historical result type is
# now the unified schema shared with the serving testbed.
SimResult = RunMetrics


class ClusterSim:
    """Event-driven simulation of one provider cluster.

    Parameters
    ----------
    scheduler : Scheduler
        Policy under test.
    n_regular : int, optional
        Regular executor count.
    n_llm : int, optional
        LLM replica count.
    max_batch : int or sequence of int, optional
        Per-replica batch capacity; a scalar applies to every replica,
        a sequence of length ``n_llm`` models heterogeneous replicas.
    latency_profile : LatencyProfile, optional
        ``l(b)`` per-token decode latency (default: memory-bound
        roofline shape).
    failure_rate : float, optional
        Executor failures per sim-second (0 disables).
    straggler_factor : float, optional
        Speculative re-issue threshold multiplier (0 disables).
    migrate : bool, optional
        Enable cross-replica live migration of running LLM tasks.
    migration_cost_s : float, optional
        Decode-time stall a migrated task pays (KV transfer cost),
        converted to tokens at the batch-1 rate.
    kv_budget_tokens : int or sequence of int, optional
        Per-replica KV capacity in tokens (scalar applies to all).
        ``None`` (default) models unbounded KV — the historical
        behaviour.  With a budget, a replica whose running tasks'
        decoded tokens exceed it preempts (or, with ``migrate=True``,
        migrates away) its youngest task, mirroring the paged engine.
    prompt_tokens_per_task : float, optional
        When set, every LLM task pays this much prompt-prefill work
        (charged as extra tokens decoded at the batch rate — the sim
        analog of chunked prefill interleaving with decode).  ``None``
        (default) keeps the historical decode-only model byte-for-byte.
    shared_prompt_tokens : float, optional
        Of ``prompt_tokens_per_task``, the tokens belonging to the
        application's shared system prompt — the reusable part.
    prefix_cache : bool, optional
        Model shared-prefix KV reuse: a replica that already served a
        task of the same application skips the shared prompt tokens
        (the testbed's radix-index hit), tracked per replica with LRU
        eviction under ``prefix_cache_capacity_tokens``.  Mirrors the
        paged engine's prefix cache so fig-level sweeps and the
        sim↔testbed parity canary agree on the savings model.
    prefix_cache_capacity_tokens : float, optional
        Per-replica cap on resident shared-prefix tokens; the least
        recently used application's prefix is evicted beyond it.
    model_tiers : sequence of str, optional
        Per-replica model-zoo names (length ``n_llm``; any spelling
        :func:`repro_torch.models.zoo.resolve_tier` accepts) declaring a
        heterogeneous pool.  Each replica decodes at its tier's
        ``latency_scale`` × the baseline ``l(b)``, charges its tier's
        per-token cost into ``RunMetrics.cost_by_job`` on every
        completed LLM attempt, and advertises the cost through
        ``ClusterView.llm_model_costs`` so LLMSched can route by
        uncertainty-reduction-per-cost.  ``None`` (default) keeps the
        historical single-tier model byte-for-byte; a homogeneous list
        (every replica the same tier) also schedules byte-identically
        when its ``latency_scale`` is 1.0, since the cost signal gates
        itself off.
    gate : QualityGate, optional
        Pluggable verifier over LLM stage outputs (requires
        ``model_tiers`` — the gate judges against the serving tier's
        quality).  A rejected output either escalates (``cascade=True``
        and a higher tier exists) or marks the job quality-failed in
        ``RunMetrics.quality_by_job``.
    cascade : bool, optional
        Re-enqueue gate-rejected LLM tasks with ``tier_floor`` one cost
        rank above the tier that failed (counted in
        ``RunMetrics.escalations``).  Requires ``gate``.
    seed : int, optional
        RNG seed for fault/straggler injection.  The quality gate's
        draws are hash-derived per attempt and consume nothing from
        this stream, so enabling the gate perturbs no other event.
    """

    def __init__(
        self,
        scheduler: Scheduler,
        n_regular: int = 4,
        n_llm: int = 1,
        max_batch=8,
        latency_profile: Optional[LatencyProfile] = None,
        failure_rate: float = 0.0,       # executor failures per sim-second
        straggler_factor: float = 0.0,   # 0 disables re-issue
        migrate: bool = False,
        migration_cost_s: float = 0.05,
        kv_budget_tokens=None,
        prompt_tokens_per_task: Optional[float] = None,
        shared_prompt_tokens: float = 0.0,
        prefix_cache: bool = False,
        prefix_cache_capacity_tokens: float = math.inf,
        model_tiers: Optional[Sequence[str]] = None,
        gate=None,
        cascade: bool = False,
        seed: int = 0,
    ) -> None:
        self.scheduler = scheduler
        self.n_regular = n_regular
        self.n_llm = n_llm
        if isinstance(max_batch, (list, tuple)):
            if len(max_batch) != n_llm:
                raise ValueError(
                    f"max_batch list length {len(max_batch)} != n_llm {n_llm}"
                )
            self._mb = [int(m) for m in max_batch]
        else:
            self._mb = [int(max_batch)] * n_llm
        self.max_batch = max(self._mb) if self._mb else int(max_batch)
        self.profile = latency_profile or default_latency_profile(self.max_batch)
        self.failure_rate = failure_rate
        self.straggler_factor = straggler_factor
        self.migrate = bool(migrate)
        self.migration_cost_s = float(migration_cost_s)
        if kv_budget_tokens is None:
            self._kv: Optional[List[float]] = None
        elif isinstance(kv_budget_tokens, (list, tuple)):
            if len(kv_budget_tokens) != n_llm:
                raise ValueError(
                    f"kv_budget_tokens list length {len(kv_budget_tokens)} "
                    f"!= n_llm {n_llm}"
                )
            self._kv = [float(k) for k in kv_budget_tokens]
        else:
            self._kv = [float(kv_budget_tokens)] * n_llm
        # KV mechanics (token analogs of the paged engine's page pool):
        # one relief event must free at least a quantum (whole pages, not
        # single tokens) and admission requires a reserve of headroom
        # (can_admit refuses when the pool is nearly dry) — both prevent
        # admit/evict churn storms around a saturated replica.
        self.prompt_tokens_per_task = (
            None if prompt_tokens_per_task is None
            else float(prompt_tokens_per_task)
        )
        self.shared_prompt_tokens = float(shared_prompt_tokens)
        self.prefix_cache = bool(prefix_cache)
        self.prefix_cache_capacity_tokens = float(prefix_cache_capacity_tokens)
        if (
            self.prompt_tokens_per_task is not None
            and self.shared_prompt_tokens > self.prompt_tokens_per_task
        ):
            raise ValueError(
                "shared_prompt_tokens cannot exceed prompt_tokens_per_task"
            )
        # heterogeneous pool: per-replica tier economics from the model
        # zoo.  Tier names must resolve — a typo'd model silently priced
        # at 0 would corrupt every cost artifact.
        self.gate = gate
        self.cascade = bool(cascade)
        if model_tiers is None:
            if gate is not None or cascade:
                raise ValueError(
                    "gate/cascade require model_tiers (the gate judges "
                    "against the serving tier's quality)"
                )
            self._tier_cost: Optional[List[float]] = None
            self._tier_quality: Optional[List[float]] = None
            self._ranks: Optional[List[int]] = None
            self._lat_scale: List[float] = [1.0] * n_llm
        else:
            from ..core.cascade import fleet_ranks
            from ..models.zoo import tier_spec

            if len(model_tiers) != n_llm:
                raise ValueError(
                    f"model_tiers list length {len(model_tiers)} "
                    f"!= n_llm {n_llm}"
                )
            if cascade and gate is None:
                raise ValueError("cascade=True requires a gate")
            specs = []
            for name in model_tiers:
                spec = tier_spec(name)
                if spec is None:
                    raise ValueError(f"unknown model tier: {name!r}")
                specs.append(spec)
            self._tier_cost = [s.usd_per_mtok / 1e6 for s in specs]
            self._tier_quality = [s.quality for s in specs]
            self._ranks = fleet_ranks(self._tier_cost)
            self._lat_scale = [s.latency_scale for s in specs]
        self.kv_relief_quantum = 64.0
        self.kv_admission_reserve = 256.0
        if self._kv is not None and any(
            k < self.kv_admission_reserve for k in self._kv
        ):
            raise ValueError(
                "kv_budget_tokens must be >= the admission reserve "
                f"({self.kv_admission_reserve:.0f} tokens); smaller pools "
                "would refuse every dispatch and deadlock the workload"
            )
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------ run
    def run(self, workload: Sequence[GeneratedJob]) -> SimResult:
        gens = get_generators()
        jobs: List[Job] = [gj.job for gj in workload]
        res = SimResult()

        now = 0.0
        arrivals = sorted(jobs, key=lambda j: j.arrival_time)
        ai = 0
        active: List[Job] = []

        # fault injection: next executor-failure time (Poisson process over
        # all executors); straggler injection probability for regular tasks
        n_exec = self.n_regular + self.n_llm
        def _next_failure(t0: float) -> float:
            if self.failure_rate <= 0:
                return math.inf
            return t0 + float(self.rng.exponential(1.0 / (self.failure_rate * n_exec)))
        t_fail = _next_failure(0.0)
        straggler_prob = 0.05 if self.straggler_factor > 0 else 0.0
        # regular duplicates: task id -> (deadline, executor) of the backup
        backups: Dict[int, Tuple[float, int]] = {}

        # regular executors: list of (finish_time, task) or None
        reg_running: List[Optional[Tuple[float, Task]]] = [None] * self.n_regular
        # LLM executors: running task lists
        llm_running: List[List[RunningLLMTask]] = [[] for _ in range(self.n_llm)]
        # prefix-cache model: per-replica {app name -> last-use time} of
        # resident shared prompts (the radix index's app-level analog)
        pcache: List[Dict[str, float]] = [{} for _ in range(self.n_llm)]

        def prefix_resident_tokens(e: int) -> int:
            return int(len(pcache[e]) * self.shared_prompt_tokens)

        def charge_prefill(e: int, task: Task) -> float:
            """Prompt work (tokens) task pays when dispatched to ``e``.

            A hit on the replica's resident shared prompt skips the
            shared tokens; the residency is refreshed LRU-style and
            capped by the capacity budget — mirroring the paged
            engine's adopt / insert / LRU-evict cycle.
            """
            if self.prompt_tokens_per_task is None:
                return 0.0
            prefill = self.prompt_tokens_per_task
            if self.prefix_cache and self.shared_prompt_tokens > 0:
                app = job_by_id[task.job_id].app.name
                cap = self.prefix_cache_capacity_tokens
                if app in pcache[e]:
                    prefill -= self.shared_prompt_tokens
                    res.prefill_saved_tokens += self.shared_prompt_tokens
                # a prefix only becomes (or stays) resident when it fits
                # the capacity at all — a capacity-starved testbed
                # replica cannot retain dormant pages either
                if self.shared_prompt_tokens <= cap:
                    pcache[e][app] = now
                    while len(pcache[e]) * self.shared_prompt_tokens > cap:
                        del pcache[e][min(pcache[e], key=pcache[e].get)]
            res.prefill_tokens += prefill
            res.prefill_by_job[task.job_id] = (
                res.prefill_by_job.get(task.job_id, 0.0) + prefill
            )
            return prefill

        def llm_batch(e: int) -> int:
            return len(llm_running[e])

        def advance_llm(dt: float) -> None:
            if dt <= 0:
                return
            for e in range(self.n_llm):
                b = llm_batch(e)
                if b == 0:
                    continue
                # tokens/sec per request; the tier's latency_scale
                # stretches l(b) (×1.0 exactly for single-tier pools)
                rate = 1.0 / (self.profile.l(b) * self._lat_scale[e])
                for rt in llm_running[e]:
                    rt.remaining_tokens -= dt * rate

        def next_llm_completion() -> Tuple[float, Optional[RunningLLMTask]]:
            best_t, best = math.inf, None
            for e in range(self.n_llm):
                b = llm_batch(e)
                if b == 0:
                    continue
                per_tok = self.profile.l(b) * self._lat_scale[e]
                for rt in llm_running[e]:
                    t = now + max(0.0, rt.remaining_tokens) * per_tok
                    if t < best_t:
                        best_t, best = t, rt
            return best_t, best

        def next_regular_completion() -> Tuple[float, int]:
            best_t, best_e = math.inf, -1
            for e, slot in enumerate(reg_running):
                if slot is not None and slot[0] < best_t:
                    best_t, best_e = slot[0], e
            return best_t, best_e

        def kv_usage(e: int) -> float:
            """Decoded tokens currently cached on replica ``e``.

            Clamped per task to [0, out_tokens]: the migration stall is
            charged as extra ``remaining_tokens``, which must not show
            up as negative KV usage on the destination.
            """
            return sum(
                max(
                    0.0,
                    rt.task.out_tokens - max(0.0, rt.remaining_tokens),
                )
                for rt in llm_running[e]
            )

        def kv_headroom(e: int) -> Optional[float]:
            if self._kv is None:
                return None
            return self._kv[e] - kv_usage(e)

        def sheddable_victim(e: int) -> Optional[RunningLLMTask]:
            """Youngest task on ``e`` holding KV — never the oldest.

            The oldest task is exempt (it may legitimately outgrow the
            budget alone and must run to completion), the exact progress
            guarantee the paged engine's strict-age eviction provides.
            """
            for rt in reversed(llm_running[e][1:]):
                if rt.task.out_tokens - max(0.0, rt.remaining_tokens) > 0:
                    return rt
            return None

        def next_kv_overflow() -> Tuple[float, int]:
            """Earliest time a replica's KV usage reaches its budget."""
            if self._kv is None:
                return math.inf, -1
            best_t, best_e = math.inf, -1
            for e in range(self.n_llm):
                b = llm_batch(e)
                if b < 2:
                    continue  # a lone request always runs to completion
                head = self._kv[e] - kv_usage(e)
                if head <= 0:
                    if sheddable_victim(e) is not None:
                        return now, e  # already over: relieve immediately
                    continue  # only the exempt oldest holds KV
                # usage grows at b tasks x 1/(l(b)·scale) tokens/s each
                t = now + head * self.profile.l(b) * self._lat_scale[e] / b
                if t < best_t:
                    best_t, best_e = t, e
            return best_t, best_e

        def relieve_kv(e: int) -> None:
            """Replica ``e`` hit its KV budget: shed youngest tasks until a
            relief quantum of headroom exists (the paged engine frees whole
            pages, not single tokens — the quantum prevents an event storm
            of ever-smaller evictions).  Each victim is live-migrated to
            the peer with the most KV headroom when ``migrate=True`` and a
            fit exists, else preempted (recompute restart — its decoded
            tokens are lost), mirroring the paged engine's LIFO eviction.
            """
            quantum = self.kv_relief_quantum
            cost_tokens = self.migration_cost_s / self.profile.l(1)
            while (kv_headroom(e) or 0.0) < quantum:
                victim = sheddable_victim(e)  # youngest holder, never oldest
                if victim is None:
                    return  # nothing sheddable holds KV
                used = victim.task.out_tokens - max(0.0, victim.remaining_tokens)
                migrated = False
                if self.migrate:
                    best = None
                    for x in range(self.n_llm):
                        if x == e or llm_batch(x) >= self._mb[x]:
                            continue
                        head = kv_headroom(x)
                        if head is not None and head > used + cost_tokens + quantum:
                            if best is None or head > best[0]:
                                best = (head, x)
                    if best is not None:
                        llm_running[e].remove(victim)
                        victim.executor = best[1]
                        victim.remaining_tokens += cost_tokens
                        llm_running[best[1]].append(victim)
                        res.migrations += 1
                        migrated = True
                if not migrated:
                    llm_running[e].remove(victim)
                    victim.task.state = TaskState.PENDING
                    victim.task.start_time = -1.0
                    victim.remaining_tokens = float(victim.task.out_tokens)
                    job_by_id[victim.task.job_id].bump_evidence()
                    res.preemptions += 1

        def on_stage_complete(job: Job, stage: Stage) -> None:
            # chain reveals + dynamic expansion + evidence-version bump
            reveal_after_stage(job, stage, gens)

        def dispatch(dec: Decision) -> bool:
            did = False
            # regular
            for t in dec.regular:
                if t.state is not TaskState.PENDING:
                    continue
                for e in range(self.n_regular):
                    if reg_running[e] is None:
                        t.state = TaskState.RUNNING
                        t.start_time = now
                        job = job_by_id[t.job_id]
                        job.stages[t.stage_name].dispatched_tasks += 1
                        job.bump_evidence()  # running/unscheduled sets changed
                        dur = t.true_duration
                        if straggler_prob and self.rng.random() < straggler_prob:
                            dur *= 4.0 + 6.0 * self.rng.random()  # straggler
                        reg_running[e] = (now + dur, t)
                        did = True
                        break
            # llm: scheduler placement hint first (uncertainty/KV-aware),
            # falling back to least-loaded (paper §IV-D) — the exact
            # pre-placement behaviour for schedulers without hints
            for t in dec.llm:
                if t.state is not TaskState.PENDING:
                    continue
                def admissible(x: int) -> bool:
                    if llm_batch(x) >= self._mb[x]:
                        return False
                    if self._ranks is not None and self._ranks[x] < t.tier_floor:
                        return False  # cascade retry must run one tier up
                    head = kv_headroom(x)
                    return head is None or head >= self.kv_admission_reserve

                e = dec.replica_for(t)
                if e is None or not (0 <= e < self.n_llm) or not admissible(e):
                    loads = [
                        (llm_batch(x), x)
                        for x in range(self.n_llm)
                        if admissible(x)
                    ]
                    if not loads:
                        break
                    _, e = min(loads)
                t.state = TaskState.RUNNING
                t.start_time = now
                job = job_by_id[t.job_id]
                job.stages[t.stage_name].dispatched_tasks += 1
                job.bump_evidence()  # running/unscheduled sets changed
                # prompt prefill is charged as extra tokens at the batch
                # rate (the chunked-prefill-interleaved-with-decode model)
                prefill = charge_prefill(e, t)
                llm_running[e].append(
                    RunningLLMTask(
                        task=t,
                        remaining_tokens=float(t.out_tokens) + prefill,
                        executor=e,
                    )
                )
                did = True
            return did

        def rebalance() -> None:
            """Without KV budgets, ``migrate=True`` degrades to batch-gap
            balancing: move running LLM tasks from the most- to the
            least-loaded replica, each paying the KV-transfer stall as
            extra decode tokens at the batch-1 rate.  (With KV budgets,
            migration is driven by KV overflow instead — ``relieve_kv``.)
            """
            if not self.migrate or self.n_llm < 2 or self._kv is not None:
                return
            cost_tokens = self.migration_cost_s / self.profile.l(1)
            while True:
                bs = [llm_batch(e) for e in range(self.n_llm)]
                recv = [e for e in range(self.n_llm) if bs[e] < self._mb[e]]
                if not recv:
                    return
                e_max = max(range(self.n_llm), key=lambda e: bs[e])
                e_min = min(recv, key=lambda e: bs[e])
                if bs[e_max] - bs[e_min] < 2 or not llm_running[e_max]:
                    return
                rt = llm_running[e_max][-1]  # youngest dispatch (LIFO)
                llm_running[e_max].remove(rt)
                rt.executor = e_min
                rt.remaining_tokens += cost_tokens
                llm_running[e_min].append(rt)
                res.migrations += 1

        def invoke_scheduler() -> None:
            view = ClusterView.assemble(
                now=now,
                free_regular=sum(1 for s in reg_running if s is None),
                llm_loads=[
                    (llm_batch(e), self._mb[e]) for e in range(self.n_llm)
                ],
                latency_profile=self.profile,
                llm_free_tokens=(
                    None
                    if self._kv is None
                    else [
                        max(0, int(kv_headroom(e) or 0))
                        for e in range(self.n_llm)
                    ]
                ),
                llm_prefix_hit_tokens=(
                    [prefix_resident_tokens(e) for e in range(self.n_llm)]
                    if self.prefix_cache
                    else None
                ),
                llm_model_costs=self._tier_cost,
            )
            t0 = _time.perf_counter()
            dec = self.scheduler.schedule(active, view)
            res.sched_overhead_s.append(_time.perf_counter() - t0)
            dispatch(dec)
            rebalance()

        job_by_id = {j.job_id: j for j in jobs}

        # ---------------- event loop ----------------
        while ai < len(arrivals) or active:
            t_arr = arrivals[ai].arrival_time if ai < len(arrivals) else math.inf
            t_llm, llm_rt = next_llm_completion()
            t_reg, reg_e = next_regular_completion()
            t_kv, kv_e = next_kv_overflow()
            t_next = min(t_arr, t_llm, t_reg, t_fail, t_kv)
            if math.isinf(t_next):
                break  # deadlock guard (should not happen)
            dt = t_next - now
            advance_llm(dt)
            now = t_next

            if t_next == t_kv and kv_e >= 0:
                # KV pool overflow: live-migrate or preempt (LIFO)
                relieve_kv(kv_e)
            elif t_next == t_fail:
                # executor failure: requeue its running work (the tasks are
                # re-dispatched by the very next scheduling invocation —
                # checkpoint/restart at the scheduling layer)
                victim = int(self.rng.integers(0, n_exec))
                if victim < self.n_regular:
                    slot = reg_running[victim]
                    if slot is not None:
                        slot[1].state = TaskState.PENDING
                        slot[1].start_time = -1.0
                        job_by_id[slot[1].job_id].bump_evidence()
                        reg_running[victim] = None
                        res.preemptions += 1
                else:
                    e = victim - self.n_regular
                    for rt in llm_running[e]:
                        rt.task.state = TaskState.PENDING
                        rt.task.start_time = -1.0
                        job_by_id[rt.task.job_id].bump_evidence()
                        res.preemptions += 1
                    llm_running[e] = []
                t_fail = _next_failure(now)
            elif t_next == t_arr:
                job = arrivals[ai]
                ai += 1
                active.append(job)
            elif t_next == t_reg and reg_e >= 0:
                _, task = reg_running[reg_e]  # type: ignore[misc]
                reg_running[reg_e] = None
                if task.state is TaskState.DONE:
                    pass  # backup of an already-finished task: discard
                else:
                    self._finish_task(task, now, job_by_id, on_stage_complete,
                                      active, res)
                # cancel sibling copies (speculative execution: first wins)
                for e2, slot2 in enumerate(reg_running):
                    if slot2 is not None and slot2[1] is task:
                        reg_running[e2] = None
            elif llm_rt is not None:
                e = llm_rt.executor
                llm_running[e].remove(llm_rt)
                task = llm_rt.task
                if self._tier_cost is not None:
                    # every completed attempt pays its tier's price —
                    # including attempts the gate is about to reject
                    # (wasted spend is real spend)
                    res.cost_by_job[task.job_id] = (
                        res.cost_by_job.get(task.job_id, 0.0)
                        + task.out_tokens * self._tier_cost[e]
                    )
                if self.gate is not None:
                    app = job_by_id[task.job_id].app.name
                    ok = self.gate.passes(
                        app, task.stage_name, task.index,
                        task.attempt, self._tier_quality[e],
                    )
                    if (
                        not ok
                        and self.cascade
                        and self._ranks[e] < max(self._ranks)
                    ):
                        # cascade retry: back to PENDING one tier up;
                        # the prompt re-enters through dispatch and hits
                        # the destination's prefix cache where resident
                        task.tier_floor = self._ranks[e] + 1
                        task.attempt += 1
                        task.state = TaskState.PENDING
                        task.start_time = -1.0
                        job_by_id[task.job_id].bump_evidence()
                        res.escalations += 1
                    else:
                        # accepted, or rejected with nowhere to go
                        # (top tier / no cascade): output stands, the
                        # job's quality records the verdict
                        res.quality_by_job[task.job_id] = (
                            res.quality_by_job.get(task.job_id, True) and ok
                        )
                        self._finish_task(
                            task, now, job_by_id, on_stage_complete,
                            active, res,
                        )
                else:
                    self._finish_task(
                        task, now, job_by_id, on_stage_complete, active, res
                    )

            # straggler mitigation: speculatively re-issue regular tasks
            # that exceed straggler_factor x their nominal duration on a
            # free executor (first finisher wins)
            if self.straggler_factor > 0:
                running_ids = {id(s[1]) for s in reg_running if s is not None}
                for e, slot in enumerate(reg_running):
                    if slot is None:
                        continue
                    deadline, task = slot
                    overdue = now - task.start_time > (
                        self.straggler_factor * max(task.true_duration, 1e-9)
                    )
                    dup_exists = sum(
                        1 for s2 in reg_running
                        if s2 is not None and s2[1] is task
                    ) > 1
                    if overdue and not dup_exists:
                        for e2 in range(self.n_regular):
                            if reg_running[e2] is None:
                                reg_running[e2] = (now + task.true_duration, task)
                                res.reissues += 1
                                break

            invoke_scheduler()

        res.makespan = now
        res.retractions = int(getattr(self.scheduler, "retractions", 0))
        return res

    def _finish_task(
        self,
        task: Task,
        now: float,
        job_by_id: Dict[int, Job],
        on_stage_complete: Callable[[Job, Stage], None],
        active: List[Job],
        res: SimResult,
    ) -> None:
        task.state = TaskState.DONE
        task.finish_time = now
        job = job_by_id[task.job_id]
        job.bump_evidence()  # new completed-duration evidence
        stage = job.stages[task.stage_name]
        if stage.done():
            on_stage_complete(job, stage)
        if job.done():
            job.finish_time = now
            res.jcts.append(job.jct())
            res.jct_by_job[job.job_id] = job.jct()
            if job.slo is not None:
                res.tier_by_job[job.job_id] = job.slo.tier
                res.deadline_by_job[job.job_id] = job.slo.deadline
                met = job.met_slo()
                if met is not None:
                    res.slo_met_by_job[job.job_id] = met
            if job in active:
                active.remove(job)
            self.scheduler.observe_completion(job, now)


# ---------------------------------------------------------------------------
# Cluster sizing (paper §V: resources set for ~85% average load)
# ---------------------------------------------------------------------------
def configure_cluster(
    mix: str,
    arrival_rate: float = 0.9,
    target_load: float = 0.85,
    max_batch: int = 8,
    profile: Optional[LatencyProfile] = None,
    probe_jobs: int = 300,
    seed: int = 99,
) -> Dict[str, int]:
    """Pick (n_llm, n_regular) so offered load ≈ ``target_load``.

    Offered LLM load = token arrival rate ÷ executor token throughput at
    full batch; regular load = task-seconds per second.
    """
    from .workloads import generate_workload

    profile = profile or default_latency_profile(max_batch)
    wl = generate_workload(mix, probe_jobs, arrival_rate, seed=seed)
    span = max(gj.job.arrival_time for gj in wl) - min(
        gj.job.arrival_time for gj in wl
    )
    span = max(span, 1e-9)
    llm_tokens = 0.0
    reg_seconds = 0.0
    for gj in wl:
        for st in gj.job.stages.values():
            for t in st.tasks:
                if not st.will_execute:
                    continue
                if t.is_llm:
                    llm_tokens += t.out_tokens
                else:
                    reg_seconds += t.true_duration
        for dyn, durs in getattr(gj.job, "_dyn_durs", {}).items():
            pass  # inner dynamic tasks already counted via stages after expand
        for dname, (cands, _) in gj.job.dynamic_realization.items():
            gen_durs = getattr(gj.job, "_dyn_durs", {}).get(dname, {})
            for c in cands:
                d = gen_durs.get(c, 0.0)
                # planning inner stages: LLM candidates expressed in seconds
                reg_seconds += d  # conservative: treat as regular-side load
    tok_rate = llm_tokens / span
    reg_rate = reg_seconds / span
    # search (n_llm, max_batch) for the load closest to target; prefer few,
    # large executors (a vLLM-style engine per accelerator, not one slot
    # per request) — ties broken toward larger batches / fewer engines.
    best = None
    for mb in (16, 8, 4):
        if profile.batch_sizes.max() < mb:
            continue
        thr = mb / profile.l(mb)
        for n in range(1, 33):
            load = tok_rate / (n * thr)
            if load > 1.02:  # refuse unstable configs
                continue
            score = (abs(load - target_load), n, -mb)
            if best is None or score < best[0]:
                best = (score, n, mb, load)
    _, n_llm, mb, _ = best if best else ((0,), 1, max_batch, 1.0)
    n_regular = max(2, math.ceil(reg_rate / target_load))
    return {"n_llm": n_llm, "n_regular": n_regular, "max_batch": mb}


# ---------------------------------------------------------------------------
# Convenience runner
# ---------------------------------------------------------------------------
def simulate(
    scheduler: Scheduler,
    mix: str = "mixed",
    n_jobs: int = 100,
    arrival_rate: float = 0.9,
    n_regular: int = 4,
    n_llm: int = 1,
    max_batch: int = 8,
    seed: int = 0,
    **kw,
) -> SimResult:
    from .workloads import generate_workload

    wl = generate_workload(mix, n_jobs, arrival_rate, seed=seed)
    sim = ClusterSim(
        scheduler,
        n_regular=n_regular,
        n_llm=n_llm,
        max_batch=max_batch,
        seed=seed,
        **kw,
    )
    return sim.run(wl)
