"""Testbed runtime: compound LLM jobs over REAL engines (paper §V-B analog).

Port of ``repro/serving/cluster.py``; the event loop is the JAX
package's, unchanged.  Wall-clock event loop driving:
- ``n_llm`` engine replicas (:class:`LLMEngine` slot engines or
  :class:`~repro_torch.serving.paged_engine.PagedLLMEngine`, real
  decode on the engines' device);
- ``n_regular`` executor slots (deadline-based task completion);
- any :class:`repro_torch.core.scheduler.Scheduler` making admission decisions.

LLM tasks become engine requests whose token budget is the task's
``out_tokens`` (scaled by ``token_scale`` so CPU runs finish quickly);
the engines' *measured* l(b) feeds Eq. 2 calibration, closing the same
loop the paper's vLLM testbed closes.

Multi-replica serving: the cluster exposes per-replica batch load *and*
KV headroom to the scheduler (``ClusterView.llm_free_tokens``), honours
the scheduler's per-task placement hints (``Decision.placement``), and
— with ``migrate=True`` — runs a :class:`~repro_torch.serving.migration.
Rebalancer` each loop iteration to live-migrate decoding requests off
KV-starved paged replicas.

Prefix-cache fleets additionally report per-replica resident prefix
tokens (``ClusterView.llm_prefix_hit_tokens``) so cache-aware placement
can steer an application's tasks to the replica already holding its
shared system prompt; ``shared_prompt_tokens`` synthesizes exactly that
workload shape, and per-job prefill token totals are recorded for the
sim↔testbed cache-model parity canary.
"""

from __future__ import annotations

import math
import time
import zlib
from typing import List, Optional, Sequence, Tuple

from ..core.cascade import QualityGate, fleet_ranks
from ..core.dag import Job, Stage, Task, TaskState
from ..core.metrics import RunMetrics
from ..core.scheduler import ClusterView, Decision, Scheduler
from ..models.zoo import tier_spec
from ..sim.workloads import GeneratedJob, get_generators, reveal_after_stage
from .config import ServeConfig
from .engine import LLMEngine, Request
from .migration import Rebalancer

# Backwards-compatible alias: the testbed's historical result type is
# now the unified schema shared with the simulator.
TestbedResult = RunMetrics


class ServingCluster:
    """Wall-clock event loop over real engines + regular executors.

    Parameters
    ----------
    scheduler : Scheduler
        Admission/placement policy (LLMSched or any baseline).
    engines : list of LLMEngine or PagedLLMEngine
        The LLM replica fleet; may mix capacities (heterogeneous KV
        budgets).  Replicas must share weights for migration to be
        lossless.
    config : ServeConfig, optional
        Runtime configuration (executor slots, scaling factors, prompt
        synthesis, migration).  Defaults to ``ServeConfig()``.  Note
        the cluster consumes the *runtime* fields; fleet-shape fields
        (``engine``/``replicas``/``kv_pages``…) describe the supplied
        ``engines`` and are used by :func:`repro_torch.serving.build_engines`.
    rebalancer : Rebalancer, optional
        Custom policy instance; built with defaults when
        ``config.migrate`` is set and none is given.
    gate : QualityGate, optional
        Verifier run over every finished LLM task whose replica has
        known tier economics.  With ``config.cascade`` and a
        heterogeneous priced fleet, a rejection re-enqueues the task
        one cost tier up (``Task.tier_floor``); otherwise rejections
        mark the job in ``RunMetrics.quality_by_job``.  ``None``
        (default) disables gating — byte-identical to the historical
        cluster.
    """

    def __init__(
        self,
        scheduler: Scheduler,
        engines: List[LLMEngine],
        config: Optional[ServeConfig] = None,
        *,
        rebalancer: Optional[Rebalancer] = None,
        gate: Optional[QualityGate] = None,
    ) -> None:
        config = config or ServeConfig()
        self.config = config
        self.scheduler = scheduler
        self.engines = engines
        self.n_regular = config.n_regular
        self.token_scale = config.token_scale
        self.time_scale = config.time_scale
        self.min_tokens = config.min_tokens
        self.migrate = config.migrate
        self.rebalancer = rebalancer
        self.shared_prompt_tokens = int(config.shared_prompt_tokens)
        if self.migrate and self.rebalancer is None:
            self.rebalancer = Rebalancer(engines)
        self.gate = gate
        self.cascade = bool(config.cascade)
        # per-replica tier economics: None entries (models absent from
        # the zoo price table, e.g. ad-hoc test configs) gate the cost
        # signal off in ClusterView.assemble rather than invent a price
        self._tier_specs = [
            tier_spec(e.cfg.name) if getattr(e, "cfg", None) is not None
            else None
            for e in engines
        ]
        self._costs = [
            None if s is None else s.usd_per_mtok / 1e6
            for s in self._tier_specs
        ]
        # escalation floors need the whole fleet priced; same dense
        # cost-rank rule the scheduler applies, so runtime escalation
        # and scheduler placement agree on what "one tier up" means
        if self._costs and all(c is not None for c in self._costs):
            self._ranks: Optional[List[int]] = fleet_ranks(self._costs)
            self._rank_top = max(self._ranks)
        else:
            self._ranks = None
            self._rank_top = 0
        self._eidx = {id(e): i for i, e in enumerate(engines)}

    def _prompt_for(self, task: Task, app_name: str) -> List[int]:
        """Synthesize the engine prompt for an LLM task.

        With ``shared_prompt_tokens`` set, tasks of one application
        share a deterministic system-prompt prefix (page-alignable, so
        prefix-cache replicas deduplicate it) and differ only in a
        short stage/index suffix.  Uses ``zlib.crc32`` — not ``hash``
        — for the shared part so the token stream is stable across
        processes and runs.

        Parameters
        ----------
        task : Task
            The LLM task being dispatched.
        app_name : str
            The owning job's application template name.

        Returns
        -------
        list of int
            Token ids for the engine request.
        """
        if self.shared_prompt_tokens <= 0:
            return [1 + (hash(task.stage_name) % 32), 2 + task.index % 7]
        base = zlib.crc32(app_name.encode())
        sys_prompt = [
            1 + (base + 31 * k) % 97 for k in range(self.shared_prompt_tokens)
        ]
        return sys_prompt + [
            1 + (zlib.crc32(task.stage_name.encode()) % 32),
            2 + task.index % 7,
        ]

    def run(self, workload: Sequence[GeneratedJob]) -> TestbedResult:
        """Serve a compound-job workload to completion.

        Parameters
        ----------
        workload : sequence of GeneratedJob
            Jobs with arrival times (compressed by ``time_scale``).

        Returns
        -------
        TestbedResult
            JCTs, throughput, preemption and migration counters.
        """
        gens = get_generators()
        res = TestbedResult()
        t_start = time.perf_counter()

        def now() -> float:
            return time.perf_counter() - t_start

        jobs = sorted((gj.job for gj in workload), key=lambda j: j.arrival_time)
        # arrival times are compressed by time_scale as well
        arrivals = [(j.arrival_time / self.time_scale, j) for j in jobs]
        job_by_id = {j.job_id: j for j in jobs}
        active: List[Job] = []
        ai = 0
        reg_running: List[Optional[Tuple[float, Task]]] = [None] * self.n_regular
        rid_counter = [0]

        def on_stage_complete(job: Job, stage: Stage) -> None:
            # chain reveals + dynamic expansion + evidence-version bump
            reveal_after_stage(job, stage, gens)

        def finish_task(task: Task) -> None:
            task.state = TaskState.DONE
            task.finish_time = now()
            job = job_by_id[task.job_id]
            job.bump_evidence()  # new completed-duration evidence
            stage = job.stages[task.stage_name]
            if stage.done():
                on_stage_complete(job, stage)
            if job.done():
                job.finish_time = now()
                jct = job.finish_time - job.arrival_time / self.time_scale
                res.jcts.append(jct)
                res.jct_by_job[job.job_id] = jct
                if job.slo is not None:
                    res.tier_by_job[job.job_id] = job.slo.tier
                    res.deadline_by_job[job.job_id] = job.slo.deadline
                    met = job.met_slo(self.time_scale)
                    if met is not None:
                        res.slo_met_by_job[job.job_id] = met
                if job in active:
                    active.remove(job)
                self.scheduler.observe_completion(job, now())

        def dispatch(dec: Decision) -> None:
            for t in dec.regular:
                if t.state is not TaskState.PENDING:
                    continue
                placed = False
                for e in range(self.n_regular):
                    if reg_running[e] is None:
                        t.state = TaskState.RUNNING
                        t.start_time = now()
                        job = job_by_id[t.job_id]
                        job.stages[t.stage_name].dispatched_tasks += 1
                        job.bump_evidence()  # running/unscheduled sets changed
                        deadline = now() + t.true_duration / self.time_scale
                        reg_running[e] = (deadline, t)
                        placed = True
                        break
                if not placed:
                    break
            for t in dec.llm:
                if t.state is not TaskState.PENDING:
                    continue
                # scheduler placement hint first, then least-loaded
                # admissible engines (paper §IV-D); paged engines refuse
                # admission when their page pool is exhausted, so
                # placement is KV-capacity-aware and the scheduler's
                # dispatch order decides who gets the memory
                cands = [e for e in self.engines if e.can_admit()]
                if not cands:
                    break
                # cascade floor: an escalated task may only run on
                # replicas at or above its minimum cost rank (floors
                # only arise when the whole fleet is priced)
                if self._ranks is not None and t.tier_floor > 0:
                    cands = [
                        e for e in cands
                        if self._ranks[self._eidx[id(e)]] >= t.tier_floor
                    ]
                    if not cands:
                        continue  # eligible tiers busy; retry next round
                cands.sort(
                    key=lambda e: (
                        e.batch_size,
                        -getattr(e, "free_token_capacity", 0)
                        - getattr(e, "reclaimable_token_capacity", 0),
                    )
                )
                placed = dec.replica_for(t)
                if placed is not None and 0 <= placed < len(self.engines):
                    pe = self.engines[placed]
                    if pe in cands:
                        cands.remove(pe)
                        cands.insert(0, pe)
                rid_counter[0] += 1
                n_tok = max(self.min_tokens, int(t.out_tokens / self.token_scale))
                prompt = self._prompt_for(t, job_by_id[t.job_id].app.name)
                task = t

                # deadline-aware admission ordering: SLO jobs carry
                # their scaled deadline as the request priority, so a
                # paged engine drains its waiting queue EDF-first;
                # SLO-less requests keep priority=inf (pure FIFO, the
                # historical order, byte-for-byte)
                slo = job_by_id[t.job_id].slo
                req = Request(
                    rid=rid_counter[0],
                    prompt=prompt,
                    max_new_tokens=n_tok,
                    submitted_at=now(),
                    priority=(
                        math.inf if slo is None
                        else slo.deadline / self.time_scale
                    ),
                )
                # can_admit() is a cheap pre-filter; a paged engine may
                # still refuse a multi-page prompt, so fall through to
                # the next-best candidate before giving up on the task
                admitted = None
                for e in cands:
                    if e.admit(req):
                        admitted = e
                        break
                if admitted is None:
                    break  # no engine can take it; retry next round
                # on_finish needs the admitting replica's tier (cost
                # accounting + gate quality); assigning after admission
                # is safe — finishes only ever fire inside step()
                ei = self._eidx[id(admitted)]

                def _done(req: Request, task=task, ei=ei) -> None:
                    res.tokens_generated += len(req.out_tokens)
                    res.prefill_tokens += req.prefill_tokens
                    res.prefill_by_job[task.job_id] = (
                        res.prefill_by_job.get(task.job_id, 0)
                        + req.prefill_tokens
                    )
                    spec = self._tier_specs[ei]
                    if spec is not None:
                        # real spend: tokens actually generated on this
                        # attempt, at the serving replica's tier price
                        res.cost_by_job[task.job_id] = (
                            res.cost_by_job.get(task.job_id, 0.0)
                            + len(req.out_tokens) * spec.usd_per_mtok / 1e6
                        )
                    if self.gate is not None and spec is not None:
                        job = job_by_id[task.job_id]
                        ok = self.gate.passes(
                            job.app.name, task.stage_name, task.index,
                            task.attempt, spec.quality,
                        )
                        can_up = (
                            self.cascade
                            and self._ranks is not None
                            and self._ranks[ei] < self._rank_top
                        )
                        if not ok and can_up:
                            # cascade escalation: re-enqueue one cost
                            # tier up; the attempt bump re-keys the
                            # gate's deterministic draw
                            task.tier_floor = self._ranks[ei] + 1
                            task.attempt += 1
                            task.state = TaskState.PENDING
                            task.start_time = -1.0
                            job.bump_evidence()
                            res.escalations += 1
                            return
                        res.quality_by_job[task.job_id] = (
                            res.quality_by_job.get(task.job_id, True) and ok
                        )
                    finish_task(task)

                req.on_finish = _done
                t.state = TaskState.RUNNING
                t.start_time = now()
                job = job_by_id[t.job_id]
                job.stages[t.stage_name].dispatched_tasks += 1
                job.bump_evidence()  # running/unscheduled sets changed

        def view() -> ClusterView:
            prof = None
            for e in self.engines:
                prof = e.latency_profile() or prof
            # dormant prefix pages are reclaimable on admission, so a
            # cache-heavy replica must not read as KV-starved — that
            # would starve exactly the replica the cache-affinity term
            # wants to prefer (reclaimable is 0 without a prefix cache)
            free_tok = [
                None
                if getattr(e, "free_token_capacity", None) is None
                else e.free_token_capacity
                + getattr(e, "reclaimable_token_capacity", 0)
                for e in self.engines
            ]
            hit_tok = [
                getattr(e, "prefix_cached_tokens", None) for e in self.engines
            ]
            # assemble() owns the all-or-nothing gating (KV accounting /
            # cache-affinity only when every replica reports it)
            return ClusterView.assemble(
                now=now(),
                free_regular=sum(1 for s in reg_running if s is None),
                llm_loads=[(e.batch_size, e.max_batch) for e in self.engines],
                latency_profile=prof,
                llm_free_tokens=free_tok,
                llm_prefix_hit_tokens=hit_tok,
                llm_model_costs=self._costs,
            )

        # ------------------------- main loop -------------------------
        while ai < len(arrivals) or active:
            t = now()
            # arrivals
            while ai < len(arrivals) and arrivals[ai][0] <= t:
                active.append(arrivals[ai][1])
                ai += 1
            # regular completions
            for e in range(self.n_regular):
                slot = reg_running[e]
                if slot is not None and slot[0] <= t:
                    reg_running[e] = None
                    finish_task(slot[1])
            # schedule + dispatch
            t0 = time.perf_counter()
            dec = self.scheduler.schedule(active, view())
            res.sched_overhead_s.append(time.perf_counter() - t0)
            dispatch(dec)
            # live migration: relieve KV-starved replicas before stepping
            if self.migrate and self.rebalancer is not None:
                res.migrations += self.rebalancer.step()
            # decode step on each engine (the real compute); paged engines
            # also need steps to re-admit evicted (requeued) requests
            stepped = False
            for eng in self.engines:
                if eng.batch_size or getattr(eng, "waiting", ()):
                    eng.step()
                    stepped = True
            if not stepped:
                # idle: wait for next arrival or regular completion
                nxt = [arrivals[ai][0]] if ai < len(arrivals) else []
                nxt += [s[0] for s in reg_running if s is not None]
                if nxt:
                    time.sleep(max(0.0, min(nxt) - now()) + 1e-4)
                elif not active:
                    break
                else:
                    time.sleep(1e-3)
        res.makespan = now()
        res.preemptions = sum(getattr(e, "preemptions", 0) for e in self.engines)
        res.prefill_saved_tokens = sum(
            getattr(e, "prefill_skipped_tokens", 0) for e in self.engines
        )
        res.retractions = int(getattr(self.scheduler, "retractions", 0))
        return res
