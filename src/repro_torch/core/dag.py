"""DAG-based model for compound LLM applications (paper §IV-A).

A compound LLM application is a DAG whose nodes are *stages* and whose
edges are input→output dependencies.  Three stage types:

- ``REGULAR``  : one or more non-LLM tasks, run on regular executors.
- ``LLM``      : one or more LLM inference tasks, run on LLM executors
                 (batched, up to the executor's max batch size).
- ``DYNAMIC``  : placeholder for LLM-generated stages + dependencies,
                 realized at runtime from a *candidate set* once the
                 preceding LLM stage completes.

Chain-like applications are *padded* to their maximum iteration count
(paper §IV-A); stages of skipped iterations simply never execute (their
duration is 0 — the BN models this with a dedicated "not executed" bin).
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple


class StageType(enum.Enum):
    REGULAR = "regular"
    LLM = "llm"
    DYNAMIC = "dynamic"


#: Recognized SLO tiers, strictest first.  ``interactive`` jobs are
#: deadline-boosted whenever their deadline falls inside the scheduler's
#: plan-ahead window; ``batch`` jobs only once their worst-case duration
#: bound projects a miss; ``best_effort`` jobs are never boosted (their
#: deadline only matters for goodput accounting and infeasibility
#: demotion).
SLO_TIERS = ("interactive", "batch", "best_effort")


@dataclass(frozen=True)
class SLO:
    """Service-level objective attached to a :class:`Job`.

    Attributes
    ----------
    tier : str
        One of :data:`SLO_TIERS` — controls how aggressively the
        scheduler boosts the job as its deadline approaches.
    deadline : float
        Absolute completion deadline in workload seconds (same clock as
        ``Job.arrival_time``).  A job *meets* its SLO when
        ``finish_time <= deadline``.
    """

    tier: str
    deadline: float

    def __post_init__(self) -> None:
        if self.tier not in SLO_TIERS:
            raise ValueError(
                f"unknown SLO tier {self.tier!r}; expected one of {SLO_TIERS}"
            )


@dataclass
class StageTemplate:
    """Static description of a stage inside an application template."""

    name: str
    stype: StageType
    num_tasks: int = 1
    # For DYNAMIC stages: candidate stage names the planner LLM may emit,
    # and the possible edges between them.
    candidates: Tuple[str, ...] = ()
    candidate_edges: Tuple[Tuple[str, str], ...] = ()
    # Marginal execution probability (used for entropy of regular stages
    # and for padding chains); refined by the BN profiler from history.
    exec_prob: float = 1.0


@dataclass
class ApplicationTemplate:
    """An application = template DAG over stage templates.

    ``edges`` are (parent_name, child_name) pairs.  Stage IDs are assigned
    in topological order (paper Fig. 4 numbering).
    """

    name: str
    stages: List[StageTemplate]
    edges: List[Tuple[str, str]]

    def __post_init__(self) -> None:
        self._by_name: Dict[str, StageTemplate] = {s.name: s for s in self.stages}
        if len(self._by_name) != len(self.stages):
            raise ValueError(f"duplicate stage names in template {self.name}")
        for u, v in self.edges:
            if u not in self._by_name or v not in self._by_name:
                raise ValueError(f"edge ({u},{v}) references unknown stage")
        self._topo = self._topo_sort()
        self.stage_ids: Dict[str, int] = {n: i for i, n in enumerate(self._topo)}

    # -- graph helpers -----------------------------------------------------
    def _topo_sort(self) -> List[str]:
        indeg = {s.name: 0 for s in self.stages}
        adj: Dict[str, List[str]] = {s.name: [] for s in self.stages}
        for u, v in self.edges:
            adj[u].append(v)
            indeg[v] += 1
        # Stable Kahn: preserve declaration order among ready nodes.
        order: List[str] = []
        ready = [s.name for s in self.stages if indeg[s.name] == 0]
        while ready:
            n = ready.pop(0)
            order.append(n)
            for m in adj[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(self.stages):
            raise ValueError(f"cycle detected in template {self.name}")
        return order

    def parents(self, name: str) -> List[str]:
        return [u for u, v in self.edges if v == name]

    def children(self, name: str) -> List[str]:
        return [v for u, v in self.edges if u == name]

    def stage(self, name: str) -> StageTemplate:
        return self._by_name[name]

    def topo_order(self) -> List[str]:
        return list(self._topo)

    def descendants(self, name: str) -> Set[str]:
        out: Set[str] = set()
        frontier = [name]
        while frontier:
            n = frontier.pop()
            for c in self.children(n):
                if c not in out:
                    out.add(c)
                    frontier.append(c)
        return out


class TaskState(enum.Enum):
    PENDING = 0
    RUNNING = 1
    DONE = 2


@dataclass
class Task:
    """A runtime task — the schedulable unit."""

    job_id: int
    stage_name: str
    index: int
    is_llm: bool
    # Ground-truth duration at batch size 1 (sim) / realized at runtime
    # (testbed).  Hidden from the scheduler until completion.
    true_duration: float = 0.0
    state: TaskState = TaskState.PENDING
    start_time: float = -1.0
    finish_time: float = -1.0
    # Populated for LLM tasks: number of output tokens (drives batching-
    # aware calibration in the simulator).
    out_tokens: int = 0
    # Cascade state (heterogeneous pools only; inert defaults elsewhere):
    # a failed quality gate re-enqueues the task with its minimum model-
    # tier *cost rank* raised one above the tier that failed, and bumps
    # the attempt counter that keys the gate's deterministic draws.
    tier_floor: int = 0
    attempt: int = 0


@dataclass
class Stage:
    """Runtime instance of a stage template within a job."""

    job_id: int
    template: StageTemplate
    tasks: List[Task] = field(default_factory=list)
    # Whether this stage will actually execute in this job (chains may stop
    # early; dynamic stages may not select a candidate).  Hidden from the
    # scheduler until revealed.
    will_execute: bool = True
    revealed: bool = False          # structure known to the scheduler?
    dispatched_tasks: int = 0       # how many tasks handed to executors

    @property
    def name(self) -> str:
        return self.template.name

    @property
    def stype(self) -> StageType:
        return self.template.stype

    def done(self) -> bool:
        """Ground-truth completion (simulator/runtime internal)."""
        return self.will_execute is False or (
            len(self.tasks) > 0 and all(t.state is TaskState.DONE for t in self.tasks)
        )

    def obs_done(self) -> bool:
        """Observable completion — what a scheduler may act on.  A stage
        that will never execute counts only once that fact is *revealed*;
        otherwise skipped-at-runtime chains would leak their length."""
        if self.revealed and not self.will_execute:
            return True
        return len(self.tasks) > 0 and all(
            t.state is TaskState.DONE for t in self.tasks
        )

    def running(self) -> bool:
        return any(t.state is TaskState.RUNNING for t in self.tasks)

    def pending_tasks(self) -> List[Task]:
        return [t for t in self.tasks if t.state is TaskState.PENDING]

    def duration(self) -> float:
        """Realized duration (max finish - min start over tasks); 0 if skipped."""
        if not self.will_execute:
            return 0.0
        ts = [t for t in self.tasks if t.state is TaskState.DONE]
        if not ts:
            return 0.0
        return max(t.finish_time for t in ts) - min(t.start_time for t in ts)


_job_counter = itertools.count()


@dataclass
class Job:
    """Runtime instance of an application with a specific user input."""

    app: ApplicationTemplate
    arrival_time: float
    job_id: int = field(default_factory=lambda: next(_job_counter))
    stages: Dict[str, Stage] = field(default_factory=dict)
    # Realized dynamic-stage expansions: stage name -> (chosen candidates,
    # chosen edges).  Populated by the workload generator; revealed to the
    # scheduler only when the parent LLM stage finishes.
    dynamic_realization: Dict[str, Tuple[Tuple[str, ...], Tuple[Tuple[str, str], ...]]] = field(
        default_factory=dict
    )
    # Parents of stages created at runtime (dynamic-stage expansion) and
    # extra parents grafted onto template stages (e.g. a dynamic stage's
    # children must wait for the expanded inner stages).
    extra_parents: Dict[str, List[str]] = field(default_factory=dict)
    # trigger stage name -> stage names whose existence it reveals (chains)
    reveal_rules: Dict[str, List[str]] = field(default_factory=dict)
    # Optional service-level objective (tier + absolute deadline).  None
    # (default) keeps the job deadline-blind: SLO-aware schedulers must
    # emit byte-identical decisions for workloads where every job is
    # SLO-less (golden-trajectory guarded).
    slo: Optional[SLO] = None
    finish_time: float = -1.0
    # Monotonic counter bumped by the runtime on every event that changes
    # this job's *observable* state (task dispatch/completion, stage
    # reveal, dynamic expansion, failure requeue).  Incremental schedulers
    # key their cross-round caches on it: while the version is unchanged,
    # BN evidence, remaining-duration bases, duration bounds, and
    # uncertainty-reduction scores are all provably stale-free.
    evidence_version: int = 0

    def bump_evidence(self) -> None:
        """Record an observable-state change (invalidates cached estimates)."""
        self.evidence_version += 1

    # -- dependency/readiness ---------------------------------------------
    def parents_of(self, name: str) -> List[str]:
        tpl = self.app.parents(name) if name in self.app.stage_ids else []
        return tpl + [p for p in self.extra_parents.get(name, []) if p not in tpl]

    def stage_ready(self, name: str, now_done: Optional[Set[str]] = None) -> bool:
        """A stage is ready when every parent that *will execute* is done.

        Stages whose existence has not yet been revealed (chain iterations
        beyond the frontier, unexpanded dynamic stages) are never ready —
        the scheduler cannot see work it does not know exists.
        """
        st = self.stages[name]
        if st.done() or not st.will_execute or not st.revealed:
            return False
        if not st.pending_tasks():  # fully dispatched (possibly still running)
            return False
        for p in self.parents_of(name):
            ps = self.stages.get(p)
            if ps is None:
                continue
            if ps.will_execute and not ps.done():
                return False
        return True

    def _stage_order(self) -> List[str]:
        tpl = [n for n in self.app.topo_order() if n in self.stages]
        extra = [n for n in self.stages if n not in self.app.stage_ids]
        return tpl + extra

    def ready_stages(self) -> List[Stage]:
        return [self.stages[n] for n in self._stage_order() if self.stage_ready(n)]

    def unfinished_stages(self) -> List[Stage]:
        return [
            s for s in self.stages.values() if s.will_execute and not s.done()
        ]

    def done(self) -> bool:
        return all(s.done() for s in self.stages.values())

    def jct(self) -> float:
        return self.finish_time - self.arrival_time

    def met_slo(self, time_scale: float = 1.0) -> Optional[bool]:
        """Whether the finished job met its deadline.

        ``time_scale`` maps workload-clock deadlines onto a compressed
        runtime clock (the testbed divides arrivals by its time scale);
        the simulator uses the workload clock directly (scale 1).
        Returns ``None`` for SLO-less jobs.
        """
        if self.slo is None:
            return None
        return self.finish_time >= 0 and (
            self.finish_time <= self.slo.deadline / time_scale
        )

    # -- observable state for the scheduler --------------------------------
    def completed_durations(self) -> Dict[str, float]:
        """Evidence set E: batch-1-normalized durations of (partially)
        completed stages.

        LLM task durations observed at runtime are stretched by batching
        and queueing; the BN is trained on batch-1 service durations, so
        evidence uses the token-derived b=1 equivalent (out_tokens × l(1),
        carried as ``true_duration``).  Stages with *some* finished tasks
        contribute provisional evidence — this is what makes the paper's
        task-sampling exploration (ratio r) informative before the whole
        stage completes.
        """
        out = {}
        for n, s in self.stages.items():
            if not s.revealed or not s.will_execute or not s.tasks:
                continue
            done = [t for t in s.tasks if t.state is TaskState.DONE]
            if done:
                out[n] = float(sum(t.true_duration for t in done) / len(done))
        return out

    def observed_skips(self) -> Dict[str, bool]:
        """Stages revealed as will-not-execute (chains that stopped)."""
        return {
            n: False
            for n, s in self.stages.items()
            if s.revealed and not s.will_execute
        }


def make_job(app: ApplicationTemplate, arrival_time: float) -> Job:
    """Instantiate a job skeleton (all stages, nothing revealed yet)."""
    job = Job(app=app, arrival_time=arrival_time)
    for st in app.stages:
        stage = Stage(job_id=job.job_id, template=st)
        stage.tasks = [
            Task(
                job_id=job.job_id,
                stage_name=st.name,
                index=i,
                is_llm=(st.stype is StageType.LLM),
            )
            for i in range(st.num_tasks)
        ]
        job.stages[st.name] = stage
    return job
