"""Baseline schedulers (paper §V "Baselines").

- FCFS     : arrival order (Spark default).
- Fair     : equal share across running jobs (round-robin interleave).
- SJF      : shortest estimated *total* duration first (historical app mean).
- SRTF     : shortest estimated *remaining* time first (static estimates).
- Argus    : stage rank by depth / #children / #tasks (Wu et al., IPDPS'21).
- Carbyne  : altruistic — SRTF order, leftover capacity redistributed fairly.
- Decima   : RL (REINFORCE) over per-stage features; schedules one stage
             per invocation (the behaviour the paper calls out for
             planning workloads).

All baselines receive the *same* prior information the paper grants them:
historical mean durations per application and the template DAG structure.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .dag import Job, Stage, Task
from .profiler import ProfileStore
from .scheduler import ClusterView, Decision, Scheduler


def _attach(dec: Decision, tasks: Sequence[Task]) -> None:
    for t in tasks:
        (dec.llm if t.is_llm else dec.regular).append(t)


class FCFS(Scheduler):
    name = "fcfs"

    def schedule(self, jobs: Sequence[Job], view: ClusterView) -> Decision:
        dec = Decision()
        for job in sorted(jobs, key=lambda j: (j.arrival_time, j.job_id)):
            for stage in job.ready_stages():
                _attach(dec, stage.pending_tasks())
        return dec


class Fair(Scheduler):
    name = "fair"

    def schedule(self, jobs: Sequence[Job], view: ClusterView) -> Decision:
        dec = Decision()
        queues: List[List[Task]] = []
        for job in sorted(jobs, key=lambda j: (j.arrival_time, j.job_id)):
            q: List[Task] = []
            for stage in job.ready_stages():
                q.extend(stage.pending_tasks())
            if q:
                queues.append(q)
        # round-robin one task per job per round: equal share
        while any(queues):
            for q in queues:
                if q:
                    _attach(dec, [q.pop(0)])
        return dec


class SJF(Scheduler):
    """Shortest (total historical) Job First."""

    name = "sjf"

    def __init__(self, profiles: ProfileStore) -> None:
        self.profiles = profiles

    def _job_key(self, job: Job) -> float:
        p = self.profiles.get(job.app.name)
        return p.mean_duration if p else float("inf")

    def schedule(self, jobs: Sequence[Job], view: ClusterView) -> Decision:
        dec = Decision()
        for job in sorted(jobs, key=lambda j: (self._job_key(j), j.arrival_time)):
            for stage in job.ready_stages():
                _attach(dec, stage.pending_tasks())
        return dec


class SRTF(SJF):
    """Shortest Remaining Time First with *static* per-stage estimates
    (no BN posterior — that distinction belongs to LLMSched)."""

    name = "srtf"

    def _job_key(self, job: Job) -> float:
        p = self.profiles.get(job.app.name)
        if p is None or not p._fitted:
            return float("inf")
        rem = 0.0
        for s in job.stages.values():
            if s.obs_done():
                continue
            d = p.discretizers.get(s.name)
            if d is not None:
                prior = p.bn.marginal(s.name, {}) if p.bn.nodes else None
                rem += d.expectation(prior) if prior is not None else 1.0
            else:
                rem += 1.0
        return rem


class Argus(Scheduler):
    """Stage-rank scheduler: prefer stages that unlock more downstream work
    — more children, more tasks, smaller depth (root-side) first."""

    name = "argus"

    def __init__(self, profiles: Optional[ProfileStore] = None) -> None:
        self.profiles = profiles

    @staticmethod
    def _depth(job: Job, stage: Stage) -> int:
        app = job.app
        depth = 0
        frontier = [stage.name]
        seen = set()
        while frontier:
            nxt = []
            for n in frontier:
                for p in app.parents(n):
                    if p not in seen:
                        seen.add(p)
                        nxt.append(p)
            if nxt:
                depth += 1
            frontier = nxt
        return depth

    def schedule(self, jobs: Sequence[Job], view: ClusterView) -> Decision:
        dec = Decision()
        ranked: List[Tuple[Tuple, Stage]] = []
        for job in jobs:
            for stage in job.ready_stages():
                n_children = len(job.app.children(stage.name))
                key = (
                    self._depth(job, stage),          # shallow first
                    -n_children,                      # more children first
                    -len(stage.pending_tasks()),      # more tasks first
                    job.arrival_time,
                )
                ranked.append((key, stage))
        for _, stage in sorted(ranked, key=lambda t: t[0]):
            _attach(dec, stage.pending_tasks())
        return dec


class Carbyne(Scheduler):
    """Altruistic scheduling (simplified): jobs ordered SRTF, but each job
    initially claims only what its current critical path needs (one wave);
    leftover tasks are redistributed round-robin (the "altruism")."""

    name = "carbyne"

    def __init__(self, profiles: ProfileStore) -> None:
        self.profiles = profiles
        self._srtf = SRTF(profiles)

    def schedule(self, jobs: Sequence[Job], view: ClusterView) -> Decision:
        dec = Decision()
        ordered = sorted(
            jobs, key=lambda j: (self._srtf._job_key(j), j.arrival_time)
        )
        leftovers: List[List[Task]] = []
        for job in ordered:
            for stage in job.ready_stages():
                pend = stage.pending_tasks()
                # claim one wave: as many tasks as the stage strictly needs
                # to keep its critical path moving (1 task), donate the rest
                _attach(dec, pend[:1])
                if pend[1:]:
                    leftovers.append(pend[1:])
        while any(leftovers):
            for q in leftovers:
                if q:
                    _attach(dec, [q.pop(0)])
        return dec


# ---------------------------------------------------------------------------
# Decima (RL baseline)
# ---------------------------------------------------------------------------
class DecimaPolicy:
    """Tiny 2-layer MLP scoring stages from hand features (numpy)."""

    N_FEATURES = 6

    def __init__(self, hidden: int = 16, seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        self.w1 = rng.normal(0, 0.5, (self.N_FEATURES, hidden))
        self.b1 = np.zeros(hidden)
        self.w2 = rng.normal(0, 0.5, (hidden, 1))
        self.b2 = np.zeros(1)

    def params(self) -> List[np.ndarray]:
        return [self.w1, self.b1, self.w2, self.b2]

    def scores(self, feats: np.ndarray) -> np.ndarray:
        h = np.tanh(feats @ self.w1 + self.b1)
        return (h @ self.w2 + self.b2).ravel()

    def grad_log_softmax(self, feats: np.ndarray, action: int) -> List[np.ndarray]:
        """∇ log π(action | feats) for REINFORCE."""
        h_pre = feats @ self.w1 + self.b1
        h = np.tanh(h_pre)
        s = (h @ self.w2 + self.b2).ravel()
        p = np.exp(s - s.max())
        p /= p.sum()
        # d log p[a] / d s = onehot(a) - p
        ds = -p
        ds[action] += 1.0
        dw2 = h.T @ ds[:, None]
        db2 = np.array([ds.sum()])
        dh = ds[:, None] @ self.w2.T
        dpre = dh * (1 - h * h)
        dw1 = feats.T @ dpre
        db1 = dpre.sum(axis=0)
        return [dw1, db1, dw2, db2]


class Decima(Scheduler):
    """REINFORCE-trained neural scheduler; picks ONE stage per invocation."""

    name = "decima"

    def __init__(self, profiles: ProfileStore, seed: int = 0, train: bool = False):
        self.profiles = profiles
        self.policy = DecimaPolicy(seed=seed)
        self.rng = np.random.default_rng(seed + 1)
        self.train = train
        self.trajectory: List[Tuple[np.ndarray, int]] = []

    def _features(self, job: Job, stage: Stage, now: float) -> np.ndarray:
        p = self.profiles.get(job.app.name)
        est = 1.0
        if p and p._fitted and stage.name in p.discretizers:
            d = p.discretizers[stage.name]
            est = float(d.repr_value.mean())
        rem = p.mean_duration if p else 1.0
        return np.array(
            [
                math.log1p(rem),
                math.log1p(est),
                len(stage.pending_tasks()) / 8.0,
                len(job.app.children(stage.name)) / 4.0,
                math.log1p(max(0.0, now - job.arrival_time)),
                1.0 if stage.stype.value == "llm" else 0.0,
            ]
        )

    def schedule(self, jobs: Sequence[Job], view: ClusterView) -> Decision:
        dec = Decision()
        cands: List[Stage] = []
        feats: List[np.ndarray] = []
        for job in jobs:
            for stage in job.ready_stages():
                cands.append(stage)
                feats.append(self._features(job, stage, view.now))
        if not cands:
            return dec
        f = np.stack(feats)
        s = self.policy.scores(f)
        if self.train:
            p = np.exp(s - s.max())
            p /= p.sum()
            a = int(self.rng.choice(len(cands), p=p))
            self.trajectory.append((f, a))
        else:
            a = int(np.argmax(s))
        # Decima schedules the tasks of only one stage at a time.
        _attach(dec, cands[a].pending_tasks())
        return dec

    # -- REINFORCE ----------------------------------------------------------
    def finish_episode(self, neg_avg_jct: float, lr: float = 1e-3) -> None:
        """Policy-gradient update with episode return = -avg JCT."""
        if not self.trajectory:
            return
        grads = [np.zeros_like(p) for p in self.policy.params()]
        for f, a in self.trajectory:
            g = self.policy.grad_log_softmax(f, a)
            for acc, gi in zip(grads, g):
                acc += gi
        for p, g in zip(self.policy.params(), grads):
            p += lr * neg_avg_jct * g / len(self.trajectory)
        self.trajectory.clear()


def make_baselines(profiles: ProfileStore) -> Dict[str, Scheduler]:
    return {
        "fcfs": FCFS(),
        "fair": Fair(),
        "sjf": SJF(profiles),
        "argus": Argus(profiles),
        "carbyne": Carbyne(profiles),
        "decima": Decima(profiles),
    }
