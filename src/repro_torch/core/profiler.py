"""Application profiler: BN + discretizers + dynamic-stage statistics (§IV-B).

One :class:`AppProfile` per application template.  It is trained on a
history of job traces and provides everything the scheduler needs:

- posterior duration estimates per stage / per job (BN inference on the
  evidence of completed stages — including "revealed skipped" chain stages
  observed as bin 0);
- uncertainty-reduction scores R(X) (Eq. 6) incl. the dynamic-stage bonus;
- job-duration distribution intervals for the non-overlapping grouping
  (Algorithm 1 line 5);
- per-candidate duration means for realized dynamic stages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from .bayesnet import BayesNet, Discretizer, fit_discretizer
from .dag import ApplicationTemplate, Job, Stage, StageType
from .entropy import (
    dynamic_stage_entropy,
    uncertainty_reduction,
    uncertainty_reductions,
)


@dataclass
class JobTrace:
    """One historical execution of an application."""

    app_name: str
    durations: Dict[str, float]  # stage name -> duration (0.0 if skipped)
    # dyn stage -> (chosen candidates, chosen edges)
    dynamic: Dict[str, Tuple[Tuple[str, ...], Tuple[Tuple[str, str], ...]]] = field(
        default_factory=dict
    )
    # dyn stage -> {candidate: duration}
    dynamic_durations: Dict[str, Dict[str, float]] = field(default_factory=dict)


class AppProfile:
    def __init__(self, app: ApplicationTemplate) -> None:
        self.app = app
        self.bn = BayesNet()
        self.discretizers: Dict[str, Discretizer] = {}
        self.mean_duration: float = 0.0
        # dynamic-stage statistics
        self.candidate_probs: Dict[str, Dict[str, float]] = {}
        self.edge_probs: Dict[str, Dict[Tuple[str, str], float]] = {}
        self.candidate_mean_dur: Dict[str, Dict[str, float]] = {}
        self._dyn_entropy: Dict[str, float] = {}
        self._fitted = False
        # posterior caches — the paper's "lookup table" argument (§IV-D):
        # evidence sets recur across scheduling events, so memoised BN
        # queries make scheduling effectively O(1) per stage.
        self._marg_cache: Dict[Tuple, np.ndarray] = {}
        self._ur_cache: Dict[Tuple, float] = {}
        # ---- incremental (cross-round) per-job caches -------------------
        # Keyed by job_id, each slot stores (evidence_version, payload);
        # a stale version is simply overwritten, so memory stays O(active
        # jobs).  Entries are dropped via forget_job() on job completion.
        self._job_ev: Dict[int, Tuple[int, Dict[str, int]]] = {}
        # (job_id, use_bn) -> (version, done_names, base_estimates, has_running)
        self._job_base: Dict[Tuple[int, bool], Tuple] = {}
        # (job_id, use_bn) -> (version, calib_sig, mode, value)
        self._job_rd: Dict[Tuple[int, bool], Tuple] = {}
        # (job_id, use_bn) -> (version, (lo, hi))
        self._job_bounds: Dict[Tuple[int, bool], Tuple] = {}
        # job_id -> (version, {stage_name: R})
        self._job_ur: Dict[int, Tuple[int, Dict[str, float]]] = {}

    # ------------------------------------------------------------------ fit
    def fit(self, traces: Sequence[JobTrace], max_bins: int = 6,
            mi_threshold: float = 0.05, max_parents: int = 3) -> "AppProfile":
        names = self.app.topo_order()
        mat = np.zeros((len(traces), len(names)))
        for i, tr in enumerate(traces):
            for j, n in enumerate(names):
                mat[i, j] = tr.durations.get(n, 0.0)

        for j, n in enumerate(names):
            self.discretizers[n] = fit_discretizer(mat[:, j], max_bins=max_bins)

        binned = np.zeros_like(mat, dtype=np.int64)
        for j, n in enumerate(names):
            d = self.discretizers[n]
            binned[:, j] = [d.transform(x) for x in mat[:, j]]

        self.bn.fit(
            binned,
            names=names,
            cards=[self.discretizers[n].cardinality for n in names],
            template_edges=self.app.edges,
            mi_threshold=mi_threshold,
            max_parents=max_parents,
        )
        self.mean_duration = float(mat.sum(axis=1).mean())

        # dynamic-stage statistics from realized plans
        for st in self.app.stages:
            if st.stype is not StageType.DYNAMIC:
                continue
            n_tr = max(1, len(traces))
            cprob = {c: 0.0 for c in st.candidates}
            eprob = {e: 0.0 for e in st.candidate_edges}
            cdur: Dict[str, List[float]] = {c: [] for c in st.candidates}
            for tr in traces:
                chosen, edges = tr.dynamic.get(st.name, ((), ()))
                for c in chosen:
                    if c in cprob:
                        cprob[c] += 1.0
                for e in edges:
                    if tuple(e) in eprob:
                        eprob[tuple(e)] += 1.0
                for c, d in tr.dynamic_durations.get(st.name, {}).items():
                    if c in cdur:
                        cdur[c].append(d)
            self.candidate_probs[st.name] = {c: v / n_tr for c, v in cprob.items()}
            self.edge_probs[st.name] = {e: v / n_tr for e, v in eprob.items()}
            self.candidate_mean_dur[st.name] = {
                c: (float(np.mean(v)) if v else 1.0) for c, v in cdur.items()
            }
            self._dyn_entropy[st.name] = dynamic_stage_entropy(
                self.candidate_probs[st.name], self.edge_probs[st.name]
            )
        self._fitted = True
        return self

    # ------------------------------------------------------- evidence/query
    def evidence_for(self, job: Job, version: Optional[int] = None) -> Dict[str, int]:
        """BN evidence from this job's observable state.

        ``version`` (the job's ``evidence_version``) enables the
        cross-round cache: evidence is rebuilt only when the runtime has
        reported an observable-state change for this job.
        """
        if version is not None:
            hit = self._job_ev.get(job.job_id)
            if hit is not None and hit[0] == version:
                return hit[1]
        ev: Dict[str, int] = {}
        for name, dur in job.completed_durations().items():
            if name in self.discretizers:
                ev[name] = self.discretizers[name].transform(dur)
        for name in job.observed_skips():
            d = self.discretizers.get(name)
            if d is not None and d.has_zero_bin and name not in ev:
                ev[name] = 0
        if version is not None:
            self._job_ev[job.job_id] = (version, ev)
        return ev

    def forget_job(self, job_id: int) -> None:
        """Drop all per-job cache slots (call when a job leaves the system)."""
        self._job_ev.pop(job_id, None)
        self._job_ur.pop(job_id, None)
        for use_bn in (False, True):
            self._job_base.pop((job_id, use_bn), None)
            self._job_rd.pop((job_id, use_bn), None)
            self._job_bounds.pop((job_id, use_bn), None)

    @staticmethod
    def _ev_key(evidence: Mapping[str, int]) -> Tuple:
        return tuple(sorted(evidence.items()))

    def marginal(self, name: str, evidence: Mapping[str, int]) -> np.ndarray:
        key = (name, self._ev_key(evidence))
        out = self._marg_cache.get(key)
        if out is None:
            out = self.bn.marginal(name, evidence)
            self._marg_cache[key] = out
        return out

    def marginals_for(
        self, names: Sequence[str], evidence: Mapping[str, int]
    ) -> None:
        """Prefill the posterior cache for ``names`` under one evidence set,
        sharing a single evidence-reduction pass over the BN factors (one
        forward pass instead of one per stage)."""
        ev_key = self._ev_key(evidence)
        missing = [n for n in names if (n, ev_key) not in self._marg_cache]
        if not missing:
            return
        factors = None
        for n in missing:
            if evidence and n in evidence:
                self._marg_cache[(n, ev_key)] = self.bn.marginal(n, evidence)
                continue
            if factors is None:
                factors = self.bn.reduced_factors(evidence)
            self._marg_cache[(n, ev_key)] = self.bn.marginal(
                n, evidence, factors=factors
            )

    def stage_expectation(self, name: str, evidence: Mapping[str, int]) -> float:
        """E[duration of stage | evidence] via BN posterior."""
        if not self._fitted or name not in self.discretizers:
            return 1.0
        post = self.marginal(name, evidence)
        return self.discretizers[name].expectation(post)

    def stage_bounds(self, name: str, evidence: Mapping[str, int]) -> Tuple[float, float]:
        d = self.discretizers.get(name)
        if d is None:
            return (0.0, 1.0)
        post = self.marginal(name, evidence)
        idx = np.where(post > 1e-9)[0]
        if len(idx) == 0:
            return (0.0, 0.0)
        return (float(d.repr_value[idx].min()), float(d.repr_value[idx].max()))

    # ------------------------------------------------- remaining-time query
    def _base_estimates(
        self, job: Job, use_bn: bool, version: Optional[int] = None
    ) -> Tuple[set, Dict[str, float], bool]:
        """(done_names, base, has_running) for ``job``'s stages.

        ``base[name]`` is the stage's duration estimate *before* batching
        calibration and elapsed-time subtraction — a pure function of the
        job's BN evidence and observable structure, so it is cacheable per
        (job, evidence_version).  ``has_running`` records whether any
        unfinished stage is executing (making the final remaining-duration
        value time-dependent and thus uncacheable as a scalar).
        """
        key = (job.job_id, bool(use_bn))
        if version is not None:
            hit = self._job_base.get(key)
            if hit is not None and hit[0] == version:
                return hit[1], hit[2], hit[3]
        ev = self.evidence_for(job, version) if use_bn else {}
        if self._fitted:
            # one BN forward pass covers every stage expectation below
            self.marginals_for(
                [
                    n
                    for n, s in job.stages.items()
                    if n in self.discretizers and not s.obs_done()
                ],
                ev if use_bn else {},
            )
        done: set = set()
        base: Dict[str, float] = {}
        has_running = False
        for name, stage in job.stages.items():
            # NOTE: ``stage.will_execute`` is ground truth — only observable
            # once the stage is *revealed* (no oracle leak).  Unrevealed
            # stages keep their BN expectation, whose bin-0 mass already
            # prices in the probability they never run.
            if stage.obs_done():
                done.add(name)
                continue
            if name in self.discretizers and self._fitted:
                if use_bn:
                    e = self.stage_expectation(name, ev)
                else:
                    post = self.marginal(name, {}) if self.bn.nodes else None
                    e = (
                        self.discretizers[name].expectation(post)
                        if post is not None
                        else float(self.discretizers[name].repr_value.mean())
                    )
            elif "." in name:
                # runtime-expanded dynamic inner stage "<dyn>.<candidate>"
                dyn, cand = name.split(".", 1)
                e = self.candidate_mean_dur.get(dyn, {}).get(cand, 1.0)
            else:
                e = 1.0
            if stage.running():
                has_running = True
            base[name] = e
        if version is not None:
            self._job_base[key] = (version, done, base, has_running)
        return done, base, has_running

    def est_remaining(
        self,
        job: Job,
        now: float,
        calibrate: Optional[Callable[[Stage, float], float]] = None,
        mode: str = "critical_path",
        use_bn: bool = True,
        version: Optional[int] = None,
        calib_key: Optional[Tuple] = None,
    ) -> float:
        """Estimated remaining duration of ``job`` (line 1 of Algorithm 1).

        ``calibrate`` maps (stage, base_estimate) -> batching-calibrated
        estimate (Eq. 2); identity if None.  ``use_bn=False`` gives the
        "LLMSched w/o BN" ablation (historical means, no posterior).

        ``version`` is the job's ``evidence_version``; when provided, the
        per-stage BN work is cached across scheduling rounds and only the
        cheap calibrate/elapsed/critical-path pass re-runs.  ``calib_key``
        is a hashable token identifying the calibration context (e.g.
        (profile epoch, target batch)); when the job additionally has no
        running stage the final scalar is cached outright.
        """
        slot = (job.job_id, bool(use_bn))
        sig = ("ident",) if calibrate is None else calib_key
        if version is not None and sig is not None:
            hit = self._job_rd.get(slot)
            if (
                hit is not None
                and hit[0] == version
                and hit[1] == sig
                and hit[2] == mode
            ):
                return hit[3]
        done, base, has_running = self._base_estimates(job, use_bn, version)
        est: Dict[str, float] = {}
        for name, stage in job.stages.items():
            if name in done:
                est[name] = 0.0
                continue
            e = base[name]
            if calibrate is not None:
                e = calibrate(stage, e)
            if stage.running():
                started = min(
                    (t.start_time for t in stage.tasks if t.start_time >= 0),
                    default=now,
                )
                e = max(0.0, e - (now - started))
            est[name] = e

        if mode == "sum":
            out = float(sum(est.values()))
        else:
            # critical path over unfinished stages (finished contribute 0)
            order = self.app.topo_order()
            dist: Dict[str, float] = {}
            for n in order:
                if n not in job.stages:
                    continue
                pmax = max(
                    (dist.get(p, 0.0) for p in self.app.parents(n)), default=0.0
                )
                dist[n] = pmax + est.get(n, 0.0)
            # realized dynamic inner stages live outside the template order
            extra = sum(est.get(n, 0.0) for n in est if n not in dist)
            out = float(max(dist.values(), default=0.0) + extra)
        if version is not None and sig is not None and not has_running:
            self._job_rd[slot] = (version, sig, mode, out)
        return out

    def job_bounds(
        self, job: Job, use_bn: bool = True, version: Optional[int] = None
    ) -> Tuple[float, float]:
        """[lo, hi] of the job's remaining-duration distribution (line 5)."""
        slot = (job.job_id, bool(use_bn))
        if version is not None:
            hit = self._job_bounds.get(slot)
            if hit is not None and hit[0] == version:
                return hit[1]
        ev = self.evidence_for(job, version) if use_bn else {}
        if self._fitted:
            self.marginals_for(
                [
                    n
                    for n, s in job.stages.items()
                    if n in self.discretizers and not s.obs_done()
                ],
                ev,
            )
        lo = hi = 0.0
        for name, stage in job.stages.items():
            if stage.obs_done():
                continue
            l, h = self.stage_bounds(name, ev) if self._fitted else (0.0, 1.0)
            lo += l
            hi += h
        out = (lo, hi)
        if version is not None:
            self._job_bounds[slot] = (version, out)
        return out

    # ------------------------------------------------- uncertainty reduction
    def _dynamic_bonus(self, job: Job, stage_name: str, ev: Mapping[str, int]) -> float:
        """Eq. 4 bonus for dynamic stages resolved by finishing this stage."""
        bonus = 0.0
        st = job.stages.get(stage_name)
        if st is not None and st.stype is StageType.LLM:
            # dynamic stages resolved by this LLM stage (its children)
            for child in self.app.children(stage_name):
                cst = job.stages.get(child)
                if (
                    cst is not None
                    and cst.stype is StageType.DYNAMIC
                    and not cst.revealed
                ):
                    h = self._dyn_entropy.get(child, 0.0)
                    d = self.discretizers.get(child)
                    post = self.marginal(child, ev) if d else None
                    rng = d.range_span(post) if d is not None and post is not None else 1.0
                    bonus += h * max(rng, 1e-6)
        return bonus

    def stage_uncertainty_reduction(
        self, job: Job, stage_name: str, version: Optional[int] = None
    ) -> float:
        """R(stage) for Algorithm 1 line 8 (Eq. 6 + dynamic bonus)."""
        return self.stage_uncertainty_reductions(job, [stage_name], version)[0]

    def stage_uncertainty_reductions(
        self,
        job: Job,
        stage_names: Sequence[str],
        version: Optional[int] = None,
    ) -> List[float]:
        """Batched R(stage) for several ready stages of one job.

        All stages share one evidence set, one unscheduled-set scan, and
        one BN evidence-reduction pass (via
        :func:`repro_torch.core.entropy.uncertainty_reductions`).  With
        ``version`` set, scores are additionally cached per
        (job, evidence_version) across scheduling rounds.
        """
        if not self._fitted:
            return [0.0] * len(stage_names)
        vcache: Optional[Dict[str, float]] = None
        if version is not None:
            slot = self._job_ur.get(job.job_id)
            if slot is not None and slot[0] == version:
                vcache = slot[1]
            else:
                vcache = {}
                self._job_ur[job.job_id] = (version, vcache)
            missing = [n for n in stage_names if n not in vcache]
            if not missing:
                return [vcache[n] for n in stage_names]
        else:
            missing = list(dict.fromkeys(stage_names))

        ev = self.evidence_for(job, version)
        unscheduled = [
            name
            for name, s in job.stages.items()
            if not s.obs_done()
            and not s.running()
            and s.dispatched_tasks == 0
        ]
        unsched_t = tuple(sorted(unscheduled))
        ev_key = self._ev_key(ev)
        results: Dict[str, float] = {}
        need_mi: List[Tuple[str, float]] = []
        for name in missing:
            key = (name, unsched_t, ev_key)
            hit = self._ur_cache.get(key)
            if hit is not None:
                results[name] = hit
                continue
            bonus = self._dynamic_bonus(job, name, ev)
            if name not in self.bn.nodes:
                results[name] = float(bonus)
                self._ur_cache[key] = results[name]
                continue
            need_mi.append((name, bonus))
        if need_mi:
            vals = uncertainty_reductions(
                self.bn,
                self.discretizers,
                [n for n, _ in need_mi],
                unscheduled,
                ev,
                dynamic_bonuses=[b for _, b in need_mi],
            )
            for (name, _), val in zip(need_mi, vals):
                results[name] = val
                self._ur_cache[(name, unsched_t, ev_key)] = val
        if vcache is not None:
            vcache.update(results)
            return [vcache[n] for n in stage_names]
        return [results[n] for n in stage_names]


class ProfileStore:
    """Profiles for all applications, keyed by template name."""

    def __init__(self) -> None:
        self.profiles: Dict[str, AppProfile] = {}

    def fit(self, apps: Sequence[ApplicationTemplate], traces: Sequence[JobTrace],
            **kw) -> "ProfileStore":
        by_app: Dict[str, List[JobTrace]] = {}
        for t in traces:
            by_app.setdefault(t.app_name, []).append(t)
        for app in apps:
            prof = AppProfile(app)
            if by_app.get(app.name):
                prof.fit(by_app[app.name], **kw)
            self.profiles[app.name] = prof
        return self

    def __getitem__(self, name: str) -> AppProfile:
        return self.profiles[name]

    def get(self, name: str) -> Optional[AppProfile]:
        return self.profiles.get(name)

    def forget_job(self, job_id: int) -> None:
        """Evict a finished job's slots from every profile's caches."""
        for prof in self.profiles.values():
            prof.forget_job(job_id)
