"""Declarative Decision-level invariants for :class:`LLMSched`.

The SLO plan-ahead/retraction machinery is correct only while a
few properties hold on *every* decision — properties the golden-hash
suites witness indirectly (a violation eventually drifts the stream)
but cannot name.  This module states them declaratively and
``LLMSched(check_invariants=True)`` evaluates all of them at the end of
each :meth:`~repro_torch.core.scheduler.LLMSched.schedule` call:

- ``no-running-retraction`` — preference lists contain only ``PENDING``
  tasks: a retraction may reorder queued work but must never touch a
  task that already started (token-equality and migration both assume
  dispatched work is immutable);
- ``demoted-unplaced`` — jobs demoted as provably deadline-infeasible
  receive no placement entry (no KV reservation): demotion exists to
  *stop* spending pages on lost causes;
- ``placement-bounds`` — every placement hint names a real replica, and
  one round never over-commits a replica beyond its free batch slots;
- ``plan-pinned`` — each SLO job's cached :class:`_SloPlan` snapshot
  matches the job's **current** ``evidence_version`` and the current
  calibration signature: a decision built from a stale plan is exactly
  the bug retraction exists to prevent;
- ``edf-urgent-order`` — the urgent bucket emitted by ``_slo_order`` is
  sorted by its ``(tier, pessimistic-slack, deadline, arrival)`` key —
  deadline-carrying urgent jobs drain earliest-deadline-first.

Each invariant is a pure predicate over ``(scheduler, jobs, view,
decision)``; violations aggregate into one :class:`InvariantViolation`
so a single bad round reports every broken property at once.

Checking is observation-only: enabling it never alters the decision
stream (asserted by golden-equality tests in ``tests/test_analysis.py``).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

from ..core.dag import TaskState


class InvariantViolation(AssertionError):
    """A scheduler decision broke one or more declared invariants."""


def _iter_tasks(decision):
    for t in decision.regular:
        yield t
    for t in decision.llm:
        yield t


def _no_running_retraction(sched, jobs, view, decision) -> List[str]:
    """Preference lists must only ever contain pending tasks."""
    out = []
    for t in _iter_tasks(decision):
        if t.state is not TaskState.PENDING:
            out.append(
                f"task ({t.job_id}, {t.stage_name!r}, {t.index}) is "
                f"{t.state.name} yet appears in the preference lists — "
                "running/finished work must never be (re)scheduled"
            )
    return out


def _demoted_unplaced(sched, jobs, view, decision) -> List[str]:
    """Provably-infeasible jobs must hold no placement (KV) reservation."""
    demoted = getattr(sched, "_demoted", set())
    if not demoted:
        return []
    out = []
    for key, replica in decision.placement.items():
        if key[0] in demoted:
            out.append(
                f"job {key[0]} is demoted (provably deadline-infeasible) "
                f"but task {key} was placed on replica {replica} — demoted "
                "jobs must reserve no KV headroom"
            )
    return out


def _placement_bounds(sched, jobs, view, decision) -> List[str]:
    """Placement hints must name real replicas and respect free slots."""
    out = []
    n = len(view.llm_loads)
    counts = [0] * n
    for key, replica in decision.placement.items():
        if not (0 <= replica < n):
            out.append(
                f"task {key} placed on replica {replica}, but the view "
                f"has only {n} replicas"
            )
            continue
        counts[replica] += 1
    for e, c in enumerate(counts):
        b, mb = view.llm_loads[e]
        free = max(0, mb - b)
        if c > free:
            out.append(
                f"replica {e} received {c} placements but has only "
                f"{free} free batch slots (batch {b}/{mb}) — one round "
                "must not overcommit a replica"
            )
    return out


def _plan_pinned(sched, jobs, view, decision) -> List[str]:
    """Cached SLO plans must match current evidence + calibration."""
    plans = getattr(sched, "_slo_plans", None)
    if not plans or not sched.slo_aware:
        return []
    if not any(j.slo is not None for j in jobs):
        return []  # _slo_order did not run: plans are legitimately idle
    sig = sched._calib_sig(view)
    out = []
    for job in jobs:
        if job.slo is None:
            continue
        plan = plans.get(job.job_id)
        if plan is None:
            continue
        if plan.version != job.evidence_version:
            out.append(
                f"job {job.job_id}'s plan snapshot is pinned to evidence "
                f"version {plan.version} but the job is at "
                f"{job.evidence_version} — the stale plan must be "
                "retracted before deciding"
            )
        elif plan.calib != sig:
            out.append(
                f"job {job.job_id}'s plan snapshot was calibrated under "
                f"{plan.calib} but the view implies {sig} — the plan must "
                "be rebuilt against the current l(b) model"
            )
    return out


def _edf_urgent_order(sched, jobs, view, decision) -> List[str]:
    """The urgent bucket must be sorted by its EDF key."""
    keys = getattr(sched, "_last_urgent_keys", None)
    if not keys:
        return []
    for a, b in zip(keys, keys[1:]):
        if a > b:
            return [
                f"urgent bucket is not in EDF order: key {a} precedes "
                f"{b} — tight-deadline jobs must drain "
                "(tier, slack, deadline, arrival)-first"
            ]
    return []


#: The declarative catalog: (name, predicate) pairs, all evaluated on
#: every decision when ``LLMSched(check_invariants=True)``.
INVARIANTS: List[Tuple[str, Callable]] = [
    ("no-running-retraction", _no_running_retraction),
    ("demoted-unplaced", _demoted_unplaced),
    ("placement-bounds", _placement_bounds),
    ("plan-pinned", _plan_pinned),
    ("edf-urgent-order", _edf_urgent_order),
]


def check_decision(sched, jobs: Sequence, view, decision) -> None:
    """Evaluate every declared invariant against one decision.

    Parameters
    ----------
    sched : LLMSched
        The scheduler that produced the decision (its ``_demoted`` /
        ``_slo_plans`` / ``_last_urgent_keys`` state is inspected).
    jobs : sequence of Job
        The unfinished jobs passed to ``schedule`` (pre-filtering).
    view : ClusterView
        The cluster view the decision was made against.
    decision : Decision
        The decision to validate.

    Raises
    ------
    InvariantViolation
        Listing every violated invariant with an actionable message.
    """
    violations: List[str] = []
    for name, pred in INVARIANTS:
        for msg in pred(sched, jobs, view, decision):
            violations.append(f"[{name}] {msg}")
    if violations:
        raise InvariantViolation(
            "scheduler invariant violation(s) at t="
            f"{view.now:.6f}:\n  " + "\n  ".join(violations)
        )
