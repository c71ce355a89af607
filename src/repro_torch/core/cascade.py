"""Quality gates + cascade-escalation model shared by sim and testbed.

LLM-Modulo-style verifier gating: every finished LLM stage output is
checked by a pluggable :class:`QualityGate`; a rejected output is
*escalated* — the task re-enters the pending queue with its
``tier_floor`` raised one cost rank above the tier that failed, so the
retry provably runs on a more capable model (the prompt re-enters
through the normal admission path and hits the destination replica's
prefix cache where pages are compatible).  A rejection on the fleet's
top tier cannot escalate: the output is kept and the job is marked
quality-failed in ``RunMetrics.quality_by_job``.

The reference gate is *deterministic*: whether attempt ``k`` of stage
``(job, stage, index)`` passes on a tier of quality ``q`` is a pure
function of ``(seed, app, stage, index, attempt, q, strictness)`` —
no shared RNG stream is consumed, so enabling the gate never perturbs
the simulator's arrival/failure draws, and replays are byte-stable
regardless of event order.  The pass rule is

``fail  ⇔  difficulty(app, stage) > q  and  draw < strictness``

with ``draw`` a per-attempt uniform derived by hashing the identity
tuple.  Because the draw is shared across strictness values, the set of
failing attempts grows monotonically with strictness — which makes the
total cascade cost monotone in strictness (property-tested).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "QualityGate",
    "DeterministicGate",
    "stage_difficulty",
    "cascade_cost",
    "fleet_ranks",
]


def stage_difficulty(app: str, stage: str) -> float:
    """Ground-truth difficulty of a stage type, in [0, 1).

    A stable hash of the ``(application, stage)`` template names — the
    same stage is equally hard in every job, seed, and runtime, which
    keeps sim↔testbed gate outcomes comparable.  Hidden from the
    scheduler (like true durations): only the gate consults it.

    Parameters
    ----------
    app : str
        Application template name (e.g. ``"WebSearch"``).
    stage : str
        Stage template name within the app.

    Returns
    -------
    float
        Difficulty in ``[0, 1)`` — compared against a tier's
        ``quality`` by the gate.
    """
    h = zlib.crc32(f"{app}\x1f{stage}".encode())
    return (h % 10_000) / 10_000.0


def _attempt_draw(
    seed: int, app: str, stage: str, index: int, attempt: int
) -> float:
    """Deterministic uniform in [0, 1) for one gate evaluation."""
    h = zlib.crc32(
        f"{seed}\x1f{app}\x1f{stage}\x1f{index}\x1f{attempt}".encode()
    )
    return float(np.random.default_rng(h).random())


class QualityGate:
    """Pluggable verifier over LLM stage outputs.

    Subclasses implement :meth:`passes`; runtimes call it once per
    completed LLM attempt and escalate on ``False`` (when a higher tier
    exists).  Implementations must be pure in their arguments — the
    runtimes may re-evaluate during replay.
    """

    def passes(
        self, app: str, stage: str, index: int, attempt: int, quality: float
    ) -> bool:
        """Judge one stage output.

        Parameters
        ----------
        app, stage, index : str, str, int
            Identity of the stage output under judgment.
        attempt : int
            0 for the first execution, +1 per cascade escalation.
        quality : float
            The serving tier's quality score in [0, 1]
            (``TierSpec.quality``).

        Returns
        -------
        bool
            True to accept the output.
        """
        raise NotImplementedError


@dataclass(frozen=True)
class DeterministicGate(QualityGate):
    """The reference hash-seeded gate (see module docstring).

    Parameters
    ----------
    strictness : float
        In [0, 1]: the probability that an out-of-depth output
        (difficulty above the tier's quality) is rejected.  ``0``
        accepts everything (gate provably inert); ``1`` rejects every
        out-of-depth output.
    seed : int
        Domain-separates the per-attempt draws from every other RNG
        stream in a run.
    """

    strictness: float
    seed: int = 0

    def __post_init__(self) -> None:
        if not 0.0 <= self.strictness <= 1.0:
            raise ValueError(
                f"strictness must be in [0, 1], got {self.strictness}"
            )

    def passes(
        self, app: str, stage: str, index: int, attempt: int, quality: float
    ) -> bool:
        """Accept unless the stage is out of depth and the draw condemns it.

        Parameters
        ----------
        app, stage, index, attempt : str, str, int, int
            Identity tuple keying the deterministic draw.
        quality : float
            Serving tier's quality in [0, 1].

        Returns
        -------
        bool
            True to accept; shared-draw construction makes the set of
            rejections monotone in :attr:`strictness`.
        """
        if stage_difficulty(app, stage) <= quality:
            return True
        return _attempt_draw(
            self.seed, app, stage, index, attempt
        ) >= self.strictness


def cascade_cost(
    app: str,
    stage: str,
    index: int,
    tokens: int,
    tiers: Sequence[Tuple[float, float]],
    gate: QualityGate,
    start_rank: int = 0,
) -> Tuple[float, int, bool]:
    """Walk one stage up the cascade and total its serving cost.

    The closed-form escalation model the runtimes implement
    event-by-event: run the stage on ``tiers[start_rank]``; on gate
    rejection move one rank up and retry (attempt counter
    incrementing), paying every visited tier's price for the stage's
    tokens; a top-rank rejection terminates without acceptance.

    Parameters
    ----------
    app, stage, index : str, str, int
        Stage identity (keys the gate's deterministic draws).
    tokens : int
        Generated tokens per attempt.
    tiers : sequence of (float, float)
        ``(cost_per_token, quality)`` per tier, cheapest first
        (ascending cost rank).
    gate : QualityGate
        The verifier.
    start_rank : int, optional
        Tier rank of the first attempt.

    Returns
    -------
    (float, int, bool)
        Total cost over all attempts, number of escalations, and
        whether the final output was accepted.
    """
    cost = 0.0
    escalations = 0
    rank = start_rank
    for attempt in range(len(tiers) - start_rank):
        c, q = tiers[rank]
        cost += tokens * c
        if gate.passes(app, stage, index, attempt, q):
            return cost, escalations, True
        if rank + 1 >= len(tiers):
            return cost, escalations, False
        rank += 1
        escalations += 1
    return cost, escalations, False


def fleet_ranks(costs: Sequence[float]) -> List[int]:
    """Dense cost ranks of a replica fleet (0 = cheapest tier).

    Parameters
    ----------
    costs : sequence of float
        Per-replica cost per generated token.

    Returns
    -------
    list of int
        Rank of each replica's tier; replicas with equal cost share a
        rank.  The same rule the scheduler applies to
        ``ClusterView.llm_model_costs``, so runtime escalation floors
        and scheduler placement agree.
    """
    order = sorted(set(costs))
    return [order.index(c) for c in costs]
