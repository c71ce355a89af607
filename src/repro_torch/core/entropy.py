"""Entropy-based uncertainty quantification (paper §IV-C, Eqs. 3–6)."""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np

from .bayesnet import BayesNet, Discretizer, Evidence, Factor


def entropy(probs: np.ndarray) -> float:
    """Shannon entropy (Eq. 3), base 2; 0·log0 := 0."""
    p = np.asarray(probs, dtype=np.float64).ravel()
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def binary_entropy(p: float) -> float:
    p = float(np.clip(p, 0.0, 1.0))
    return entropy(np.array([p, 1.0 - p]))


def dynamic_stage_entropy(
    candidate_probs: Mapping[str, float],
    edge_probs: Mapping[Tuple[str, str], float],
) -> float:
    """Eq. (4): node entropy + edge entropy of the candidate graph.

    ``candidate_probs[c]``  = P(stage c is selected by the planner LLM)
    ``edge_probs[(u, v)]``  = P(edge u→v exists in the generated plan)
    Both are learned from the history of realized plans.
    """
    h = 0.0
    for p in candidate_probs.values():
        h += binary_entropy(p)
    for p in edge_probs.values():
        h += binary_entropy(p)
    return h


def conditional_mutual_information(
    bn: BayesNet,
    targets: Sequence[str],
    x: str,
    evidence: Optional[Evidence] = None,
    max_joint: int = 4,
    factors: Optional[Sequence[Factor]] = None,
    marginal_cache: Optional[Dict[str, np.ndarray]] = None,
) -> float:
    """I(Y_1..Y_M ; X | E)  (Eq. 5 with conditioning set E).

    Exact when M ≤ ``max_joint`` (joint table ≤ 7^(max_joint+1) entries);
    for larger M we keep the ``max_joint`` targets whose marginal posterior
    entropy is largest and compute the exact joint MI over those — a lower
    bound that preserves the ranking the scheduler needs.

    ``factors`` optionally carries precomputed evidence-reduced CPD factors
    (:meth:`BayesNet.reduced_factors`), letting callers amortize the
    evidence-reduction pass over many queries against the same evidence.
    ``marginal_cache`` (same contract: one evidence set) shares target
    posteriors across repeated calls.
    """
    evidence = dict(evidence or {})
    targets = [t for t in targets if t != x and t not in evidence]
    if not targets:
        return 0.0
    factors = list(factors) if factors is not None else None
    if len(targets) > max_joint:

        def marg(t: str) -> np.ndarray:
            if marginal_cache is not None and t in marginal_cache:
                return marginal_cache[t]
            m = bn.marginal(t, evidence, factors=factors)
            if marginal_cache is not None:
                marginal_cache[t] = m
            return m

        ents = {t: entropy(marg(t)) for t in targets}
        targets = sorted(targets, key=lambda t: -ents[t])[:max_joint]

    # joint over (targets, x) given evidence
    jf = bn.joint(list(targets) + [x], evidence, factors=factors)
    if x not in jf.vars:  # x fixed by evidence — no information to gain
        return 0.0
    p_joint = jf.reorder(list(targets) + [x]).values
    p_y = p_joint.sum(axis=-1)             # P(Y|E)
    p_x = p_joint.reshape(-1, p_joint.shape[-1]).sum(axis=0)  # P(X|E)

    h_y = entropy(p_y)
    # H(Y | X, E) = sum_x P(x|E) H(Y | X=x, E)
    h_y_given_x = 0.0
    flat = p_joint.reshape(-1, p_joint.shape[-1])
    for xi in range(flat.shape[1]):
        px = p_x[xi]
        if px <= 0:
            continue
        h_y_given_x += px * entropy(flat[:, xi] / px)
    return max(0.0, h_y - h_y_given_x)


def uncertainty_reduction(
    bn: BayesNet,
    discretizers: Mapping[str, Discretizer],
    x: str,
    unscheduled: Iterable[str],
    evidence: Optional[Evidence] = None,
    dynamic_bonus: float = 0.0,
) -> float:
    """R(X)  (Eq. 6): I(Y_1..Y_M; X | E) × Σ_m Range(Y_m)  [+ dynamic bonus].

    ``dynamic_bonus`` carries the Eq. (4) entropy of a dynamic stage whose
    structure is resolved by finishing X (its preceding LLM stage), already
    multiplied by that stage's duration range (paper §IV-C last ¶).
    """
    evidence = dict(evidence or {})
    unsched = [u for u in unscheduled if u != x and u not in evidence]
    correlated = [y for y in unsched if bn.correlated(x, y)]
    if not correlated:
        return float(dynamic_bonus)
    mi = conditional_mutual_information(bn, correlated, x, evidence)
    range_sum = 0.0
    for y in correlated:
        post = bn.marginal(y, evidence)
        range_sum += discretizers[y].range_span(post)
    return float(mi * range_sum + dynamic_bonus)


def uncertainty_reductions(
    bn: BayesNet,
    discretizers: Mapping[str, Discretizer],
    xs: Sequence[str],
    unscheduled: Iterable[str],
    evidence: Optional[Evidence] = None,
    dynamic_bonuses: Optional[Sequence[float]] = None,
) -> list:
    """Batched Eq. 6: R(X) for every X in ``xs`` against one evidence set.

    Produces exactly the same numbers as calling
    :func:`uncertainty_reduction` per stage, but performs the BN
    evidence-reduction pass and the target posteriors once for the whole
    batch — one "forward pass" scores all ready stages of a job.
    """
    evidence = dict(evidence or {})
    unscheduled = list(unscheduled)
    bonuses = (
        list(dynamic_bonuses) if dynamic_bonuses is not None else [0.0] * len(xs)
    )
    factors: Optional[list] = None          # built lazily on first MI query
    post_cache: Dict[str, np.ndarray] = {}  # shared target posteriors
    out = []
    for x, bonus in zip(xs, bonuses):
        unsched = [u for u in unscheduled if u != x and u not in evidence]
        correlated = [y for y in unsched if bn.correlated(x, y)]
        if not correlated:
            out.append(float(bonus))
            continue
        if factors is None:
            factors = bn.reduced_factors(evidence)
        mi = conditional_mutual_information(
            bn, correlated, x, evidence, factors=factors,
            marginal_cache=post_cache,
        )
        range_sum = 0.0
        for y in correlated:
            post = post_cache.get(y)
            if post is None:
                post = bn.marginal(y, evidence, factors=factors)
                post_cache[y] = post
            range_sum += discretizers[y].range_span(post)
        out.append(float(mi * range_sum + bonus))
    return out
