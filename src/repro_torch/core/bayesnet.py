"""Discrete Bayesian network for profiling compound LLM applications (§IV-B).

pyagrum (used by the paper) is unavailable offline, so this is a
from-scratch discrete BN with:

- quantile discretization of stage durations into ≤ ``max_bins`` intervals,
  with a dedicated bin 0 for "not executed" (duration == 0, paper footnote 2);
- structure = application-template edges + extra edges mined by pairwise
  mutual-information thresholding (parents capped to keep CPDs dense);
- CPDs from Laplace-smoothed counts;
- exact inference by variable elimination (factor algebra over numpy).

Networks here are small (≤ ~25 nodes, cardinality ≤ 7) so exact inference
is effectively constant-time — the paper makes the same argument (§IV-D).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

Evidence = Mapping[str, int]  # var name -> observed bin index


# ---------------------------------------------------------------------------
# Factor algebra
# ---------------------------------------------------------------------------
@dataclass
class Factor:
    """A factor over discrete variables: ``values[i_0, ..., i_{k-1}]``."""

    vars: Tuple[str, ...]
    values: np.ndarray  # shape = cards of vars, float64

    def __post_init__(self) -> None:
        assert self.values.ndim == len(self.vars)

    @property
    def cards(self) -> Tuple[int, ...]:
        return self.values.shape

    def product(self, other: "Factor") -> "Factor":
        all_vars = list(self.vars) + [v for v in other.vars if v not in self.vars]
        a = _broadcast(self, all_vars)
        b = _broadcast(other, all_vars)
        return Factor(tuple(all_vars), a * b)

    def marginalize(self, var: str) -> "Factor":
        ax = self.vars.index(var)
        new_vars = tuple(v for v in self.vars if v != var)
        return Factor(new_vars, self.values.sum(axis=ax))

    def reduce(self, var: str, value: int) -> "Factor":
        ax = self.vars.index(var)
        new_vars = tuple(v for v in self.vars if v != var)
        return Factor(new_vars, np.take(self.values, value, axis=ax))

    def normalize(self) -> "Factor":
        z = self.values.sum()
        if z <= 0:
            # Degenerate (evidence with zero probability under the model):
            # fall back to uniform so downstream entropy math stays finite.
            vals = np.full_like(self.values, 1.0 / self.values.size)
            return Factor(self.vars, vals)
        return Factor(self.vars, self.values / z)

    def reorder(self, order: Sequence[str]) -> "Factor":
        perm = [self.vars.index(v) for v in order]
        return Factor(tuple(order), np.transpose(self.values, perm))


def _broadcast(f: Factor, all_vars: List[str]) -> np.ndarray:
    shape = [1] * len(all_vars)
    src_axes = []
    for i, v in enumerate(all_vars):
        if v in f.vars:
            src_axes.append((f.vars.index(v), i))
    perm = [a for a, _ in sorted(src_axes, key=lambda t: t[1])]
    arr = np.transpose(f.values, perm) if perm else f.values
    it = iter(range(arr.ndim))
    for i, v in enumerate(all_vars):
        if v in f.vars:
            shape[i] = arr.shape[next(it)]
    return arr.reshape(shape)


def eliminate(factors: List[Factor], keep: Sequence[str]) -> Factor:
    """Variable elimination: multiply all factors, sum out vars not in keep.

    Uses a min-degree-ish heuristic (eliminate vars appearing in fewest
    factors first) — plenty for networks this small.
    """
    factors = list(factors)
    all_vars: Set[str] = set()
    for f in factors:
        all_vars.update(f.vars)
    to_eliminate = [v for v in all_vars if v not in keep]

    while to_eliminate:
        # pick var in fewest factors
        counts = {v: sum(v in f.vars for f in factors) for v in to_eliminate}
        v = min(to_eliminate, key=lambda x: counts[x])
        to_eliminate.remove(v)
        related = [f for f in factors if v in f.vars]
        rest = [f for f in factors if v not in f.vars]
        if not related:
            continue
        prod = related[0]
        for f in related[1:]:
            prod = prod.product(f)
        factors = rest + [prod.marginalize(v)]

    if not factors:
        return Factor((), np.array(1.0))
    prod = factors[0]
    for f in factors[1:]:
        prod = prod.product(f)
    # sum out any stray vars (shouldn't happen, but be safe)
    for v in list(prod.vars):
        if v not in keep:
            prod = prod.marginalize(v)
    return prod.reorder([v for v in keep if v in prod.vars])


# ---------------------------------------------------------------------------
# Discretizer
# ---------------------------------------------------------------------------
@dataclass
class Discretizer:
    """Quantile discretizer for one stage's duration distribution.

    Bin 0 is reserved for "not executed" (duration == 0) whenever any
    history sample is 0.  Real durations go into up to ``max_bins``
    quantile intervals.  ``repr_value[b]`` is the mean duration of training
    samples in bin b (used for expectations); ``lo/hi`` give interval
    bounds (used for Range()).
    """

    edges: np.ndarray          # interior bin edges for positive durations
    has_zero_bin: bool
    repr_value: np.ndarray     # mean duration per bin
    lo: np.ndarray             # lower bound per bin
    hi: np.ndarray             # upper bound per bin

    @property
    def cardinality(self) -> int:
        return len(self.repr_value)

    def transform(self, duration: float) -> int:
        if self.has_zero_bin and duration <= 0.0:
            return 0
        b = int(np.searchsorted(self.edges, duration, side="right"))
        b += 1 if self.has_zero_bin else 0
        # a duration class never seen in training (e.g. a stage that
        # only ever skipped, leaving just the zero bin) must clamp into
        # the last fitted bin instead of indexing past the CPD's
        # cardinality; a no-op for every well-fitted discretizer
        return min(b, len(self.repr_value) - 1)

    def range_span(self, probs: np.ndarray, eps: float = 1e-9) -> float:
        """Range of the (posterior) duration distribution: spread of
        representative values over bins with non-negligible mass."""
        idx = np.where(probs > eps)[0]
        if len(idx) == 0:
            return 0.0
        return float(self.repr_value[idx].max() - self.repr_value[idx].min())

    def expectation(self, probs: np.ndarray) -> float:
        return float(np.dot(probs, self.repr_value))


def fit_discretizer(samples: Sequence[float], max_bins: int = 6) -> Discretizer:
    s = np.asarray(list(samples), dtype=np.float64)
    zero = s[s <= 0.0]
    pos = s[s > 0.0]
    has_zero_bin = len(zero) > 0
    if len(pos) == 0:
        return Discretizer(
            edges=np.array([]),
            has_zero_bin=True,
            repr_value=np.array([0.0]),
            lo=np.array([0.0]),
            hi=np.array([0.0]),
        )
    uniq = np.unique(pos)
    k = int(min(max_bins, len(uniq)))
    # quantile ("frequency-based", paper §V) edges
    qs = np.quantile(pos, np.linspace(0, 1, k + 1)[1:-1]) if k > 1 else np.array([])
    edges = np.unique(qs)
    nbins = len(edges) + 1
    offset = 1 if has_zero_bin else 0
    card = nbins + offset
    repr_value = np.zeros(card)
    lo = np.zeros(card)
    hi = np.zeros(card)
    assign = np.searchsorted(edges, pos, side="right") + offset
    for b in range(offset, card):
        mask = assign == b
        if mask.any():
            repr_value[b] = pos[mask].mean()
            lo[b] = pos[mask].min()
            hi[b] = pos[mask].max()
        else:  # empty quantile bin (ties) — use edge midpoint
            lo_e = edges[b - offset - 1] if b - offset - 1 >= 0 else pos.min()
            hi_e = edges[b - offset] if b - offset < len(edges) else pos.max()
            repr_value[b] = 0.5 * (lo_e + hi_e)
            lo[b], hi[b] = lo_e, hi_e
    return Discretizer(edges=edges, has_zero_bin=has_zero_bin,
                       repr_value=repr_value, lo=lo, hi=hi)


# ---------------------------------------------------------------------------
# Bayesian network
# ---------------------------------------------------------------------------
class BayesNet:
    """Discrete BN over stage-duration variables of one application."""

    def __init__(self) -> None:
        self.nodes: List[str] = []
        self.cards: Dict[str, int] = {}
        self.parents: Dict[str, List[str]] = {}
        self.cpds: Dict[str, Factor] = {}  # factor over (node, *parents)
        self._desc_cache: Dict[str, Set[str]] = {}  # node -> descendants

    # -- structure + parameters -------------------------------------------
    def fit(
        self,
        data: np.ndarray,                 # (n_samples, n_vars) bin indices
        names: Sequence[str],
        cards: Sequence[int],
        template_edges: Iterable[Tuple[str, str]] = (),
        mi_threshold: float = 0.05,
        max_parents: int = 3,
        alpha: float = 0.5,
    ) -> "BayesNet":
        names = list(names)
        self.nodes = names
        self.cards = dict(zip(names, cards))
        idx = {n: i for i, n in enumerate(names)}
        n = len(names)

        # --- structure: template edges first, then MI-mined extras --------
        order = {name: i for i, name in enumerate(names)}  # topo order given
        parents: Dict[str, List[str]] = {name: [] for name in names}
        for u, v in template_edges:
            if u in idx and v in idx and order[u] < order[v]:
                if u not in parents[v] and len(parents[v]) < max_parents:
                    parents[v].append(u)
        # mine extra edges by empirical pairwise MI (earlier -> later only)
        mi_cache: List[Tuple[float, str, str]] = []
        for j in range(n):
            for i in range(j):
                u, v = names[i], names[j]
                if u in parents[v]:
                    continue
                m = _empirical_mi(data[:, idx[u]], data[:, idx[v]],
                                  self.cards[u], self.cards[v])
                if m > mi_threshold:
                    mi_cache.append((m, u, v))
        for m, u, v in sorted(mi_cache, reverse=True):
            if len(parents[v]) < max_parents:
                parents[v].append(u)
        self.parents = parents

        # --- CPDs: Laplace-smoothed counts ---------------------------------
        for v in names:
            ps = parents[v]
            shape = tuple([self.cards[v]] + [self.cards[p] for p in ps])
            counts = np.full(shape, alpha, dtype=np.float64)
            cols = [idx[v]] + [idx[p] for p in ps]
            for row in data:
                counts[tuple(int(row[c]) for c in cols)] += 1.0
            counts /= counts.sum(axis=0, keepdims=True)
            self.cpds[v] = Factor(tuple([v] + ps), counts)
        self._desc_cache = {}
        return self

    # -- correlation (Eq. 1): directed path u ->* v in the BN ---------------
    def _descendants(self, u: str) -> Set[str]:
        hit = self._desc_cache.get(u)
        if hit is not None:
            return hit
        children: Dict[str, List[str]] = {x: [] for x in self.nodes}
        for c, ps in self.parents.items():
            for p in ps:
                children[p].append(c)
        seen: Set[str] = set()
        frontier = [u]
        while frontier:
            x = frontier.pop()
            for c in children.get(x, ()):
                if c not in seen:
                    seen.add(c)
                    frontier.append(c)
        self._desc_cache[u] = seen
        return seen

    def correlated(self, u: str, v: str) -> bool:
        if u == v:
            return False
        return v in self._descendants(u)

    def correlated_set(self, u: str) -> List[str]:
        return [v for v in self.nodes if self.correlated(u, v)]

    def uncertainty_reducing(self) -> List[str]:
        """Stages correlated with ≥1 other stage (paper: uncertainty-reducing)."""
        return [u for u in self.nodes if len(self.correlated_set(u)) > 0]

    # -- inference ----------------------------------------------------------
    def _reduced_factors(self, evidence: Evidence) -> List[Factor]:
        out = []
        for v in self.nodes:
            f = self.cpds[v]
            for e, val in evidence.items():
                if e in f.vars:
                    f = f.reduce(e, int(val))
            out.append(f)
        return out

    def reduced_factors(self, evidence: Optional[Evidence] = None) -> List[Factor]:
        """Evidence-reduced CPD factors — the shared prefix of every query
        against the same evidence set.  Compute once, then pass to
        :meth:`joint`/:meth:`marginal`/:meth:`marginals` via ``factors=``
        to amortize one BN "forward pass" over many queries."""
        return self._reduced_factors(dict(evidence or {}))

    def joint(
        self,
        query: Sequence[str],
        evidence: Optional[Evidence] = None,
        factors: Optional[List[Factor]] = None,
    ) -> Factor:
        """P(query | evidence), normalized, vars ordered as ``query``."""
        evidence = dict(evidence or {})
        query = [q for q in query if q not in evidence]
        if factors is None:
            factors = self._reduced_factors(evidence)
        f = eliminate(factors, keep=query)
        return f.normalize().reorder(query)

    def marginal(
        self,
        var: str,
        evidence: Optional[Evidence] = None,
        factors: Optional[List[Factor]] = None,
    ) -> np.ndarray:
        if evidence and var in evidence:
            p = np.zeros(self.cards[var])
            p[int(evidence[var])] = 1.0
            return p
        return self.joint([var], evidence, factors=factors).values

    def marginals(
        self, names: Sequence[str], evidence: Optional[Evidence] = None
    ) -> Dict[str, np.ndarray]:
        """Posterior marginals of ``names`` sharing one evidence-reduction
        pass (the dominant per-query cost for these small networks)."""
        evidence = dict(evidence or {})
        factors = self._reduced_factors(evidence)
        return {
            n: self.marginal(n, evidence, factors=factors) for n in names
        }


def _empirical_mi(x: np.ndarray, y: np.ndarray, cx: int, cy: int) -> float:
    joint = np.zeros((cx, cy))
    for a, b in zip(x, y):
        joint[int(a), int(b)] += 1.0
    joint /= max(joint.sum(), 1.0)
    px = joint.sum(axis=1, keepdims=True)
    py = joint.sum(axis=0, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = joint * (np.log2(joint) - np.log2(px) - np.log2(py))
    return float(np.nansum(t))
