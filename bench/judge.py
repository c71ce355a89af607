"""How ``correct`` is decided for a served model.

After the window has closed and the program's state is freed, a sample
of the requests the window finished is drawn from the seed, the longest
always in it, until it holds the cell's ``judged_tokens`` served tokens
(or ``max_requests`` requests).  The float32 reference runs once over
each prompt followed by its served tokens, and at every served position
reads the gap by which the served token's logit lies below the
reference's best.  The widest gap over the sample (``max_logit_gap``),
or, where a cell's file says so, their mean (``mean_logit_gap``), is
compared with the cell's limit; a greedy engine that computes what the
configuration states serves, at each position, a token within rounding
of the best one.

The control (``control_gaps``) puts the reference computed in float8 in
the program's place: at the same positions of the same prompts and
tokens, the token float8 puts first, read by the same float32 gap.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from bench.reference import module

Sample = Tuple[List[int], List[int]]


def draw(samples: Sequence[Sample], seed: int, judged_tokens: int,
         max_requests: int) -> List[Sample]:
    """The judged sample: the request with the most served tokens, then
    others in an order drawn from ``seed``, until ``judged_tokens``
    served tokens or ``max_requests`` requests are in it."""
    if not samples:
        return []
    order = sorted(range(len(samples)), key=lambda i: -len(samples[i][1]))
    first, rest = order[0], order[1:]
    rng = np.random.default_rng(seed)
    rest = [rest[i] for i in rng.permutation(len(rest))]
    out, n = [], 0
    for i in [first] + rest:
        if n >= judged_tokens or len(out) >= max_requests:
            break
        out.append(samples[i])
        n += len(samples[i][1])
    return out


def _positions(w, cfg: Dict[str, Any], prompt: List[int], served: List[int],
               mode: str, device) -> torch.Tensor:
    """The reference's logits at each served position: the position
    before each served token, over the prompt and the served tokens."""
    ref = module(cfg["reference"])
    toks = torch.tensor(prompt + served[:-1], dtype=torch.long, device=device)
    with torch.no_grad():
        h = ref.hidden(w, cfg, toks, mode)
        return ref.head(w, cfg, h[len(prompt) - 1:], mode)


def served_gaps(w, cfg: Dict[str, Any], sample: Sequence[Sample], device) -> np.ndarray:
    """Each served token's gap below the float32 reference's best logit."""
    out = []
    for prompt, served in sample:
        lg = _positions(w, cfg, prompt, served, "f32", device)
        tok = torch.tensor(served, dtype=torch.long, device=device)
        gap = lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]
        out.append(gap.double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def control_gaps(w, cfg: Dict[str, Any], sample: Sequence[Sample], device,
                 mode: str = "fp8") -> np.ndarray:
    """The gap, under the float32 reference, of the token the reference in
    ``mode`` puts first at each served position: ``"fp8"`` is the control;
    ``"bf16"`` a witness of what rounding in the served dtype alone gives."""
    out = []
    for prompt, served in sample:
        lg = _positions(w, cfg, prompt, served, "f32", device)
        low = _positions(w, cfg, prompt, served, mode, device)
        tok = low.argmax(-1)
        gap = lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]
        out.append(gap.double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


#: the statistics of the judged gaps a cell's file may hold a limit for
STATISTICS = {"max_logit_gap": np.max, "mean_logit_gap": np.mean}


def judge(cell, samples: Sequence[Sample]) -> List[Tuple[str, float, float]]:
    """The checks that decide ``correct``: ``(name, value, limit)``, each
    passing when ``value <= limit``: each statistic of the judged gaps
    that the cell's file holds a limit for, and ``unjudged`` (a window
    that finished no request fails)."""
    lim = cell.limits
    sample = draw(samples, cell.seed, lim["judged_tokens"], lim["max_requests"])
    gaps = served_gaps(cell.params, cell.config, sample, cell.device)
    out = [(name, float(stat(gaps)) if gaps.size else float("inf"), float(lim[name]))
           for name, stat in STATISTICS.items() if name in lim]
    return out + [("unjudged", 0.0 if sample else 1.0, 0.0)]
