"""An offline batch: closed-loop clients over one engine.

The window drives the engine's own admit/step loop, as an offline batch
job does: ``clients`` clients each send their next request when the last
one finished.  The traffic file names the engine (``slot``:
``LLMEngine``; ``paged``: ``PagedLLMEngine``) and its settings.

Traffic, from the traffic file and ``--seed``:

- prompt and output lengths come from a fixed pool of ``pool`` pairs at
  the quantiles ``(i + 0.5) / pool`` of lognormal distributions (each a
  ``median`` and a ``sigma``, rounded down and held to ``min`` .. ``max``:
  a prompt longer than the context is cut to it, as a deployment must),
  prompts and outputs paired by a fixed shuffle; the clients take the
  pool in an order drawn from the seed, over and over, so every seed asks
  for the same work; prompt token ids are drawn from the seed, uniform
  over the vocabulary less token 0;
- each client's first request is given an output budget drawn uniform
  from 1 to its drawn length: the part that is left of it, as in a
  steady state;
- set-up admits every client's first request and steps until each has
  begun to decode (the paged engine prefills in its steps; the slot
  engine in ``admit``), and at least ``warm_steps`` steps; the window
  opens at the next step boundary.

The window runs until the first step boundary ``--seconds`` after it
opened; every output token of its steps and admissions counts, over the
window's whole length.  With ``--trace 1`` the clients go on after the
window closed: the profiler is warmed (its first start takes seconds),
and after ``warm_steps`` steps the sub-window holds ``trace_s`` seconds
of steps, at least two (and, with ``trace_at_admission``, one
admission: the slot engine prefills in ``admit``).  The harness's step
loop is the span source: each step, each admission, and the tokens each
moved (prefill positions and decoded tokens, for the model-FLOP count).
"""

from __future__ import annotations

import time
from statistics import NormalDist
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from bench.harness import Record, log, process_age_s, rate
from bench import roofline

#: the attention entry points whose calls the traced sub-window records
ATTN_OPS = ("attention", "paged_prefill_attention", "paged_decode_attention")
#: the longest a profiled sub-window waits for its steps and an admission
SUBWINDOW_LIMIT_S = 60.0


def _lengths(dist: Dict[str, float], n: int) -> np.ndarray:
    """The lognormal's quantiles at ``(i + 0.5) / n``, rounded down and
    held to ``[min, max]``."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.floor(dist["median"] * np.exp(dist["sigma"] * z)).astype(int)
    return np.clip(x, int(dist["min"]), int(dist["max"]))


def _sizes(tr: Dict[str, Any], seed: int) -> List[Tuple[int, int]]:
    """The pool of (prompt, output) lengths, in the order drawn from ``seed``."""
    n = int(tr["pool"])
    plen = _lengths(tr["prompt_tokens"], n)
    olen = _lengths(tr["output_tokens"], n)
    olen = olen[np.random.default_rng(tr["pool_seed"]).permutation(n)]
    order = np.random.default_rng(seed).permutation(n)
    return [(int(plen[i]), int(olen[i])) for i in order]


class _Attn:
    """Records each attention call's shapes while the profiler is on
    (``lengths`` tensors are kept, never read, until the window closed)."""

    def __init__(self, ops, prof) -> None:
        self.calls: List[Tuple[str, Dict[str, Any]]] = []
        self.ops, self.prof = ops, prof
        self.orig = {name: getattr(ops, name) for name in ATTN_OPS}
        for name in ATTN_OPS:
            setattr(ops, name, self._wrap(name, self.orig[name]))

    def _wrap(self, name, fn):
        def call(*args, **kw):
            if self.prof.on:
                q, k = args[0], args[1]
                info: Dict[str, Any] = {"q": tuple(q.shape), "k": tuple(k.shape),
                                        "v": tuple(args[2].shape),
                                        "itemsize": q.element_size()}
                if name == "attention":
                    info["causal"] = kw.get("causal", args[3] if len(args) > 3 else True)
                elif name == "paged_prefill_attention":
                    info["past"] = int(args[4])
                else:
                    info["lengths"] = args[4]
                self.calls.append((name, info))
            return fn(*args, **kw)
        return call

    def restore(self) -> None:
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)

    def resolved(self) -> List[Tuple[str, Dict[str, Any]]]:
        out = []
        for name, info in self.calls:
            if "lengths" in info:
                info = dict(info, lengths=[int(x) for x in info["lengths"].tolist()])
            out.append((name, info))
        return out


def run(cell) -> Record:
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import LLMEngine, Request

    tr = cell.traffic
    W = float(cell.seconds)
    eng_cfg = dict(tr["engine"])
    kind = eng_cfg.pop("kind")
    if kind == "paged":
        from repro_torch.serving.paged_engine import PagedLLMEngine

        eng = PagedLLMEngine(cell.model_cfg, params=cell.params, device=cell.device,
                             **eng_cfg)
    else:
        eng = LLMEngine(cell.model_cfg, params=cell.params, device=cell.device, **eng_cfg)
    clients = int(tr["clients"])
    sizes = _sizes(tr, cell.seed)
    rng = np.random.default_rng(cell.seed)
    vocab = cell.model_cfg.vocab
    flops = roofline.model_flops(cell.config)
    prof = cell.profiler
    span = float(tr.get("trace_s", 3.0))
    at_admission = bool(tr.get("trace_at_admission", False))
    rid = [0]

    def request(first: bool) -> Request:
        plen, olen = sizes[rid[0] % len(sizes)]
        if first:
            olen = int(rng.integers(1, olen + 1))
        prompt = rng.integers(1, vocab, plen).tolist()
        rid[0] += 1
        return Request(rid=rid[0], prompt=prompt, max_new_tokens=olen)

    # per-request progress: prompt tokens run and tokens served
    state: Dict[int, List[int]] = {}
    acc = {"tokens": 0, "ctx": 0, "out": 0}

    def progress(reqs) -> None:
        """Add what each request moved since it was last seen."""
        at = {id(req): pos for req, pos in getattr(eng, "prefilling", {}).values()}
        for r in reqs:
            plen = len(r.prompt)
            pos = plen if r.started_at >= 0 else at.get(id(r), 0)
            n_out = len(r.out_tokens)
            p0, o0 = state.get(r.rid, (0, 0))
            if pos > p0:
                acc["tokens"] += pos - p0
                acc["ctx"] += (p0 + 1 + pos) * (pos - p0) // 2
            if n_out > o0:
                acc["out"] += n_out - o0
                steps = n_out - max(o0, 1)        # the first token comes from prefill
                if steps > 0:
                    acc["tokens"] += steps
                    c0 = plen + max(o0, 1)
                    acc["ctx"] += (c0 + c0 + steps - 1) * steps // 2
            state[r.rid] = [pos, n_out]

    def held():
        out = list(eng.active.values())
        out += [req for req, _ in getattr(eng, "prefilling", {}).values()]
        return out

    # -- set-up: every client's first request, until each decodes -----------
    live: List[Request] = []
    admits: List[Tuple[float, float]] = []
    for _ in range(clients):
        r = request(first=True)
        if not eng.admit(r):
            raise RuntimeError("set-up: the engine refused a client's first request")
        live.append(r)
    finished_all: List[Tuple[float, Request]] = []

    def step_once(t_marks: List[Tuple[float, float]]) -> List[Request]:
        before = held()
        t0 = time.perf_counter()
        if prof is not None and prof.on:
            with torch.profiler.record_function("bench::engine_step"):
                done = eng.step()
            prof.steps += 1
        else:
            done = eng.step()
        t1 = time.perf_counter()
        t_marks.append((t0, t1))
        progress(before)
        return done

    def readmit(done: List[Request], t_marks: List[Tuple[float, float]]) -> None:
        for r in done:
            finished_all.append((time.perf_counter(), r))
            nxt = request(first=False)
            t0 = time.perf_counter()
            if not eng.admit(nxt):
                raise RuntimeError("the engine refused a closed-loop request")
            t_marks.append((t0, time.perf_counter()))
            progress([nxt])

    warm_steps: List[Tuple[float, float]] = []
    while any(r.started_at < 0 for r in live) or len(warm_steps) < int(tr["warm_steps"]):
        readmit(step_once(warm_steps), admits)
    progress(held())

    # -- the window ---------------------------------------------------------
    acc.update(tokens=0, ctx=0, out=0)
    steps: List[Tuple[float, float]] = []
    admits = []
    n_fin0 = len(finished_all)
    setup_s = process_age_s()
    t_open = time.perf_counter()
    while True:
        readmit(step_once(steps), admits)
        if time.perf_counter() - t_open >= W:
            break
    t_close = time.perf_counter()
    window_s = t_close - t_open
    log(f"window of {window_s:.2f} s closed: {len(steps)} steps, "
        f"{1e3 * sum(b - a for a, b in steps) / max(1, len(steps)):.2f} ms each")
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    window_out, window_tokens, window_ctx = acc["out"], acc["tokens"], acc["ctx"]
    done_in = [r for _, r in finished_all[n_fin0:]]

    # -- the profiled sub-window, after the window ---------------------------
    trace = None
    if prof is not None:
        attn = _Attn(ops, prof)
        prof.warm()
        for _ in range(int(tr["warm_steps"])):     # steady again after the pause
            readmit(step_once([]), [])
        prof.start()
        prof.begin()
        t_sub, sub_admits = time.perf_counter(), []
        while (time.perf_counter() - t_sub < span or prof.steps < 2
               or (at_admission and not sub_admits)):
            readmit(step_once([]), sub_admits)
            if time.perf_counter() - t_sub > SUBWINDOW_LIMIT_S:
                break
        prof.stop()
        attn.restore()
        calls = attn.resolved()
        log(f"{len(calls)} attention calls recorded")
        trace = prof.reduce(calls)
    short = sum(1 for r in done_in
                if len(r.out_tokens) < r.max_new_tokens
                and len(r.prompt) + len(r.out_tokens) < eng.max_len - 2)
    samples = [(list(r.prompt), list(r.out_tokens)) for r in done_in]
    return Record(
        e2e={"output_tok_s": rate(window_out, window_s)},
        setup_s=setup_s,
        attempted=len(done_in),
        failed=short,
        window_s=window_s,
        samples=samples,
        data={
            "steps": steps,
            "admits": admits,
            "model_flops": flops["per_token"] * window_tokens + flops["per_ctx"] * window_ctx,
            "tokens_processed": window_tokens,
        },
        checks=[("short_budgets", float(short), 0.0)],
        trace=trace,
        memory_peak_bytes=peak,
        fingerprint={"clients": clients, "requests_done": len(done_in),
                     "out_tokens": window_out,
                     "prompt_tokens": sum(len(r.prompt) for r in done_in)},
    )
