"""LLMSched's testbed under open-loop compound-job traffic.

The window drives the port's main path: ``ServingCluster.run`` with an
``LLMSched`` scheduler over the engines ``build_engines`` makes from the
traffic file's ``serve`` settings, jobs sampled through
``repro_torch.sim.workloads.get_generators()`` (the cluster reveals their
dynamic stages through the same generators).

Traffic, from the traffic file and ``--seed``:

- the window's jobs are drawn from ``pool_seed`` (the apps of ``mix``, in
  its shares), those of the lead-in from ``pool_seed + 2``, so every seed
  serves the same work; the run's seed orders each and the gaps between
  arrivals;
- arrivals are open-loop at ``rate_per_s`` jobs a wall-clock second and
  stratified, not Poisson: the gaps are the exponential distribution's
  quantiles at ``(i + 0.5) / n``, in an order drawn from the seed, scaled
  so that the ``n`` arrivals of the window span it exactly.  Every seed
  then offers the same count and the same set of gaps; a Poisson draw
  would change the window's load from seed to seed.  ``ServingCluster`` divides arrival times
  by ``time_scale``, so they are handed over multiplied by it;
- each LLM task's output is capped at ``max_task_tokens`` served tokens,
  as a deployment's ``max_tokens`` caps it; the cap reaches only the
  upper tail of the planners' revealed LLM tools (``summarize``,
  ``caption``, ``qa``), and the window's every job then finishes within
  the drain;
- set-up fits the scheduler's Bayesian-network profiles, serves one job
  of each app (which prefills each app's system prompt into the prefix
  cache, as a live server holds it) and then a lead-in of ``lead_in_s``
  seconds of arrivals, so the window opens on a loaded server;
- with ``--trace 1``, once the window's jobs are done, a trailer of
  arrivals at the same rate holds the profiled sub-window (``_trailer``):
  the window itself runs untraced.

Jobs that arrive in the ``--seconds`` window are counted; arrivals then
stop and the run waits up to ``drain_s`` for them.  A job unfinished by
then has failed.  The harness stops the cluster from its own side by
wrapping this scheduler instance's ``schedule`` (which raises at the
limit) and ``observe_completion`` (which records each job's finish).
Spans come from the same wrappers and from each engine's ``step``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from bench.harness import Record, log, process_age_s


class _Cut(Exception):
    """The drain's limit was reached with jobs of the window unfinished."""


def _pool(gens, mix: Dict[str, float], n: int, seed: int) -> List[Any]:
    """``n`` jobs of the mix's apps in its shares (largest remainders),
    each sampled through its generator from one ``pool_seed`` stream."""
    names = sorted(mix)
    share = np.array([mix[a] for a in names], float)
    share = share / share.sum() * n
    counts = np.floor(share).astype(int)
    for i in np.argsort(-(share - counts))[: n - counts.sum()]:
        counts[i] += 1
    rng = np.random.default_rng(seed)
    return [gens[a].sample(rng, 0.0) for a, c in zip(names, counts) for _ in range(c)]


def _gaps(n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` exponential gaps of mean 1 at the quantiles ``(i + 0.5) / n``,
    in an order drawn from ``rng``."""
    q = (np.arange(n) + 0.5) / n
    return rng.permutation(-np.log1p(-q))


def _dynamic_llm(gj) -> List[Tuple[Dict[str, float], str]]:
    """``(durations, candidate)`` of each LLM stage the job's planner will
    reveal: the generator keeps each revealed stage's duration in the job's
    ``_dyn_durs``, from which the cluster makes its task.  A job whose
    dynamic stages are realised without it is refused, so the cap cannot
    stop applying unseen."""
    from repro_torch.core.dag import StageType
    from repro_torch.sim.workloads import get_generators

    if not gj.job.dynamic_realization:
        return []
    durs = gj.job.__dict__.get("_dyn_durs")
    if durs is None or set(durs) != set(gj.job.dynamic_realization):
        raise RuntimeError(f"{gj.job.app.name}: the job's dynamic stages keep their "
                           "durations elsewhere than _dyn_durs; the task cap cannot apply")
    gen = get_generators()[gj.job.app.name]
    return [(durs[dyn], c) for dyn, (chosen, _) in gj.job.dynamic_realization.items()
            for c in chosen if gen._cand_type(c) is StageType.LLM]


def _cap(gj, cap_tokens: int, token_scale: float) -> None:
    """Cap every LLM task of a job at ``cap_tokens`` served tokens,
    those of its dynamic stages (made when they are revealed) too."""
    from repro_torch.sim.workloads import TOKEN_LATENCY_B1

    top = cap_tokens * token_scale
    for st in gj.job.stages.values():
        for t in st.tasks:
            if t.is_llm:
                t.out_tokens = min(t.out_tokens, top)
    for durs, c in _dynamic_llm(gj):
        durs[c] = min(durs[c], (top + 0.5) * TOKEN_LATENCY_B1)


def _llm_tokens(gj, token_scale: float, min_tokens: int) -> int:
    """Served tokens the job's LLM tasks ask for, as the cluster scales them."""
    from repro_torch.sim.workloads import TOKEN_LATENCY_B1

    n = sum(max(min_tokens, int(t.out_tokens / token_scale))
            for st in gj.job.stages.values() for t in st.tasks if t.is_llm)
    for durs, c in _dynamic_llm(gj):
        n += max(min_tokens, int(int(durs[c] / TOKEN_LATENCY_B1) / token_scale))
    return n


def _llm_tasks(gj) -> int:
    n = sum(1 for st in gj.job.stages.values() for t in st.tasks if t.is_llm)
    return n + len(_dynamic_llm(gj))


def _trailer(cell, cluster, gens, prof, trailer, rate_s: float, seconds: float, cap: int,
             scfg):
    """The profiled sub-window, after the window's jobs are done: the
    profiler is warmed (its first start takes seconds), then arrivals go
    on at the window's rate, from ``pool_seed + 4``; the sub-window opens
    ``trace_ramp_s`` into them, when the engine is loaded again, and lasts
    ``trace_s`` (two steps at least); then the run stops."""
    tr = cell.traffic
    n = max(2, round(rate_s * seconds))
    jobs = _pool(gens, tr["mix"], n, tr["pool_seed"] + 4)
    rng = np.random.default_rng(cell.seed + 4)
    jobs = [jobs[i] for i in rng.permutation(n)]
    g = _gaps(n, rng)
    for gj, t in zip(jobs, seconds * np.concatenate([[0.0], np.cumsum(g)[:-1]]) / g.sum()):
        _cap(gj, cap, scfg.token_scale)
        gj.job.arrival_time = float(t) * scfg.time_scale
    prof.warm()
    trailer.update(on=True, t0=time.perf_counter())
    try:
        cluster.run(jobs)
    except _Cut:
        pass
    if prof.on:
        prof.stop()
    if prof.prof is None:
        raise RuntimeError("the trailer ended before its sub-window opened")
    return prof.reduce([])


def run(cell) -> Record:
    from repro_torch.core import LLMSched, ProfileStore
    from repro_torch.serving import ServeConfig, ServingCluster, build_engines
    from repro_torch.sim import generate_traces, get_generators

    tr = cell.traffic
    W = float(cell.seconds)
    scfg = ServeConfig(**tr["serve"])
    gens = get_generators()
    prof_cfg = tr["profiles"]
    store = ProfileStore().fit([g.template for g in gens.values()],
                               generate_traces(prof_cfg["mix"], prof_cfg["traces"],
                                               seed=prof_cfg["seed"]))
    engines = build_engines(cell.model_cfg, scfg, params=cell.params, device=cell.device)
    sch = tr["scheduler"]
    sched = LLMSched(store, epsilon=sch["epsilon"], seed=cell.seed % (1 << 63),
                     plan_ahead_s=sch["plan_ahead_s"])
    cluster = ServingCluster(sched, engines, scfg)
    ts, cap = scfg.time_scale, int(tr["max_task_tokens"])

    # -- set-up: one job of each app, which fills the prefix cache ----------
    warm = [gens[a].sample(np.random.default_rng(tr["pool_seed"] + 1), 0.0)
            for a in sorted(tr["mix"])]
    for gj in warm:
        _cap(gj, cap, scfg.token_scale)
    cluster.run(warm)

    # -- the traffic --------------------------------------------------------
    rate_s = float(tr["rate_per_s"])
    L = float(tr["lead_in_s"])
    n_lead = max(1, round(rate_s * L))
    n_win = max(1, round(rate_s * W))
    rng = np.random.default_rng(cell.seed)
    lead, window = (_pool(gens, tr["mix"], n, tr["pool_seed"] + k)
                    for k, n in ((2, n_lead), (0, n_win)))
    lead, window = ([p[i] for i in rng.permutation(len(p))] for p in (lead, window))
    for gj in lead + window:
        _cap(gj, cap, scfg.token_scale)
    g_lead, g_win = _gaps(n_lead, rng), _gaps(n_win, rng)
    t_lead = L * np.concatenate([[0.0], np.cumsum(g_lead)[:-1]]) / g_lead.sum()
    t_win = L + W * np.concatenate([[0.0], np.cumsum(g_win)[:-1]]) / g_win.sum()
    for gj, t in zip(lead + window, np.concatenate([t_lead, t_win])):
        gj.job.arrival_time = float(t) * ts
    win_ids = {gj.job.job_id: gj for gj in window}
    fingerprint = {
        "jobs": n_win,
        "llm_tasks": sum(_llm_tasks(gj) for gj in window),
        "out_tokens": sum(_llm_tokens(gj, scfg.token_scale, scfg.min_tokens)
                          for gj in window),
        "prompt_tokens": sum(_llm_tasks(gj) for gj in window)
        * (scfg.shared_prompt_tokens + 2),
        "lead_in_jobs": n_lead,
    }

    # -- the harness's wrappers ---------------------------------------------
    t_run = [0.0]
    finished: Dict[int, float] = {}
    sched_spans: List[tuple] = []
    step_spans: List[tuple] = []
    admitted: List[tuple] = []
    snap: Dict[str, Any] = {}
    prof = cell.profiler
    span = float(tr.get("trace_s", 1.5))
    ramp = float(tr.get("trace_ramp_s", 8.0))
    drain = float(tr["drain_s"])
    trailer: Dict[str, Any] = {"on": False}
    orig_schedule, orig_done = sched.schedule, sched.observe_completion

    def schedule(jobs, view):
        t0 = time.perf_counter()
        if trailer["on"] and trailer.get("done"):
            raise _Cut()
        if not trailer["on"] and t0 > t_run[0] + L + W + drain:
            raise _Cut()
        if prof is not None and prof.on:
            with torch.profiler.record_function("bench::schedule"):
                dec = orig_schedule(jobs, view)
        else:
            dec = orig_schedule(jobs, view)
        sched_spans.append((t0, time.perf_counter()))
        return dec

    def observe_completion(job, now):
        finished[job.job_id] = now
        return orig_done(job, now)

    sched.schedule, sched.observe_completion = schedule, observe_completion

    def wrap(eng):
        step0, admit0 = eng.step, eng.admit

        def step():
            if (trailer["on"] and prof.marker is None and not trailer.get("done")
                    and time.perf_counter() - trailer["t0"] >= ramp):
                prof.start()
                prof.begin()
                trailer["t_begin"] = time.perf_counter()
            t0 = time.perf_counter()
            rel = t0 - t_run[0]
            if "open" not in snap and rel >= L:
                snap["open"] = (t0, eng.prefill_skipped_tokens)
                snap["setup_s"] = process_age_s()
            if "close" not in snap and rel >= L + W:
                snap["close"] = (t0, eng.prefill_skipped_tokens)
            if prof is not None and prof.on:
                with torch.profiler.record_function("bench::engine_step"):
                    out = step0()
                prof.steps += 1
                if time.perf_counter() - trailer["t_begin"] >= span and prof.steps >= 2:
                    prof.stop()
                    trailer["done"] = True
            else:
                out = step0()
            step_spans.append((t0, time.perf_counter()))
            return out

        def admit(req):
            ok = admit0(req)
            if ok:
                admitted.append((time.perf_counter(), req))
            return ok

        eng.step, eng.admit = step, admit

    for eng in engines:
        wrap(eng)

    # -- the window ---------------------------------------------------------
    t_run[0] = time.perf_counter()
    cut = False
    try:
        cluster.run(lead + window)
    except _Cut:
        cut = True
    t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    t_open = t_run[0] + L
    t_close = t_open + W
    close_skip = snap.get("close", (t_end, engines[0].prefill_skipped_tokens))[1]
    d = [b - a for a, b in step_spans if t_open <= a < t_close]
    log(f"window steps: {len(d)}, {1e3 * sum(d) / max(1, len(d)):.2f} ms each")

    # -- what the window served ---------------------------------------------
    jcts, unfinished = [], 0
    for jid, gj in sorted(win_ids.items(), key=lambda kv: kv[1].job.arrival_time):
        arr = gj.job.arrival_time / ts
        if jid in finished:
            jcts.append(finished[jid] - arr)
        else:
            unfinished += 1
            jcts.append(t_end - t_run[0] - arr)   # censored at the cut
    reqs = [(t, r) for t, r in admitted if t_open <= t < t_close]
    bad_budget = 0
    samples = []
    for _, r in reqs:
        if r.finished_at < 0:
            continue
        full = len(r.out_tokens) >= r.max_new_tokens
        capped = len(r.prompt) + len(r.out_tokens) >= scfg.max_len - 2
        if not (full or capped):
            bad_budget += 1
        samples.append((list(r.prompt), list(r.out_tokens)))
    leaks = 0
    if not cut:
        for eng in engines:
            try:
                eng.allocator.check_no_leaks(allow_indexed=True)
            except AssertionError:
                leaks += 1
    d = [b - a for a, b in step_spans if t_open <= a < t_close]
    log(f"window steps: {len(d)}, {1e3 * sum(d) / max(1, len(d)):.2f} ms each")
    trace = None
    if prof is not None:
        trace = _trailer(cell, cluster, gens, prof, trailer, rate_s, ramp + span + 5.0,
                         cap, scfg)
    rec = Record(
        e2e={"avg_jct_s": float(np.mean(jcts))},
        setup_s=snap.get("setup_s", process_age_s()),
        attempted=n_win,
        failed=unfinished + bad_budget,
        window_s=W,
        samples=samples,
        data={
            "jcts": jcts,               # in the order of arrival
            "sched": [(a, b) for a, b in sched_spans if t_open <= a < t_close],
            "steps": [(a, b) for a, b in step_spans if t_open <= a < t_close],
            "prefix_skipped": close_skip - snap.get("open", (0, close_skip))[1],
            "prefix_prefilled": sum(r.prefill_tokens for _, r in reqs),
            "drain_used_s": max([finished[j] for j in win_ids if j in finished], default=0.0)
            - (L + W),
        },
        checks=[("unfinished_jobs", float(unfinished), 0.0),
                ("short_budgets", float(bad_budget), 0.0),
                ("kv_leaks", float(leaks if not cut else 1), 0.0)],
        trace=trace,
        memory_peak_bytes=peak,
        fingerprint=fingerprint,
    )
    return rec
