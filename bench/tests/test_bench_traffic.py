"""The traffic generators: every seed asks for the same work, and the
testbed's task cap holds on the stages a planner reveals."""

from __future__ import annotations

import json

import numpy as np
import pytest

from bench.drivers import offline, testbed

CAP, SCALE = 256, 8


def _planning_pool(root, n=300):
    from repro_torch.sim.workloads import get_generators

    tr = json.loads((root / "bench/traffic/agents_sysprompt.json").read_text())
    gens = get_generators()
    return gens, testbed._pool(gens, tr["mix"], n, tr["pool_seed"])


def test_task_cap_holds_on_revealed_stages(root):
    """Every LLM task the cluster makes, those of the planner's revealed
    stages too, asks for at most the cap; the cap bites on some."""
    from repro_torch.sim.workloads import TOKEN_LATENCY_B1

    gens, jobs = _planning_pool(root)
    before = [int(durs[c] / TOKEN_LATENCY_B1) / SCALE
              for gj in jobs for durs, c in testbed._dynamic_llm(gj)]
    assert before and max(before) > CAP
    for gj in jobs:
        testbed._cap(gj, CAP, SCALE)
        n_tasks = testbed._llm_tasks(gj)
        assert testbed._llm_tokens(gj, SCALE, 1) <= n_tasks * CAP
        gen = gens[gj.job.app.name]
        for dyn in list(gj.job.dynamic_realization):
            for st in gen.expand_dynamic(gj.job, dyn):
                for t in st.tasks:
                    if t.is_llm:
                        assert t.out_tokens / SCALE <= CAP + 1e-9
        for st in gj.job.stages.values():
            for t in st.tasks:
                if t.is_llm:
                    assert t.out_tokens / SCALE <= CAP


def test_task_cap_refuses_a_job_without_its_revealed_durations(root):
    _, jobs = _planning_pool(root, 4)
    gj = next(g for g in jobs if g.job.dynamic_realization)
    del gj.job._dyn_durs
    with pytest.raises(RuntimeError):
        testbed._cap(gj, CAP, SCALE)


def test_every_seed_gets_the_same_gaps_and_sizes(root):
    a = testbed._gaps(200, np.random.default_rng(2**33 + 1))
    b = testbed._gaps(200, np.random.default_rng(5))
    assert np.array_equal(np.sort(a), np.sort(b)) and not np.array_equal(a, b)
    assert abs(a.mean() - 1.0) < 0.01
    tr = json.loads((root / "bench/traffic/azure_code_closed64.json").read_text())
    x, y = offline._sizes(tr, 2**33 + 1), offline._sizes(tr, 5)
    assert sorted(x) == sorted(y) and x != y and len(x) == tr["pool"]
    plen = np.array([p for p, _ in x])
    olen = np.array([o for _, o in x])
    assert np.median(plen) == pytest.approx(tr["prompt_tokens"]["median"], rel=0.05)
    assert np.median(olen) == pytest.approx(tr["output_tokens"]["median"], rel=0.1)
    assert plen.max() + olen.max() <= tr["engine"]["max_len"] and olen.min() >= 1
