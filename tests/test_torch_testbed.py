"""The port's testbed against the JAX package's: core copies, cluster, launcher.

- ``repro_torch.core`` and ``repro_torch.sim`` are copies of the JAX
  package's numpy-only modules, so the port's ``ClusterSim`` must give the
  JAX simulator's per-job JCTs exactly, as floats, under LLMSched and every
  baseline, with ``ProfileStore``\\ s fitted from the same traces;
- ``ServingCluster`` over the port's slot engines (bridged weights, on the
  CPU) must serve the same jobs with the same tokens and prefill as the
  JAX cluster under FCFS (wall-clock JCTs are not compared);
- ``python -m repro_torch.launch.serve --device cpu`` runs every scheduler
  over slot and fp-paged replicas.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

import repro.core as JC
import repro.sim as JS
import repro_torch.core as TC
import repro_torch.sim as TS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.serving import LLMEngine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingCluster as JaxCluster
from repro.sim.simulator import ClusterSim as JaxSim
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.serving import LLMEngine, ServeConfig, ServingCluster, build_engines
from repro_torch.sim.simulator import ClusterSim

SCHEDULERS = ["llmsched", "fcfs", "fair", "sjf", "argus", "carbyne", "decima"]
# the simulator's cluster shapes: one plain, one fleet with heterogeneous
# replicas, KV budgets, migration and the shared-prefix model
SIM_SHAPES = {
    "plain": dict(n_regular=4, n_llm=2, max_batch=8),
    "fleet": dict(n_regular=4, n_llm=2, max_batch=[4, 8],
                  kv_budget_tokens=[600, 2400], migrate=True,
                  prompt_tokens_per_task=64, shared_prompt_tokens=48,
                  prefix_cache=True),
}


def _by_order(d: dict) -> list:
    """Values in job-id order (ids come from a per-package global counter,
    so the two packages' ids may be offset)."""
    return [d[k] for k in sorted(d)]


def _scheduler(core, store, name):
    if name == "llmsched":
        return core.LLMSched(store, epsilon=0.2, seed=0)
    return core.make_baselines(store)[name]


def _sim(core, sim, sim_cls, name, shape):
    gens = sim.get_generators()
    apps = [g.template for g in gens.values()]
    store = core.ProfileStore().fit(apps, sim.generate_traces("mixed", 120, seed=7))
    wl = sim.generate_workload("mixed", 15, arrival_rate=0.9, seed=3)
    return sim_cls(_scheduler(core, store, name), seed=3, **SIM_SHAPES[shape]).run(wl)


@pytest.mark.parametrize("shape", sorted(SIM_SHAPES))
@pytest.mark.parametrize("name", SCHEDULERS)
def test_cluster_sim_jcts_equal_jax(name, shape):
    want = _sim(JC, JS, JaxSim, name, shape)
    got = _sim(TC, TS, ClusterSim, name, shape)
    assert len(got.jcts) == 15
    assert _by_order(got.jct_by_job) == _by_order(want.jct_by_job)
    assert _by_order(got.prefill_by_job) == _by_order(want.prefill_by_job)
    assert (got.preemptions, got.migrations) == (want.preemptions, want.migrations)


def test_serving_cluster_matches_jax_under_fcfs():
    """Same jobs, tokens and per-job prefill as the JAX cluster (FCFS, slot
    engines, bridged float32 weights, one process: ``_prompt_for`` hashes
    stage names)."""
    jcfg = jax_smoke_config("stablelm_1_6b").with_(dtype="float32")
    tcfg = get_smoke_config("stablelm_1_6b").with_(dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))[0]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    runs = {}
    for label, core, sim, cluster_cls, cfg_cls, engine in (
        ("jax", JC, JS, JaxCluster, JaxServeConfig,
         lambda: JaxEngine(jcfg, max_batch=4, max_len=96, params=jparams)),
        ("port", TC, TS, ServingCluster, ServeConfig,
         lambda: LLMEngine(tcfg, max_batch=4, max_len=96, params=tparams,
                           device="cpu")),
    ):
        wl = sim.generate_workload("chain", 5, arrival_rate=2.0, seed=4)
        cluster = cluster_cls(core.FCFS(), [engine()],
                              cfg_cls(n_regular=3, token_scale=30.0, time_scale=30.0))
        runs[label] = cluster.run(wl)
    want, got = runs["jax"], runs["port"]
    assert len(got.jct_by_job) == len(want.jct_by_job) == 5
    assert got.tokens_generated == want.tokens_generated > 0
    assert got.prefill_tokens == want.prefill_tokens
    assert _by_order(got.prefill_by_job) == _by_order(want.prefill_by_job)
    assert got.preemptions == want.preemptions == 0


def test_build_engines_on_cpu_shares_weights_and_builds_int8_fleets():
    cfg = get_smoke_config("stablelm_1_6b")
    paged = build_engines(cfg, ServeConfig(engine="paged", replicas=2,
                                           kv_pages=(13, 49)), device="cpu")
    assert [e.num_pages for e in paged] == [13, 49]
    assert paged[0].params["embedding"] is paged[1].params["embedding"]
    assert all(e.device.type == "cpu" for e in paged)
    slot = build_engines(cfg, ServeConfig(replicas=2), device="cpu")
    assert [type(e) for e in slot] == [LLMEngine, LLMEngine]
    int8 = build_engines(cfg, ServeConfig(engine="paged", replicas=2,
                                          kv_pages=(13, 49), kv_dtype="int8"),
                         device="cpu")
    assert [e.num_pages for e in int8] == [13, 49]
    assert all(e.kv_dtype == "int8" for e in int8)
    assert int8[0].pools["blocks"]["0"]["k"].dtype == torch.int8
    assert int8[0].params["embedding"] is int8[1].params["embedding"]


LAUNCH = ["--jobs", "3", "--token-scale", "40", "--device", "cpu"]


@pytest.mark.parametrize("scheduler", SCHEDULERS)
@pytest.mark.parametrize("engine", [
    ["--engine", "slot"],
    ["--engine", "paged", "--replicas", "2", "--kv-pages", "13,49", "--migrate"],
])
def test_launcher_serves_on_cpu(capsys, engine, scheduler):
    assert serve.main(engine + ["--scheduler", scheduler] + LAUNCH) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[serve] scheduler={scheduler} ")
    assert " jobs=3 " in line


def test_launcher_serves_int8_pages_on_cpu(capsys):
    assert serve.main(["--engine", "paged", "--kv-dtype", "int8"] + LAUNCH) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[serve] scheduler=llmsched ") and " jobs=3 " in line
