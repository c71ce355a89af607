"""End-to-end serving example (the paper's testbed, CPU-scaled), on the port.

The PyTorch twin of ``examples/serve_compound.py``: a real
continuous-batching engine (the port's decode over a smoke-size
stablelm-family model) serves compound LLM jobs whose admission order is
decided by LLMSched; compare against FCFS on the same workload, with
both the slot-based and the paged KV-cache engine.  The same fleet, the
same workload (``planning``, ``arrival_rate=0.9``, ``seed=11``), the
same schedulers and the same line a run.

``--device`` places the engines: the CUDA device unless ``--device cpu``
is given (``repro_torch.device.resolve_device``; no fallback: without a
CUDA device and without ``--device`` it raises).

Multi-replica mode: ``--replicas N`` spins up N paged engines sharing
one set of weights (replica 0 gets a deliberately small page pool so KV
pressure is visible), and ``--migrate`` turns on Llumnix-style live
migration — watch the ``migrations`` counter replace ``preemptions``.

Run:
  PYTHONPATH=src python examples/serve_compound_torch.py --device cpu
  PYTHONPATH=src python examples/serve_compound_torch.py --replicas 2 --migrate --device cpu
"""

import argparse

from repro_torch.configs import get_smoke_config
from repro_torch.core import FCFS, LLMSched, ProfileStore
from repro_torch.device import resolve_device
from repro_torch.serving import ServeConfig, ServingCluster, build_engines
from repro_torch.sim import generate_traces, generate_workload, get_generators


def config_for(engine: str, replicas: int, migrate: bool) -> ServeConfig:
    """Fleet shape for this demo; replica 0 of a multi-replica paged
    fleet gets a deliberately small page pool so KV pressure (and the
    value of migration) is visible."""
    kv_pages = None
    if engine == "paged" and replicas > 1:
        # None entries are not expressible in ServeConfig.kv_pages (it
        # pins every pool); starve replica 0, default-size the rest
        kv_pages = tuple([13] + [49] * (replicas - 1))
    return ServeConfig(
        engine=engine,
        replicas=replicas,
        max_batch=8 if engine == "paged" else 4,
        max_len=96,
        page_size=16,
        kv_pages=kv_pages,
        migrate=migrate,
        n_regular=4,
        token_scale=24.0,
        time_scale=24.0,
        seed=0,
    )


def run_one(name, sched, wl, cfg, serve_cfg: ServeConfig, device):
    engines = build_engines(cfg, serve_cfg, device=device)
    cluster = ServingCluster(sched, engines, serve_cfg)
    res = cluster.run(wl)
    print(f"{name:10s} engine={serve_cfg.engine:5s} "
          f"replicas={serve_cfg.replicas} "
          f"avg_jct={res.avg_jct:6.2f}s jobs={len(res.jcts)} "
          f"tokens={res.tokens_generated} "
          f"sched_overhead={res.avg_overhead_ms:.2f}ms "
          f"preemptions={res.preemptions} migrations={res.migrations}")
    return res


def main(argv=None):
    """Runs the demo; returns ``[(scheduler, engine, replicas, n_jobs,
    result), ...]``, one entry a run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=1,
                    help="LLM engine replicas (paged, shared weights)")
    ap.add_argument("--migrate", action="store_true",
                    help="live-migrate KV off starved replicas")
    ap.add_argument("--jobs", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="where the engines run: a torch device such as "
                         "cuda, cuda:1 or cpu (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    gens = get_generators()
    apps = [g.template for g in gens.values()]
    store = ProfileStore().fit(apps, generate_traces("planning", 300, seed=7))
    cfg = get_smoke_config("stablelm_1_6b")
    print(f"engine model: {cfg.name} ({cfg.n_layers}L d={cfg.d_model}) on {device}")

    if args.replicas > 1:
        # multi-replica paged fleet: llmsched vs fcfs, migration per flag
        fleets = [config_for("paged", args.replicas, args.migrate)]
    else:
        fleets = [config_for(engine, 1, migrate=False) for engine in ("slot", "paged")]
    runs = []
    for serve_cfg in fleets:
        for name, sched in [
            ("llmsched", LLMSched(store, epsilon=0.2, seed=0)),
            ("fcfs", FCFS()),
        ]:
            wl = generate_workload("planning", args.jobs, arrival_rate=0.9,
                                   seed=11)
            res = run_one(name, sched, wl, cfg, serve_cfg, device)
            runs.append((name, serve_cfg.engine, serve_cfg.replicas, len(wl), res))
    return runs


if __name__ == "__main__":
    main()
