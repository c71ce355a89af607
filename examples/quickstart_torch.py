"""Quickstart on the port: LLMSched end to end in ~1 minute on the CPU.

The port's counterpart of ``examples/quickstart.py``, over
``repro_torch.core`` and ``repro_torch.sim`` (numpy only; no device):

1. Build the six compound-LLM application templates.
2. Train per-application Bayesian-network profiles from execution history.
3. Simulate a mixed workload under LLMSched and the paper's baselines.
4. Print the average-JCT comparison (paper Fig. 7 in miniature).

Run:  PYTHONPATH=src python examples/quickstart_torch.py
"""

import numpy as np

from repro_torch.core import LLMSched, ProfileStore, make_baselines
from repro_torch.sim import generate_traces, get_generators, simulate
from repro_torch.sim.simulator import configure_cluster


def main() -> None:
    # 1. application templates (sequence sorting, doc merging, code
    #    generation, web search, task automation, LLMCompiler)
    gens = get_generators()
    apps = [g.template for g in gens.values()]
    print(f"applications: {[a.name for a in apps]}")

    # 2. profile from history: discretized durations -> BN structure+CPDs
    store = ProfileStore().fit(apps, generate_traces("mixed", 300, seed=7))
    prof = store["seq_sort"]
    print(f"seq_sort BN: {len(prof.bn.nodes)} nodes, "
          f"uncertainty-reducing stages: {prof.bn.uncertainty_reducing()}")

    # 3. cluster sized for ~95% load at λ=0.9 (paper §V setup)
    cluster = configure_cluster("mixed", arrival_rate=0.9, target_load=0.95)
    print(f"cluster: {cluster}")

    # 4. compare schedulers
    scheds = dict(make_baselines(store))
    scheds["llmsched"] = LLMSched(store, epsilon=0.2, seed=0)
    print(f"\n{'scheduler':12s} {'avg JCT (s)':>12s} {'overhead (ms)':>14s}")
    rows = []
    for name, s in scheds.items():
        js, ov = [], []
        for seed in (3, 11):
            r = simulate(s, mix="mixed", n_jobs=60, seed=seed, **cluster)
            js.append(r.avg_jct)
            ov.append(r.avg_overhead_ms)
        rows.append((float(np.mean(js)), name, float(np.mean(ov))))
    for jct, name, ov in sorted(rows):
        print(f"{name:12s} {jct:12.2f} {ov:14.2f}")


if __name__ == "__main__":
    main()
