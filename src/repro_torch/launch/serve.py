"""Serving launcher: LLMSched-scheduled compound jobs on real engines.

Port of ``repro/launch/serve.py``, with the same flags and the same
``[serve]`` line, plus ``--device``: the engines run on the CUDA device
unless ``--device cpu`` is given.

The paper's end-to-end entry point: spin up N continuous-batching engine
replicas with a (smoke) model, train the Bayesian-network profiles from
history, then run a compound-LLM workload through the uncertainty-aware
scheduler and report average JCT against a chosen baseline.

Replicas share one set of weights (as same-model replicas do in
production), which is what makes ``--migrate`` lossless: a decoding
request's KV pages can be handed to any peer and continue
token-for-token.  ``--kv-pages`` makes the fleet heterogeneous — e.g.
``--kv-pages 13,49`` gives replica 0 a small page pool and replica 1 a
large one, the regime where uncertainty-aware placement and live
migration earn their keep.

``--prefix-cache`` (paged engines only) enables shared-prefix KV reuse:
each replica keeps a radix index over full prompt pages, admission
adopts cached prefixes copy-free, and the scheduler's placement score
gains the cache-affinity term.  Pair it with ``--shared-prompt N`` so
each application's tasks actually share an N-token system prompt —
the workload shape where the cache pays.

``--models a,b`` declares a **heterogeneous pool** (one model name per
replica, priced through the model-zoo tier table) — the scheduler then
routes stages by uncertainty-reduction-per-cost.  Add
``--gate-strictness s`` to score stage outputs with a deterministic
quality gate, and ``--cascade`` to escalate rejections one cost tier
up; the run then reports serving cost, escalations, and
cost-efficiency.

``--kv-dtype int8`` (paged engines only) stores each replica's KV pages
as int8 with per-page scale pools, dequantized inside the int8 paged
attention kernels: the same page count then costs 1.88x fewer bytes than
bf16 pages at stablelm-1.6b's widths.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
      --mix planning --jobs 12 --scheduler llmsched
  PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
      --replicas 2 --kv-pages 13,49 --migrate --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
      --replicas 2 --prefix-cache --shared-prompt 32
  PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
      --kv-dtype int8 --replicas 2 --kv-pages 13,49 --migrate --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_smoke_config
from repro_torch.core import DeterministicGate, LLMSched, ProfileStore, make_baselines
from repro_torch.serving import ServeConfig, ServingCluster, build_engines

from repro_torch.sim import generate_traces, generate_workload, get_generators
from repro_torch.sim.workloads import generate_tiered_workload


def build_scheduler(name: str, store: ProfileStore, epsilon: float, seed: int,
                    plan_ahead_s: float = 30.0):
    """Instantiate LLMSched or a named baseline scheduler."""
    if name == "llmsched":
        return LLMSched(store, epsilon=epsilon, seed=seed,
                        plan_ahead_s=plan_ahead_s)
    return make_baselines(store)[name]


def config_from_args(args) -> ServeConfig:
    """Map the CLI namespace onto a validated :class:`ServeConfig`."""
    kv_pages = None
    n = args.replicas if args.replicas is not None else args.engines
    if args.kv_pages:
        kv_pages = tuple(int(x) for x in args.kv_pages.split(","))
    models = tuple(args.models.split(",")) if args.models else None
    try:
        return ServeConfig(
            engine=args.engine,
            replicas=n,
            models=models,
            cascade=args.cascade,
            max_batch=args.max_batch,
            max_len=96,
            page_size=args.page_size,
            kv_pages=kv_pages,
            kv_dtype=args.kv_dtype,
            migrate=args.migrate,
            prefix_cache=args.prefix_cache,
            shared_prompt_tokens=args.shared_prompt,
            n_regular=args.regular,
            token_scale=args.token_scale,
            time_scale=args.token_scale,
            seed=args.seed,
            plan_ahead_s=args.plan_ahead,
            slo_tightness=args.slo_tightness,
        )
    except ValueError as e:
        raise SystemExit(str(e))


def main(argv=None) -> int:
    """Entry point for ``python -m repro_torch.launch.serve``; returns 0."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--mix", default="planning",
                    choices=["mixed", "predefined", "chain", "planning"])
    ap.add_argument("--jobs", type=int, default=12)
    ap.add_argument("--scheduler", default="llmsched",
                    choices=["llmsched", "fcfs", "fair", "sjf", "argus",
                             "carbyne", "decima"])
    ap.add_argument("--engines", type=int, default=1,
                    help="deprecated alias of --replicas")
    ap.add_argument("--replicas", type=int, default=None,
                    help="number of LLM engine replicas")
    ap.add_argument("--engine", default="slot", choices=["slot", "paged"],
                    help="slot: dense per-slot KV; paged: block-table pool")
    ap.add_argument("--migrate", action="store_true",
                    help="live-migrate KV off starved replicas (paged only)")
    ap.add_argument("--kv-pages", default=None,
                    help="comma list of per-replica page-pool sizes "
                         "(heterogeneous KV budgets), e.g. 13,49")
    ap.add_argument("--kv-dtype", default="fp32", choices=["fp32", "int8"],
                    help="paged KV page storage: fp32 keeps compute-dtype "
                         "pages, int8 quantizes with per-page scales "
                         "(1.88x the tokens per byte of bf16 pages at "
                         "hd 64; paged only)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="shared-prefix KV reuse via a radix index "
                         "(paged only)")
    ap.add_argument("--shared-prompt", type=int, default=0,
                    help="tokens of per-application shared system prompt "
                         "prepended to every LLM task's request")
    ap.add_argument("--models", default=None,
                    help="comma list of per-replica model names "
                         "(heterogeneous pool), e.g. "
                         "stablelm_1_6b,internlm2_20b; overrides --arch")
    ap.add_argument("--cascade", action="store_true",
                    help="escalate quality-gate rejections one cost tier "
                         "up (needs --models naming >1 tier and a "
                         "--gate-strictness gate)")
    ap.add_argument("--gate-strictness", type=float, default=None,
                    help="attach a DeterministicGate with this strictness "
                         "in [0,1] to score stage outputs")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--regular", type=int, default=4)
    ap.add_argument("--epsilon", type=float, default=0.2)
    ap.add_argument("--token-scale", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slo", action="store_true",
                    help="attach tiered SLOs (interactive/batch/best-effort "
                         "deadlines) to every job and report goodput")
    ap.add_argument("--slo-tightness", type=float, default=1.0,
                    help="deadline-tightening factor for --slo workloads")
    ap.add_argument("--plan-ahead", type=float, default=30.0,
                    help="LLMSched SLO plan-ahead window W in workload "
                         "seconds")
    ap.add_argument("--device", default=None,
                    help="where the engines run: a torch device such as "
                         "cuda, cuda:1 or cpu (default: the CUDA device)")
    args = ap.parse_args(argv)

    serve_cfg = config_from_args(args)

    gens = get_generators()
    apps = [g.template for g in gens.values()]
    store = ProfileStore().fit(apps, generate_traces(args.mix, 300, seed=7))

    cfg = None if serve_cfg.models else get_smoke_config(args.arch)
    try:
        engines = build_engines(cfg, serve_cfg, device=args.device)
    except ValueError as e:
        raise SystemExit(str(e))
    sched = build_scheduler(args.scheduler, store, args.epsilon, args.seed,
                            plan_ahead_s=serve_cfg.plan_ahead_s)
    gate = None
    if args.gate_strictness is not None:
        try:
            gate = DeterministicGate(
                strictness=args.gate_strictness, seed=args.seed
            )
        except ValueError as e:
            raise SystemExit(str(e))
    elif serve_cfg.cascade:
        raise SystemExit("--cascade requires --gate-strictness")
    cluster = ServingCluster(sched, engines, serve_cfg, gate=gate)
    if args.slo:
        wl = generate_tiered_workload(
            args.mix, args.jobs, arrival_rate=0.9, seed=args.seed,
            tightness=serve_cfg.slo_tightness,
        )
    else:
        wl = generate_workload(args.mix, args.jobs, arrival_rate=0.9,
                               seed=args.seed)
    res = cluster.run(wl)
    goodput = res.goodput()
    slo_part = (
        "" if goodput is None
        else f" goodput={goodput:.2f}"
        + "".join(
            f" goodput[{t}]={g:.2f}"
            for t, g in sorted(res.goodput_by_tier().items())
        )
    )
    cost_part = ""
    if res.cost_by_job:
        eff = res.cost_efficiency()
        cost_part = (
            f" cost={res.total_cost:.3e}"
            f" escalations={res.escalations}"
            + (f" cost_eff={eff:.1f}" if eff is not None else "")
        )
    print(
        f"[serve] scheduler={args.scheduler} mix={args.mix} "
        f"replicas={len(engines)} jobs={len(res.jcts)} "
        f"avg_jct={res.avg_jct:.2f}s makespan={res.makespan:.1f}s "
        f"tokens={res.tokens_generated} overhead={res.avg_overhead_ms:.2f}ms "
        f"preemptions={res.preemptions} migrations={res.migrations} "
        f"prefill={res.prefill_tokens} prefill_saved={res.prefill_saved_tokens}"
        f"{slo_part}{cost_part}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
