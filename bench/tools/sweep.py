"""Find a testbed cell's knee: the same cell at several fixed arrival rates.

    python3 bench/tools/sweep.py --workload stablelm-agents-sysprompt \\
        --rates 2,3,4,5 --seconds 40 --seed 7

One process, one run a rate (weights, engines and set-up anew each time),
each printed as a JSON line with the mean and 95th-percentile JCT, the
mean JCT of the jobs of the window's first and second halves (a backlog
that grows shows as a later half that waits longer), the unfinished jobs
and how long after the window's close the last of its jobs finished
(``drain_used_s``).  The knee is the highest rate whose
backlog does not grow: every job of the window finishes, and the drain
does not grow with the rate.  Run on one H100.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    os.environ.update(harness.cache_env(ROOT))
    os.environ.update(harness.THREAD_ENV)
    import torch

    torch.set_num_threads(1)

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for i, r in enumerate(float(x) for x in args.rates.split(",")):
        out, checks, rec = harness.run_cell(
            ROOT, bench, args.workload, args.seed + i, args.seconds, False,
            torch.device("cuda", 0), overrides={"traffic": {"rate_per_s": r}})
        jcts = rec.data["jcts"]
        print(json.dumps({"rate_per_s": r, "jobs": len(jcts),
                          "avg_jct_s": out["metrics"]["avg_jct_s"]["value"],
                          "jct_p95_s": harness.percentile(jcts, 95),
                          "failed": rec.failed, "drain_used_s": rec.data["drain_used_s"],
                          "avg_jct_halves": [float(sum(h) / len(h)) for h in
                                             (jcts[: len(jcts) // 2], jcts[len(jcts) // 2:])],
                          "steps": len(rec.data["steps"]),
                          "step_ms": 1e3 * sum(b - a for a, b in rec.data["steps"])
                          / max(1, len(rec.data["steps"])),
                          "correct": out["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
