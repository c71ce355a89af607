"""Run one cell of the benchmark and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and ``checks`` last);
the traffic's fingerprint is printed on standard error before it, and
each number compared beside its limit as standard error's last lines.

It exits with a code other than 0, and prints no result, where there is
no CUDA device or fewer than the cell asks for, where the program is not
there to run, and where a module of JAX or of the JAX package is loaded
once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: the hash seed every run has (set by re-executing this file with it)
HASH_SEED = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative integer")
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        # the scheduler's Bayesian-network inference iterates over sets of
        # names: with a fixed hash seed the same --seed makes the same run
        os.execve(sys.executable, [sys.executable] + sys.argv,
                  dict(os.environ, PYTHONHASHSEED=HASH_SEED))

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    os.environ.update(harness.cache_env(ROOT))
    os.environ.update(harness.THREAD_ENV)
    import torch

    torch.set_num_threads(1)

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out, checks, rec = harness.run_cell(ROOT, bench, args.workload, args.seed,
                                        args.seconds, bool(args.trace), device)
    bad = harness.forbidden_loaded(list(sys.modules))
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print("traffic " + json.dumps(rec.fingerprint, sort_keys=True), file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
