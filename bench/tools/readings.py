"""The readings a cell's correctness limit is set from.

    python3 bench/tools/readings.py --workload <cell> --seeds 1,2,3 --seconds 20

For each seed, one run of the cell as ``bench/run.py`` makes it (the
program's served tokens judged by the float32 reference: the lower
reading), and on the same judged sample the control: the reference
computed in float8 e4m3 put in the program's place (the upper reading),
and a witness: the reference in bf16, what rounding in the served dtype
alone reads.  Each as the widest and the mean gap.
One process for all seeds, so the kernels load once.  Prints one JSON line
a seed.  Run on one H100; ``--device cpu`` with ``--config``
reads a smoke configuration on the CPU.
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default=None)
    ap.add_argument("--overrides", default=None, help="JSON of traffic/limits keys")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness, judge

    os.environ.update(harness.cache_env(ROOT))
    os.environ.update(harness.THREAD_ENV)
    import torch

    torch.set_num_threads(1)

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    got = {}

    def control(cell, rec) -> None:
        lim = cell.limits
        sample = judge.draw(rec.samples, cell.seed, lim["judged_tokens"], lim["max_requests"])
        prog = judge.served_gaps(cell.params, cell.config, sample, cell.device)
        got["judged_tokens"] = int(prog.size)
        got["program"] = {k: float(f(prog)) for k, f in judge.STATISTICS.items()}
        for mode, key in (("fp8", "control"), ("bf16", "bf16_witness")):
            gaps = judge.control_gaps(cell.params, cell.config, sample, cell.device, mode)
            got[key] = {k: float(f(gaps)) for k, f in judge.STATISTICS.items()}

    for seed in (int(s) for s in args.seeds.split(",")):
        out, checks, rec = harness.run_cell(
            ROOT, bench, args.workload, seed, args.seconds, False, torch.device(args.device),
            config_file=Path(args.config) if args.config else None,
            overrides=json.loads(args.overrides) if args.overrides else None, after=control)
        print(json.dumps({"seed": seed, **got, "correct": out["correct"],
                          "metrics": out["metrics"], "failed": out["failed"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
