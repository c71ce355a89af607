#!/usr/bin/env python
"""The port's determinism and seed lint (``repro_torch.analysis``).

Runs every registered AST checker over the given files/directories and
prints one ``path:line: [rule] message`` finding per violation.  Exits
non-zero when any unsuppressed finding remains: the repo is kept
suppress-free, so a finding here is a real nondeterminism source (or a
new rule that needs a reviewed ``# analysis: ignore[rule]``).

The counterpart of ``tools/run_analysis.py``, with the same flags; its
rules state the RNG discipline in PyTorch's idiom (a torch draw needs
``generator=``; ``torch.seed()`` seeds from the OS), and its default
sweep adds ``tools`` and ``chip_smoke.py``.

Usage:

    python tools/run_analysis_torch.py       # src benchmarks examples tests tools chip_smoke.py
    python tools/run_analysis_torch.py src/repro_torch/serving
    python tools/run_analysis_torch.py --rules global-rng,unseeded-rng
    python tools/run_analysis_torch.py --list-rules

Stdlib-only (no numpy or torch).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis import iter_py_files, rule_catalog, run_paths  # noqa: E402

DEFAULT_PATHS = ["src", "benchmarks", "examples", "tests", "tools", "chip_smoke.py"]


def main(argv=None) -> int:
    """Run the lint; return the process exit code."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "paths", nargs="*", default=None,
        help=f"files/directories to analyze (default: {' '.join(DEFAULT_PATHS)})",
    )
    ap.add_argument(
        "--rules", default=None,
        help="comma-separated rule ids to restrict the sweep to",
    )
    ap.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(rule_catalog().items()):
            print(f"{rule:16s} {desc}")
        return 0

    paths = args.paths or [str(ROOT / p) for p in DEFAULT_PATHS]
    rules = (
        {r.strip() for r in args.rules.split(",") if r.strip()}
        if args.rules
        else None
    )
    findings = run_paths(paths, rules)
    for f in findings:
        print(f)
    n_files = sum(1 for _ in iter_py_files(paths))
    if findings:
        print(f"\n{len(findings)} finding(s) across {n_files} files")
        return 1
    print(f"analysis clean: 0 findings across {n_files} files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
