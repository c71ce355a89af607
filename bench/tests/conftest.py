"""Fixtures of the benchmark's own tests (``python -m pytest bench/tests``
from the root of the repository; the tests that need the card are marked
``gpu`` and skip elsewhere, inside the ``cuda`` fixture)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def root() -> Path:
    return ROOT


@pytest.fixture
def bench():
    from bench import harness

    return harness.load_json(ROOT / "BENCHMARK.json")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def smoke_run(bench, workload: str, seed: int = 2**33 + 7, seconds: float = 3.0,
              trace: bool = False, after=None):
    """One run of a cell at its smoke size on the CPU (the chip check is
    the only part of ``bench/run.py`` it leaves out).  A test plants a
    fault in the program before it calls this."""
    import torch

    from bench import harness

    torch.set_num_threads(2)      # several test workers share the machine's cores
    ov = json.loads((ROOT / "bench/tests/data/smoke_overrides.json").read_text())[workload]
    if "workload" in ov and workload not in {w["name"] for w in bench["workloads"]}:
        # a cell whose files the benchmark keeps for later, out of BENCHMARK.json
        bench = dict(bench, workloads=bench["workloads"] + [ov["workload"]])
    return harness.run_cell(ROOT, bench, workload, seed, seconds, trace, torch.device("cpu"),
                            config_file=ROOT / ov["config"],
                            overrides={"traffic": ov["traffic"]}, after=after)
