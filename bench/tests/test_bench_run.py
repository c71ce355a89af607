"""``bench/run.py`` refuses to run where it cannot measure the card."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest


def _run(cwd, *args):
    return subprocess.run([sys.executable, "bench/run.py", *args], capture_output=True,
                          text=True, cwd=cwd, timeout=300)


def test_no_result_without_a_card(root):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(root, "--workload", "stablelm-code-batch64", "--seed", str(2**31 + 5),
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_with_only_the_benchmark_files(root, tmp_path):
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    out = _run(tmp_path, "--workload", "stablelm-code-batch64", "--seed", "3",
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""


def test_unknown_workload_is_refused(root):
    out = _run(root, "--workload", "no-such-cell", "--seed", "1", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
