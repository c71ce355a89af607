"""``examples/serve_compound_torch.py``, the testbed example on the port.

On the CPU (``--device cpu``) at 2 jobs: every job of every run finishes,
on one engine (slot and paged, LLMSched and FCFS) and on a two-replica
paged fleet with ``--migrate``; without ``--device`` on a machine with no
CUDA device it raises, never falling back to the CPU.
"""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]


def _example():
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import serve_compound_torch
    finally:
        sys.path.remove(str(REPO / "examples"))
    return serve_compound_torch


@pytest.mark.parametrize("extra,fleets", [
    ([], [("slot", 1), ("paged", 1)]),
    (["--replicas", "2", "--migrate"], [("paged", 2)]),
])
def test_every_job_finishes_on_the_cpu(extra, fleets, capsys):
    runs = _example().main(["--jobs", "2", "--device", "cpu", *extra])
    assert [(e, r) for _, e, r, _, _ in runs] == [f for f in fleets for _ in range(2)]
    assert [name for name, *_ in runs] == ["llmsched", "fcfs"] * len(fleets)
    for name, engine, replicas, n_jobs, res in runs:
        assert n_jobs == 2 and len(res.jcts) == 2, (name, engine)
        assert res.tokens_generated > 0 and res.avg_jct > 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("engine model: stablelm-smoke") and out[0].endswith("on cpu")
    assert len(out) == 1 + len(runs) and all(" jobs=2 " in ln for ln in out[1:])


def test_without_a_device_and_without_cuda_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example().main(["--jobs", "2"])
