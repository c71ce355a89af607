"""A run with its timed path broken underneath comes out not correct.

Each test drives the whole of a run at the smoke size on the CPU (all of
``bench/run.py`` but its look for a card) with one fault planted in the
program's step functions, as the engines call them: a step that leaves
the KV state unchanged, half of the batch left out (its rows served the
other half's logits), and a served token altered where it is produced.
The cells run on one chip, so there is no exchange between chips to
leave out.
"""

from __future__ import annotations

import pytest
import torch

from conftest import smoke_run

CELLS = ["stablelm-agents-sysprompt", "stablelm-code-batch64"]


def _step_module(workload):
    import repro_torch.serving.paged_engine as m

    return m, "paged_decode_step"


def _state_unchanged(monkeypatch, workload):
    import repro_torch.models.paged as P

    monkeypatch.setattr(P, "_write_kv", lambda pool, idx, k, v: pool)


def _half_batch(monkeypatch, workload):
    mod, name = _step_module(workload)
    orig = getattr(mod, name)

    def step(*args, **kw):
        logits, state = orig(*args, **kw)
        B = logits.shape[0]
        out = logits.clone()
        out[B - B // 2:] = logits[: B // 2]
        return out, state

    monkeypatch.setattr(mod, name, step)


def _token_altered(monkeypatch, workload):
    mod, name = _step_module(workload)
    orig = getattr(mod, name)
    calls = [0]

    def step(*args, **kw):
        logits, state = orig(*args, **kw)
        calls[0] += 1
        if calls[0] % 3 == 0:
            logits = logits.clone()
            rows = torch.arange(logits.shape[0])
            low = logits.float().argmin(-1)
            logits[rows, low] = logits.float().max(-1).values.to(logits.dtype) + 10.0
        return logits, state

    monkeypatch.setattr(mod, name, step)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(bench, workload):
    out, _, _ = smoke_run(bench, workload)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_makes_the_run_not_correct(bench, monkeypatch, workload, fault):
    fault(monkeypatch, workload)
    out, checks, _ = smoke_run(bench, workload)
    assert not out["correct"], out["checks"]
    gaps = {k: v for k, v in out["checks"].items() if k.endswith("_logit_gap")}
    assert gaps and any(v["value"] > v["limit"] for v in gaps.values()), gaps
