"""The plain references against the port's CPU path, and the control
against the program at the smoke sizes."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench import harness, judge, weights
from bench.reference import module

SMOKES = ["stablelm-smoke.json", "deepseek-smoke.json"]


@pytest.mark.parametrize("name", SMOKES)
def test_reference_matches_the_port_forward_in_float32(root, name):
    from repro_torch.models import zoo
    from repro_torch.models.transformer import forward

    cfgj = json.loads((root / "bench/tests/data" / name).read_text())
    cfg = harness.model_config(cfgj).with_(dtype="float32")
    layout, _ = zoo.param_shapes(cfg)
    w = weights.make(layout, 2**40 + 3, torch.float32, "cpu")
    toks = torch.randint(1, cfg.vocab, (1, 57), generator=torch.Generator().manual_seed(5))
    want, _ = forward(w, cfg, toks)
    ref = module(cfgj["reference"])
    got = ref.head(w, cfgj, ref.hidden(w, cfgj, toks[0]))
    torch.testing.assert_close(got, want[0].float(), atol=2e-5, rtol=2e-5)


def test_configs_apply_their_departures_and_match_the_port(root):
    """Each configuration file holds the published keys; the port's
    departures replace them as run, and the widths are the port's."""
    for name in ("stablelm-1.6b", "deepseek-v2-lite-16b"):
        cfgj = json.loads((root / f"bench/configs/{name}.json").read_text())
        run = harness.as_run(cfgj)
        for key, dep in cfgj["departures"].items():
            assert run[key] == dep["runs"] and cfgj.get(key) != dep["runs"], key
        harness.model_config(run)
        with pytest.raises(ValueError):
            harness.model_config(dict(run, hidden_size=run["hidden_size"] * 2))


def test_weights_come_from_the_seed_alone(root):
    from repro_torch.models import zoo

    cfgj = json.loads((root / "bench/tests/data/deepseek-smoke.json").read_text())
    layout, _ = zoo.param_shapes(harness.model_config(cfgj))
    a = weights.make(layout, 2**35 + 1, torch.bfloat16, "cpu")
    b = weights.make(layout, 2**35 + 1, torch.bfloat16, "cpu")
    c = weights.make(layout, 2**35 + 2, torch.bfloat16, "cpu")
    leaves = lambda t: [x for _, x in weights._leaves(t)]
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not torch.equal(a["lm_head"], c["lm_head"])
    assert torch.equal(a["final_norm"], torch.ones_like(a["final_norm"]))


@pytest.mark.parametrize("workload", ["stablelm-agents-sysprompt", "stablelm-code-batch64"])
def test_control_separates_from_the_program_at_smoke_size(bench, workload):
    """The float8 control reads at least three times the program's widest
    gap on the same judged tokens (whether it fails the cell's limit is a
    question of the cell's own size: the ``gpu`` test below)."""
    from conftest import smoke_run

    got = {}

    def control(cell, rec):
        lim = cell.limits
        s = judge.draw(rec.samples, cell.seed, lim["judged_tokens"], lim["max_requests"])
        for name, stat in judge.STATISTICS.items():
            if name in lim:
                got[name] = (stat(judge.served_gaps(cell.params, cell.config, s, cell.device)),
                             stat(judge.control_gaps(cell.params, cell.config, s,
                                                     cell.device)))

    out, _, _ = smoke_run(bench, workload, after=control)
    assert out["correct"] and got
    assert all(control >= 3 * program for program, control in got.values()), got


def test_draw_keeps_the_longest_and_follows_the_seed():
    samples = [([1], [2] * n) for n in (5, 50, 7, 9, 11)]
    a = judge.draw(samples, 3, judged_tokens=60, max_requests=8)
    assert len(a[0][1]) == 50 and sum(len(s[1]) for s in a) >= 60
    assert a == judge.draw(samples, 3, judged_tokens=60, max_requests=8)
    assert len(judge.draw(samples, 3, judged_tokens=1000, max_requests=2)) == 2
    assert judge.draw([], 3, 10, 2) == []


@pytest.mark.gpu
def test_control_fails_at_the_cells_size_on_the_card(bench, root, cuda):
    """The float8 control at a cell's own size (stablelm-code-batch64,
    one seed, a short window) fails the limit the program passes."""
    from bench import harness as h

    got = {}

    def control(cell, rec):
        lim = cell.limits
        s = judge.draw(rec.samples, cell.seed, lim["judged_tokens"], lim["max_requests"])
        gaps = judge.control_gaps(cell.params, cell.config, s, cell.device)
        got.update({name: (float(stat(gaps)), lim[name])
                    for name, stat in judge.STATISTICS.items() if name in lim})

    out, _, _ = h.run_cell(root, bench, "stablelm-code-batch64", 2**31 + 99, 10.0, False,
                           cuda, after=control)
    assert out["correct"] and any(v > lim for v, lim in got.values()), got
