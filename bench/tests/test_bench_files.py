"""The harness is driven by data: a cell, a mix, a configuration or a
per-layer metric is found by its name, and ``BENCHMARK.json`` keeps to
its contract."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_cell_made_only_of_new_files_is_found_by_name(tmp_path, root, bench):
    new = tmp_path
    shutil.copytree(root / "bench", new / "bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    b = json.loads(json.dumps(bench))
    b["configs"].append({"name": "tiny", "source": "test", "file": "bench/configs/tiny.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny-cell", "config": "tiny", "traffic": "tiny_mix",
                           "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "new_metric.x", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "engine",
                           "moves": "output_tok_s", "workloads": ["tiny-cell"]})
    (new / "bench/configs/tiny.json").write_text(json.dumps({"name": "tiny"}))
    (new / "bench/traffic/tiny_mix.json").write_text(json.dumps({"driver": "offline",
                                                                 "clients": 3}))
    (new / "bench/cells/tiny-cell.json").write_text(json.dumps({"max_logit_gap": 0.5}))
    (new / "bench/metrics/new_metric.x.py").write_text(
        "def read(rec, cfg):\n    return 2.0 * len(rec.data['steps'])\n")
    w, cfgj, traffic, limits = harness.find_cell(new, b, "tiny-cell")
    assert (w["traffic"], cfgj["name"], traffic["clients"], limits["max_logit_gap"]) == (
        "tiny_mix", "tiny", 3, 0.5)
    rec = harness.Record(e2e={}, setup_s=1.0, attempted=0, failed=0, window_s=1.0,
                         samples=[], data={"steps": [(0, 1), (1, 2)]})
    assert harness.reader(new, "new_metric.x")(rec, cfgj) == 4.0
    assert harness.driver(traffic["driver"]).run is not None
    with pytest.raises(KeyError):
        harness.find_cell(new, b, "no-such-cell")


def test_benchmark_json_keeps_to_its_contract(root, bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench"] and bench["command"] == ["python3", "bench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((root / c["file"]).read_text())
        assert c["file"].startswith("bench/") and cfg["name"] == c["name"]
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in bench["workloads"])
        harness.model_config(harness.as_run(cfg))       # every width is the port's
    cells = [w["name"] for w in bench["workloads"]]
    assert len(set(cells)) == len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        traffic = json.loads((root / f"bench/traffic/{w['traffic']}.json").read_text())
        assert (root / f"bench/drivers/{traffic['driver']}.py").exists()
        assert (root / f"bench/cells/{w['name']}.json").exists()
    metrics = bench["end_to_end"] + bench["per_layer"]
    mnames = [m["name"] for m in metrics]
    assert len(set(mnames)) == len(mnames)
    assert "setup_s" in mnames
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells) if "workloads" in m else True
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert (root / f"bench/metrics/{m['name']}.py").exists()
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
    for c in cells:      # every cell: setup_s, another end-to-end metric, a per-layer one
        assert sum(c in m.get("workloads", cells) for m in bench["end_to_end"]) >= 2
        assert any(c in m["workloads"] for m in bench["per_layer"])
