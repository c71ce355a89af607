"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from bench import harness


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(root: Path):
    return [p for p in (root / "bench").rglob("*.py")
            if "tests" not in p.parts and "out" not in p.parts]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package(root):
    bad = [(p.name, m) for p in _sources(root) for m in _imports(p)
           if m.split(".")[0] in harness.FORBIDDEN]
    assert bad == []


def test_the_reference_imports_nothing_of_the_program(root):
    ref = list((root / "bench" / "reference").rglob("*.py")) + [root / "bench" / "judge.py"]
    bad = [(p.name, m) for p in ref for m in _imports(p) if m.split(".")[0] == "repro_torch"]
    assert bad == []


def test_top_level_names_are_compared_whole():
    assert harness.forbidden_loaded(["repro_torch", "repro_torch.models", "jaxtyping",
                                     "reproducible"]) == []
    assert harness.forbidden_loaded(["repro.core", "jax", "jaxlib.xla", "flax.nn"]) == [
        "flax.nn", "jax", "jaxlib.xla", "repro.core"]


def test_a_run_loads_no_module_of_jax(root):
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(root / 'bench' / 'tests')!r}]\n"
        "from conftest import smoke_run\n"
        "from bench import harness\n"
        f"b = harness.load_json(__import__('pathlib').Path({str(root)!r}) / 'BENCHMARK.json')\n"
        "smoke_run(b, 'stablelm-code-batch64', seconds=1.0)\n"
        "print(json.dumps(harness.forbidden_loaded(list(sys.modules))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
