"""The port stands alone: it imports neither JAX nor the JAX package."""

import pytest

torch = pytest.importorskip("torch")

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
# modules of every subpackage, the scheduler core, simulator and launcher included
REQUIRED = (
    "core/scheduler.py", "core/profiler.py", "core/baselines.py",
    "sim/simulator.py", "sim/workloads.py", "launch/serve.py",
    "models/zoo.py", "serving/cluster.py", "kernels/flash_attention.py",
    "kernels/decode_attention.py", "kernels/ssm_scan.py", "models/ssm.py",
    "models/moe.py", "configs/jamba_1_5_large_398b.py",
    # the sharding layer and the multi-rank paths
    "distributed/sharding.py", "distributed/compression.py", "launch/mesh.py",
    # the dry run and the roofline model
    "launch/dryrun.py", "launch/roofline_model.py",
)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_no_file_of_the_port_imports_jax_or_repro():
    files = _port_files()
    assert len(files) > 20 and (REPO / "chip_smoke.py").exists()
    assert {PORT / r for r in REQUIRED} <= set(files)
    bad = [
        f"{path.relative_to(REPO)}:{line} imports {root}"
        for path in files
        for line, root in _imported_roots(path)
        if root in FORBIDDEN
    ]
    assert bad == []


def test_importing_every_module_leaves_jax_and_repro_out():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name != "__init__.py"
    )
    for r in REQUIRED:
        assert "repro_torch." + r[:-3].replace("/", ".") in modules
    code = (
        "import importlib, sys\n"
        "import repro_torch\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
