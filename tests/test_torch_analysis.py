"""The port's determinism and seed lint against the JAX package's.

- the port's checkers and JAX's give the same findings on every ``.py``
  file of ``src benchmarks examples tests tools``, and on a snippet of
  each shared rule, once JAX's ``key``/``PRNGKey`` findings and the
  port's torch-only findings (a torch draw without ``generator=``, an
  OS-seeded ``.seed()``) are taken out;
- a snippet a rule, each flagged and each suppressed by
  ``# analysis: ignore[rule]``; the torch draws that carry a generator
  (or a ``**kw`` splat) are not flagged;
- ``tools/run_analysis_torch.py`` sweeps the repo plus ``chip_smoke.py``
  clean and lists JAX's rule catalog;
- ``import repro_torch.analysis`` needs neither numpy nor torch, and
  exposes the runtime checkers lazily.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis as jlint
import repro_torch.analysis as lint

REPO = Path(__file__).resolve().parents[1]
SWEEP = ("src", "benchmarks", "examples", "tests", "tools")


def _key(findings):
    return sorted((str(f.path), f.line, f.rule) for f in findings)


def _jax_shared(findings):
    """JAX's findings without its ``jax.random.key()`` / ``PRNGKey()`` rule."""
    return [f for f in findings
            if not (f.rule == "unseeded-rng" and ("key(" in f.message or "PRNGKey" in f.message))]


def _torch_only(f) -> bool:
    return f.rule in ("global-rng", "unseeded-rng") and (
        f.message.startswith("torch draw") or "seeds from the OS" in f.message)


def _port_shared(findings):
    return [f for f in findings if not _torch_only(f)]


def _check(text: str, checkers, name="snippet.py"):
    return lint.check_source(lint.Source(name, textwrap.dedent(text)), checkers)


def _port(text: str):
    return _check(text, lint.all_checkers())


def _jax(text: str):
    return jlint.check_source(jlint.Source("snippet.py", textwrap.dedent(text)),
                              jlint.all_checkers())


# one snippet a rule: (rule, the flagged line, torch-only)
SNIPPETS = [
    ("wall-clock", "import time\nt = time.time()\n", False),
    ("wall-clock", "import datetime\nt = datetime.datetime.now()\n", False),
    ("unordered-set", "for x in {1, 2, 3}:\n    print(x)\n", False),
    ("mutable-default", "def f(a=[]):\n    return a\n", False),
    ("hot-loop-import", "for i in range(3):\n    import os\n", False),
    ("hot-loop-import", "def step(self):\n    import os\n", False),
    ("seed-missing", "wl = generate_workload('mixed', 10, 0.5)\n", False),
    ("seed-missing", "g = DeterministicGate(0.5)\n", False),
    ("unseeded-rng", "import numpy as np\nrng = np.random.default_rng()\n", False),
    ("unseeded-rng", "from numpy.random import default_rng\nrng = default_rng()\n", False),
    ("unseeded-rng", "import torch\ntorch.seed()\n", True),
    ("unseeded-rng", "import torch\ntorch.cuda.seed()\n", True),
    ("unseeded-rng", "import torch\ng = torch.Generator()\ng.seed()\n", True),
    ("global-rng", "import numpy as np\nx = np.random.rand(3)\n", False),
    ("global-rng", "import random\nx = random.random()\n", False),
    ("global-rng", "import torch\nx = torch.randn(3, 4)\n", True),
    ("global-rng", "import torch\nx = torch.randint(0, 9, (3,))\n", True),
    ("global-rng", "import torch\nx = torch.randperm(8)\n", True),
    ("global-rng", "import torch\nx = torch.rand_like(y)\n", True),
    ("global-rng", "import torch\nx = torch.multinomial(p, 2)\n", True),
    ("global-rng", "import torch\nx = torch.bernoulli(p)\n", True),
    ("global-rng", "x = y.normal_(0.0, 1.0)\n", True),
    ("global-rng", "x = y.uniform_()\n", True),
    ("global-rng", "x = y.random_(0, 9)\n", True),
    ("global-rng", "import torch\ntorch.nn.init.normal_(w)\n", True),
    ("global-rng", "from torch.nn import init\ninit.kaiming_uniform_(w)\n", True),
]


@pytest.mark.parametrize("rule,text,torch_only", SNIPPETS)
def test_each_rule_is_flagged_and_suppressed(rule, text, torch_only):
    got = _port(text)
    assert [f.rule for f in got] == [rule], got
    line = got[0].line
    lines = textwrap.dedent(text).splitlines()
    lines[line - 1] += f"  # analysis: ignore[{rule}]"
    assert _port("\n".join(lines) + "\n") == []
    assert _torch_only(got[0]) == torch_only
    # JAX's checkers agree on every shared rule, and see no torch draw
    assert _key(_jax(text)) == ([] if torch_only else _key(got))


@pytest.mark.parametrize("text", [
    "import torch\ng = torch.Generator().manual_seed(0)\nx = torch.randn(3, generator=g)\n",
    "import torch\nx = torch.rand(3, **kw)\n",
    "x = y.normal_(0.0, 1.0, generator=g)\n",
    "import torch\ntorch.nn.init.normal_(w, generator=g)\n",
    "import torch\ntorch.manual_seed(0)\n",
    "import numpy as np\nrng = np.random.default_rng(0)\nx = rng.normal(size=3)\n",
    "import random\nr = random.Random(0)\nr.seed(1)\n",
    "import torch\nx = torch.zeros(3).normal(0.0)\n",
])
def test_seeded_draws_are_not_flagged(text):
    assert _port(text) == []


def test_parse_error_is_reported(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(:\n")
    got = lint.run_paths([str(bad)])
    assert [f.rule for f in got] == ["parse-error"]
    assert _key(got) == _key(jlint.run_paths([str(bad)]))


def test_rule_catalog_is_jaxs():
    assert lint.rule_catalog() == jlint.rule_catalog()


def test_checkers_agree_with_jax_on_every_file():
    paths = [str(REPO / d) for d in SWEEP]
    files = list(lint.iter_py_files(paths))
    assert len(files) > 150
    port, jax_ = lint.run_paths(paths), jlint.run_paths(paths)
    assert _key(_port_shared(port)) == _key(_jax_shared(jax_))


def test_checkers_agree_with_jax_on_unsuppressed_snippets(tmp_path):
    """Every shared snippet written out as files and swept by both."""
    for i, (_, text, torch_only) in enumerate(SNIPPETS):
        (tmp_path / f"s{i:02d}.py").write_text(textwrap.dedent(text))
    port, jax_ = lint.run_paths([str(tmp_path)]), jlint.run_paths([str(tmp_path)])
    assert _key(_port_shared(port)) == _key(_jax_shared(jax_))
    assert len(_port_shared(port)) == sum(not t for *_, t in SNIPPETS)
    assert len(port) == len(SNIPPETS)


def _cli(*args):
    return subprocess.run([sys.executable, str(REPO / "tools" / "run_analysis_torch.py"), *args],
                          capture_output=True, text=True, timeout=120, cwd=str(REPO))


def test_the_port_sweeps_the_repo_and_chip_smoke_clean():
    proc = _cli()
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert proc.stdout.startswith("analysis clean: 0 findings")
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import run_analysis_torch
    finally:
        sys.path.remove(str(REPO / "tools"))
    assert {"tools", "chip_smoke.py"} <= set(run_analysis_torch.DEFAULT_PATHS)


def test_cli_lists_rules_and_fails_on_a_finding(tmp_path):
    listed = _cli("--list-rules")
    assert listed.returncode == 0
    assert [ln.split()[0] for ln in listed.stdout.splitlines()] == sorted(lint.rule_catalog())
    bad = tmp_path / "draw.py"
    bad.write_text("import torch\nx = torch.randn(3)\n")
    proc = _cli(str(bad))
    assert proc.returncode == 1 and "[global-rng]" in proc.stdout
    assert _cli(str(bad), "--rules", "wall-clock").returncode == 0


def test_import_needs_neither_numpy_nor_torch_and_runtime_layers_are_lazy():
    code = textwrap.dedent("""
        import sys
        sys.modules["numpy"] = None
        sys.modules["torch"] = None
        import repro_torch.analysis as a
        assert a.run_paths and a.rule_catalog()
        assert "repro_torch.analysis.kvsan" not in sys.modules
        assert "repro_torch.analysis.invariants" not in sys.modules
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=60, env=env)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
    from repro_torch.analysis.invariants import InvariantViolation
    from repro_torch.analysis.kvsan import KVSanitizer

    assert lint.KVSanitizer is KVSanitizer and lint.InvariantViolation is InvariantViolation
    with pytest.raises(AttributeError):
        lint.does_not_exist
