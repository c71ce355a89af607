"""Pluggable static-analysis framework (stdlib-only; runs offline).

Copy of ``repro/analysis/framework.py``: the same classes, rule
registry and suppression syntax.

The repository's correctness story rests on *determinism*: golden-hash
tests pin seeded scheduler trajectories, and the differential serving
suites prove token-for-token equality across engine features.  Those
tests detect drift but cannot localize it — this framework hosts AST
passes that flag the drift *sources* (wall clocks, unseeded RNGs,
unordered set iteration, mutable default arguments) before they ever
reach a golden hash.

Design:

- a :class:`Checker` declares the rule ids it can emit and implements
  ``check(src)`` over a parsed :class:`Source`;
- checkers self-register via :func:`register`, so adding a pass is one
  decorated class (see ``determinism.py`` / ``seeds.py``);
- findings are suppressed per line with ``# analysis: ignore[rule]``
  (or a bare ``# analysis: ignore`` for every rule on that line) — the
  suppression lives next to the code it excuses, greppable and
  reviewable;
- :func:`run_paths` walks files/directories and returns unsuppressed
  :class:`Finding` objects; ``tools/run_analysis_torch.py`` is the CLI.

Everything here is importable without numpy or torch, so the lint needs
no dependency install.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Type


@dataclass(frozen=True)
class Finding:
    """One rule violation at a specific source location.

    Attributes
    ----------
    path : str
        File the violation was found in.
    line : int
        1-based line number (the AST node's ``lineno``).
    rule : str
        Rule identifier (kebab-case; see ``--list-rules``).
    message : str
        Human-readable description with enough context to act on.
    """

    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


_SUPPRESS_RE = re.compile(
    r"#\s*analysis:\s*ignore(?:\[([A-Za-z0-9_,\- ]*)\])?"
)


class Source:
    """A parsed Python file plus its per-line suppression table."""

    def __init__(self, path: str, text: str) -> None:
        self.path = str(path)
        self.text = text
        self.tree = ast.parse(text, filename=self.path)
        # line -> set of suppressed rule ids ("*" suppresses every rule)
        self.suppressions: Dict[int, Set[str]] = {}
        for lineno, line in enumerate(text.splitlines(), start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = m.group(1)
            if rules is None or not rules.strip():
                self.suppressions[lineno] = {"*"}
            else:
                self.suppressions[lineno] = {
                    r.strip() for r in rules.split(",") if r.strip()
                }

    def suppressed(self, line: int, rule: str) -> bool:
        """Check whether ``rule`` is suppressed on ``line``."""
        sup = self.suppressions.get(line)
        return sup is not None and ("*" in sup or rule in sup)


class Checker:
    """Base class of one analysis pass.

    Subclasses set :attr:`rules` (``{rule_id: one-line description}``)
    and implement :meth:`check`.  Register with :func:`register` so
    :func:`run_paths` picks the pass up automatically.
    """

    #: rule id -> one-line description (the ``--list-rules`` catalog)
    rules: Dict[str, str] = {}

    def check(self, src: Source) -> List[Finding]:
        """Return every (pre-suppression) finding in ``src``."""
        raise NotImplementedError

    def finding(self, src: Source, node: ast.AST, rule: str, msg: str) -> Finding:
        """Build a :class:`Finding` anchored at ``node``."""
        assert rule in self.rules, f"checker emits undeclared rule {rule!r}"
        return Finding(src.path, getattr(node, "lineno", 0), rule, msg)


_REGISTRY: List[Type[Checker]] = []


def register(cls: Type[Checker]) -> Type[Checker]:
    """Class decorator adding a checker to the global registry."""
    _REGISTRY.append(cls)
    return cls


def all_checkers(rules: Optional[Set[str]] = None) -> List[Checker]:
    """Instantiate registered checkers, optionally restricted to rules.

    Parameters
    ----------
    rules : set of str, optional
        When given, only checkers emitting at least one of these rule
        ids are instantiated (rule-level filtering of their findings
        happens in :func:`run_paths`).

    Returns
    -------
    list of Checker
        One instance per selected registered class.
    """
    out = []
    for cls in _REGISTRY:
        if rules is None or rules & set(cls.rules):
            out.append(cls())
    return out


def rule_catalog() -> Dict[str, str]:
    """Return ``{rule_id: description}`` over every registered checker."""
    cat: Dict[str, str] = {}
    for cls in _REGISTRY:
        cat.update(cls.rules)
    return cat


def iter_py_files(paths: Sequence[str]) -> Iterator[Path]:
    """Yield ``.py`` files under the given files/directories, sorted."""
    for p in paths:
        path = Path(p)
        if path.is_dir():
            yield from sorted(path.rglob("*.py"))
        elif path.suffix == ".py":
            yield path


def check_source(
    src: Source,
    checkers: Iterable[Checker],
    rules: Optional[Set[str]] = None,
) -> List[Finding]:
    """Run checkers over one parsed source, applying suppressions."""
    out: List[Finding] = []
    for checker in checkers:
        for f in checker.check(src):
            if rules is not None and f.rule not in rules:
                continue
            if not src.suppressed(f.line, f.rule):
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def run_paths(
    paths: Sequence[str],
    rules: Optional[Set[str]] = None,
) -> List[Finding]:
    """Analyze every Python file under ``paths``.

    Parameters
    ----------
    paths : sequence of str
        Files and/or directories.
    rules : set of str, optional
        Restrict to these rule ids (default: every registered rule).

    Returns
    -------
    list of Finding
        Unsuppressed findings, sorted by (path, line, rule).
    """
    checkers = all_checkers(rules)
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        text = path.read_text()
        try:
            src = Source(str(path), text)
        except SyntaxError as e:  # report instead of crashing the sweep
            findings.append(
                Finding(str(path), e.lineno or 0, "parse-error", str(e.msg))
            )
            continue
        findings.extend(check_source(src, checkers, rules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
