"""Performance lint: AST passes flagging hot-path slowdowns.

One rule so far:

- ``hot-loop-import`` — an ``import`` statement lexically inside a
  ``for``/``while`` loop body, or anywhere inside a function named
  ``step``/``_step`` (the serving engines' per-iteration entry points).
  ``import`` is not free even when the module is cached: every
  execution takes the import lock and does a ``sys.modules`` dict
  round-trip, and the first execution can hide a multi-second JAX
  import inside what profiles as "one engine step".  The paged engine
  shipped exactly this bug — a ``from ..kernels.paged_attention
  import ...`` inside ``PagedLLMEngine.step()`` paid the lookup on
  every sanitized iteration.  Hoist the import to module level (or to
  function scope *outside* the loop when breaking an import cycle —
  with a suppression explaining why).

Intentional lazy imports at function top level (e.g. keeping torch out of
the dependency-free lint) are not flagged — only loops and the
``step`` hot path are.
"""

from __future__ import annotations

import ast
from typing import List

from .framework import Checker, Finding, Source, register


def _describe(node: ast.AST) -> str:
    """Render an import statement back to (approximate) source."""
    if isinstance(node, ast.Import):
        return "import " + ", ".join(a.name for a in node.names)
    assert isinstance(node, ast.ImportFrom)
    mod = "." * node.level + (node.module or "")
    return f"from {mod} import " + ", ".join(a.name for a in node.names)


class _HotImportVisitor(ast.NodeVisitor):
    """Track loop / hot-function nesting while collecting imports."""

    _HOT_FUNCS = {"step", "_step"}

    def __init__(self, checker: "HotLoopImportChecker", src: Source) -> None:
        self._checker = checker
        self._src = src
        self._in_loop = False
        self._in_hot = False
        self.findings: List[Finding] = []

    def _flag(self, node: ast.AST, why: str) -> None:
        self.findings.append(self._checker.finding(
            self._src, node, "hot-loop-import",
            f"`{_describe(node)}` {why}; hoist it to module level",
        ))

    def visit_Import(self, node: ast.Import) -> None:
        if self._in_loop:
            self._flag(node, "runs on every loop iteration")
        elif self._in_hot:
            self._flag(node, "inside a step() hot path runs once per "
                             "engine iteration")

    visit_ImportFrom = visit_Import

    def _visit_loop(self, node: ast.AST) -> None:
        was = self._in_loop
        self._in_loop = True
        self.generic_visit(node)
        self._in_loop = was

    visit_For = visit_AsyncFor = visit_While = _visit_loop

    def _visit_func(self, node: ast.AST) -> None:
        # a nested def's body runs when *called*, not per enclosing
        # iteration — reset loop context; but any def inside step()
        # stays hot (closures there are invoked per step)
        was_loop, was_hot = self._in_loop, self._in_hot
        self._in_loop = False
        self._in_hot = was_hot or node.name in self._HOT_FUNCS
        self.generic_visit(node)
        self._in_loop, self._in_hot = was_loop, was_hot

    visit_FunctionDef = visit_AsyncFunctionDef = _visit_func


@register
class HotLoopImportChecker(Checker):
    """Flag import statements executed once per loop iteration/step."""

    rules = {
        "hot-loop-import": (
            "import inside a loop body or a step() hot path re-runs the "
            "sys.modules lookup every iteration; hoist to module level"
        ),
    }

    def check(self, src: Source) -> List[Finding]:
        """Return one finding per hot-path import in ``src``."""
        visitor = _HotImportVisitor(self, src)
        visitor.visit(src.tree)
        return visitor.findings
