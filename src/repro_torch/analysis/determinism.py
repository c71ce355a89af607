"""Determinism lint: AST passes flagging nondeterminism sources.

Copy of ``repro/analysis/determinism.py``, rules unchanged.

The sim/scheduler/serving paths must be seed-reproducible — every golden
trajectory hash and differential token-equality test assumes it.  These
rules flag the constructs that historically break that assumption:

- ``wall-clock`` — ``time.time()`` / ``datetime.now()`` and friends.
  ``time.time()`` is non-monotonic (NTP slews it backwards), so even
  *duration* measurements must use ``time.perf_counter()``; wall-clock
  timestamps that genuinely need calendar time carry a suppression.
- ``unordered-set`` — iterating a freshly-built ``set`` (literal,
  ``set(...)``/``frozenset(...)`` call, or set comprehension) in an
  order-sensitive position (``for``, comprehension, ``list``/``tuple``/
  ``enumerate``/``iter``).  Set iteration order depends on insertion
  history and hash seeding; wrap in ``sorted(...)`` to fix the order.
- ``mutable-default`` — mutable default argument values (``[]``,
  ``{}``, ``set()``, …) shared across calls: state leaks between
  invocations and, with it, run-order dependence.

Only syntactically-evident cases are flagged (no type inference): the
lint is meant to stay zero-noise so the repo can be kept suppress-free.
"""

from __future__ import annotations

import ast
from typing import List

from .framework import Checker, Finding, Source, register


def _attr_chain(node: ast.AST) -> List[str]:
    """Flatten ``a.b.c`` into ``["a", "b", "c"]`` (empty if not a chain)."""
    out: List[str] = []
    while isinstance(node, ast.Attribute):
        out.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        out.append(node.id)
        return list(reversed(out))
    return []


@register
class WallClockChecker(Checker):
    """Flag non-monotonic wall-clock reads."""

    rules = {
        "wall-clock": (
            "time.time()/datetime.now() is non-monotonic and "
            "run-dependent; use time.perf_counter() for durations"
        ),
    }

    #: ``datetime``-style constructors that read the wall clock
    _DT_ATTRS = {"now", "utcnow", "today"}

    def check(self, src: Source) -> List[Finding]:
        """Return one finding per wall-clock call in ``src``."""
        out: List[Finding] = []
        # names bound by `from time import time` count as bare calls
        bare_time = False
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                bare_time |= any(a.name == "time" for a in node.names)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name):
                if bare_time and node.func.id == "time":
                    out.append(self.finding(
                        src, node, "wall-clock",
                        "time() (from time import time) is non-monotonic; "
                        "use time.perf_counter()",
                    ))
                continue
            chain = _attr_chain(node.func)
            if not chain:
                continue
            if len(chain) >= 2 and chain[-1] == "time" and chain[-2] == "time":
                out.append(self.finding(
                    src, node, "wall-clock",
                    "time.time() is non-monotonic; use time.perf_counter() "
                    "for durations (suppress if calendar time is required)",
                ))
            elif chain[-1] in self._DT_ATTRS and any(
                c in ("datetime", "date") for c in chain[:-1]
            ):
                out.append(self.finding(
                    src, node, "wall-clock",
                    f"datetime wall-clock read .{chain[-1]}() makes runs "
                    "time-dependent; thread an explicit timestamp instead",
                ))
        return out


def _is_set_expr(node: ast.AST) -> bool:
    """True for expressions that are syntactically guaranteed sets."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False


@register
class UnorderedSetChecker(Checker):
    """Flag iteration over freshly-built sets in ordering positions."""

    rules = {
        "unordered-set": (
            "iterating a set feeds hash-order into downstream decisions; "
            "wrap in sorted(...) with an explicit key"
        ),
    }

    #: calls whose output order mirrors the iterable's order
    _ORDER_SINKS = {"list", "tuple", "enumerate", "iter"}

    def check(self, src: Source) -> List[Finding]:
        """Return one finding per order-sensitive set iteration."""
        out: List[Finding] = []
        msg = (
            "set iteration order is nondeterministic across runs; "
            "use sorted(...) before iterating"
        )
        for node in ast.walk(src.tree):
            if isinstance(node, ast.For) and _is_set_expr(node.iter):
                out.append(self.finding(src, node.iter, "unordered-set", msg))
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp)):
                for comp in node.generators:
                    if _is_set_expr(comp.iter):
                        out.append(self.finding(
                            src, comp.iter, "unordered-set", msg
                        ))
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in self._ORDER_SINKS
                and node.args
                and _is_set_expr(node.args[0])
            ):
                out.append(self.finding(
                    src, node, "unordered-set",
                    f"{node.func.id}(set(...)) materializes hash order; "
                    "use sorted(...) instead",
                ))
        return out


@register
class MutableDefaultChecker(Checker):
    """Flag mutable default argument values."""

    rules = {
        "mutable-default": (
            "mutable default argument is shared across calls; "
            "default to None and construct inside the function"
        ),
    }

    _MUTABLE_CTORS = {"list", "dict", "set", "bytearray", "deque"}

    def _is_mutable(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            return node.func.id in self._MUTABLE_CTORS
        return False

    def check(self, src: Source) -> List[Finding]:
        """Return one finding per mutable default in any function def."""
        out: List[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None
            ]
            for d in defaults:
                if self._is_mutable(d):
                    out.append(self.finding(
                        src, d, "mutable-default",
                        f"mutable default in {node.name}(...) is shared "
                        "across calls; use None and build per-call",
                    ))
        return out
