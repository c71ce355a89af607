"""Static analysis and runtime checkers of the port.

Copy of ``repro/analysis/__init__.py``'s layout, three layers in one
package:

- **determinism lint** (:mod:`.framework`, :mod:`.determinism`,
  :mod:`.seeds`, :mod:`.perf`): stdlib-only AST passes run by
  ``tools/run_analysis_torch.py``;
- **kvsan** (:mod:`.kvsan`): the KV-page shadow-state sanitizer behind
  ``PageAllocator(sanitize=True)``;
- **scheduler invariants** (:mod:`.invariants`): Decision-level checks
  behind ``LLMSched(check_invariants=True)``.

The lint layer imports eagerly (it needs neither numpy nor torch).  The
runtime layers are exposed lazily (PEP 562), so ``import
repro_torch.analysis`` never drags in the serving or scheduler stacks.
"""

from .framework import (  # noqa: F401
    Checker,
    Finding,
    Source,
    all_checkers,
    check_source,
    iter_py_files,
    register,
    rule_catalog,
    run_paths,
)
from . import determinism as _determinism  # noqa: F401  (registers checkers)
from . import perf as _perf  # noqa: F401  (registers checkers)
from . import seeds as _seeds  # noqa: F401  (registers checkers)

_LAZY = {
    "KVSanError": "kvsan",
    "KVSanitizer": "kvsan",
    "InvariantViolation": "invariants",
    "check_decision": "invariants",
    "INVARIANTS": "invariants",
}


def __getattr__(name):
    """Resolve runtime-layer symbols on first access (PEP 562)."""
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)


__all__ = [
    "Checker",
    "Finding",
    "Source",
    "all_checkers",
    "check_source",
    "iter_py_files",
    "register",
    "rule_catalog",
    "run_paths",
    "KVSanError",
    "KVSanitizer",
    "InvariantViolation",
    "check_decision",
    "INVARIANTS",
]
