"""Runtime checkers of the port: the KV-page sanitizer and the scheduler's
invariant catalog."""

from .invariants import INVARIANTS, InvariantViolation, check_decision
from .kvsan import KVSanError, KVSanitizer

__all__ = ["INVARIANTS", "InvariantViolation", "KVSanError", "KVSanitizer",
           "check_decision"]
