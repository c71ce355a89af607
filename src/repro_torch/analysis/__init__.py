"""Runtime checkers of the port (the KV-page sanitizer)."""

from .kvsan import KVSanError, KVSanitizer

__all__ = ["KVSanError", "KVSanitizer"]
