"""Plain float32 references of the configurations (no code of the port).

Each module gives ``hidden(w, cfg, tokens, mode)``: the final-norm hidden
states of a full causal forward over ``tokens`` from position 0, and
``head(w, cfg, h, mode)``: the logits.  ``cfg`` is the configuration
file's dict (its published keys), ``w`` the weight tree the benchmark
made.  ``mode`` is ``"f32"`` (the reference) or ``"fp8"`` (the control:
every matrix product in float8 e4m3, the step below bf16).
"""

from importlib import import_module


def module(kind: str):
    """The reference module named by a configuration's ``reference`` key."""
    return import_module(f"bench.reference.{kind}")
