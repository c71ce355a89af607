"""Seed-discipline checker.

Copy of ``repro/analysis/seeds.py`` with the RNG rules stated in
PyTorch's idiom in place of ``jax.random.key()`` / ``PRNGKey()``.

Every benchmark, test, and example must thread an **explicit seed** into
each randomness source it touches, so artifacts are reproducible and two
modes of one comparison (cache off/on, migration off/on) see the same
trace.  Three rules:

- ``seed-missing`` — a workload/trace generator, ``simulate``, or
  quality-gate (``DeterministicGate``) call without a ``seed=``
  keyword (or the corresponding positional);
- ``unseeded-rng`` — ``numpy.random.default_rng()`` called with no
  argument, or ``torch.seed()`` / ``torch.cuda.seed()`` / a generator's
  ``.seed()``, which seed from the OS (an OS-seeded RNG makes the run
  unreproducible);
- ``global-rng`` — module-level global-RNG use (``np.random.<dist>()``
  or stdlib ``random.<dist>()``), and a torch draw without
  ``generator=`` (``torch.randn(...)``, ``t.normal_()``,
  ``torch.nn.init.normal_(...)``): the global RNG's state is shared and
  unseedable per call site — use ``default_rng(seed)`` or a
  ``torch.Generator().manual_seed(seed)``.  A ``**kw`` splat counts as
  carrying ``generator=``, as it counts as carrying ``seed=``.
"""

from __future__ import annotations

import ast
from typing import List

from .determinism import _attr_chain
from .framework import Checker, Finding, Source, register


@register
class SeedDisciplineChecker(Checker):
    """Flag randomness sources that do not carry an explicit seed."""

    rules = {
        "seed-missing": (
            "workload/trace generator called without an explicit seed"
        ),
        "unseeded-rng": (
            "RNG constructor called without a seed argument"
        ),
        "global-rng": (
            "module-level global RNG use; construct default_rng(seed)"
        ),
    }

    #: calls that must carry an explicit seed argument
    SEED_KW_FUNCS = {
        "generate_workload", "generate_traces", "simulate",
        "generate_tiered_workload", "assign_slos", "DeterministicGate",
    }
    #: positional index at which the generators accept seed
    SEED_POS = {
        "generate_workload": 3,
        "generate_traces": 2,
        "generate_tiered_workload": 3,
        "assign_slos": 4,
        "DeterministicGate": 1,
    }
    #: module-level global-RNG attributes banned outright
    BANNED_NP_RANDOM = {
        "rand", "randn", "randint", "random", "choice", "shuffle",
        "permutation", "uniform", "normal", "exponential", "poisson",
    }
    #: stdlib ``random.<attr>()`` module-level calls banned outright
    BANNED_STD_RANDOM = {
        "random", "randint", "randrange", "choice", "choices", "shuffle",
        "sample", "uniform", "normalvariate", "gauss", "expovariate",
    }
    #: ``torch.<fn>(...)`` draws that must carry ``generator=``
    TORCH_DRAWS = {
        "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
        "randint_like", "normal", "bernoulli", "multinomial", "poisson",
    }
    #: in-place tensor draws ``t.<method>(...)`` that must carry ``generator=``
    TORCH_METHOD_DRAWS = {
        "normal_", "uniform_", "bernoulli_", "exponential_", "random_",
        "cauchy_", "log_normal_", "geometric_",
    }
    #: ``torch.nn.init.<fn>(...)`` draws that must carry ``generator=``
    TORCH_INIT_DRAWS = {
        "uniform_", "normal_", "trunc_normal_", "xavier_uniform_",
        "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
        "orthogonal_", "sparse_",
    }

    @staticmethod
    def _call_name(node: ast.Call) -> str:
        fn = node.func
        if isinstance(fn, ast.Name):
            return fn.id
        if isinstance(fn, ast.Attribute):
            return fn.attr
        return ""

    def _torch_draw(self, node: ast.Call, chain: List[str]) -> str:
        """The draw's dotted name where ``node`` is a torch draw from the
        global generator, else ``""``."""
        kwargs = {kw.arg for kw in node.keywords}
        if "generator" in kwargs or None in kwargs:   # None: **kw splat
            return ""
        name = node.func.attr
        dotted = ".".join(chain) or f"<expr>.{name}"
        if chain[:1] == ["torch"] and len(chain) == 2 and name in self.TORCH_DRAWS:
            return dotted
        if "init" in chain[:-1] and name in self.TORCH_INIT_DRAWS:
            return dotted
        if name in self.TORCH_METHOD_DRAWS:
            return dotted
        return ""

    def check(self, src: Source) -> List[Finding]:
        """Return every seed-discipline violation in ``src``."""
        out: List[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = self._call_name(node)
            kwargs = {kw.arg for kw in node.keywords}
            if name in self.SEED_KW_FUNCS:
                has_kw = "seed" in kwargs or None in kwargs  # None: **kw splat
                has_pos = len(node.args) > self.SEED_POS.get(name, 99)
                if not (has_kw or has_pos):
                    out.append(self.finding(
                        src, node, "seed-missing",
                        f"{name}(...) without an explicit seed",
                    ))
            elif name == "default_rng":
                chain = _attr_chain(node.func)
                # attribute calls must come off a `random` module; a bare
                # name (``from numpy.random import default_rng``) counts too
                relevant = ("random" in chain
                            if isinstance(node.func, ast.Attribute) else True)
                if relevant and not node.args and not node.keywords:
                    out.append(self.finding(
                        src, node, "unseeded-rng",
                        f"{'.'.join(chain) or name}() without a seed",
                    ))
            elif isinstance(node.func, ast.Attribute):
                chain = _attr_chain(node.func)
                draw = self._torch_draw(node, chain)
                if name == "seed" and not node.args and not node.keywords:
                    out.append(self.finding(
                        src, node, "unseeded-rng",
                        f"{'.'.join(chain) or '<expr>.seed'}() seeds from the OS — "
                        "use manual_seed(seed) instead",
                    ))
                elif draw:
                    out.append(self.finding(
                        src, node, "global-rng",
                        f"torch draw {draw}() without generator= — pass a "
                        "torch.Generator().manual_seed(seed)",
                    ))
                elif (
                    len(chain) >= 3
                    and chain[0] in ("np", "numpy")
                    and chain[1] == "random"
                    and chain[2] in self.BANNED_NP_RANDOM
                ):
                    out.append(self.finding(
                        src, node, "global-rng",
                        f"global RNG {'.'.join(chain)}() — use "
                        "default_rng(seed) instead",
                    ))
                elif (
                    len(chain) == 2
                    and chain[0] == "random"
                    and chain[1] in self.BANNED_STD_RANDOM
                ):
                    out.append(self.finding(
                        src, node, "global-rng",
                        f"global RNG random.{chain[1]}() — use "
                        "random.Random(seed) instead",
                    ))
        return out
