"""Seeded weights of a configuration, made on the device in bulk.

The tree has the layout the port's step functions read
(``repro_torch.models.zoo.param_shapes``: ``embedding``, ``lm_head``,
``final_norm``, unstacked ``prefix_{i}`` layers and ``blocks[j]`` stacked
over superblocks).  The values are the benchmark's own: one
``torch.Generator`` on the device seeded with ``--seed``, one ``randn``
call a leaf, drawn directly in the served dtype (no float32 temporary),
scaled by ``1/sqrt(fan_in)``, where ``fan_in`` is the input width of the
matrix (the second-last axis; the embedding's row width), and RMSNorm
gains of one.  The same tensors are handed to the program and to the
reference, which reads them without any of the program's code.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import torch

Tree = Dict[str, Any]


def _leaves(tree: Tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _is_norm(path: Tuple[str, ...]) -> bool:
    return path[-1].startswith("norm") or path[0] == "final_norm" or path[-1] == "g"


def fan_in(path: Tuple[str, ...], shape: Tuple[int, ...]) -> int:
    """Input width of a weight matrix: the row width of the embedding
    table, the second-last axis of every other matrix."""
    return shape[-1] if path[-1] == "embedding" else shape[-2]


def make(layout: Tree, seed: int, dtype: torch.dtype, device) -> Tree:
    """Weights in the shapes of ``layout`` (a tree of ``meta`` tensors).

    Parameters
    ----------
    layout : dict
        The parameter tree with the shapes to fill (only ``.shape`` is read).
    seed : int
        Seed of the generator; any non-negative integer below 2**64.
    dtype : torch.dtype
        The served dtype.
    device : torch.device or str
        Where the weights are drawn and kept.

    Returns
    -------
    dict
        A tree of the same structure holding the drawn tensors.
    """
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 64))
    out: Tree = {}
    for path, meta in _leaves(layout):
        shape = tuple(meta.shape)
        if _is_norm(path):
            t = torch.ones(shape, dtype=dtype, device=dev)
        else:
            t = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
            t.mul_(1.0 / math.sqrt(fan_in(path, shape)))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def nbytes(tree: Tree) -> int:
    """Bytes held by every leaf of ``tree``."""
    return sum(t.numel() * t.element_size() for _, t in _leaves(tree))
