"""Checkpoint / restore in the JAX package's on-disk format.

Copy of ``repro/distributed/checkpoint.py`` for trees of tensors.  Format:
one directory per step —
    step_000100/
      manifest.json        # tree structure, shapes, dtypes, mesh, step
      arrays.npz           # flat leaf arrays, a0, a1, ... in leaf order

- Leaves are flattened in ``jax.tree.flatten``'s order: dict keys sorted,
  tuple, list and NamedTuple fields in order (an int8 optimizer state's
  ``QTensor(q, s)`` is two leaves), so a checkpoint written by one package
  restores in the other.
- bfloat16 leaves are stored as raw bits, as JAX stores them (the
  little-endian bytes as a ``uint8`` array, ``"dtype": "bfloat16"`` in the
  manifest).  They go through ``tensor.view(torch.int16)`` and numpy's
  16-bit integers, never through a numpy bfloat16 type, which needs a
  package this one does not import.
- An atomic rename publishes a step (crash-consistent: a stray ``.tmp_*``
  directory is ignored), and ``keep_last`` garbage-collects old steps.

Restore onto a sharded layout (``shardings=``) is not ported yet and
raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree) -> List[Any]:
    """Leaves in ``jax.tree.flatten``'s order; ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _flatten(x)]
    return [tree]


def _unflatten(like, leaves) -> Any:
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}  # the caller's key order
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(like)


def _describe(tree) -> str:
    """The tree's structure with ``*`` for each leaf (for the manifest)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return f"{type(tree).__name__}(" + ", ".join(_describe(x) for x in tree) + ")"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_describe(x) for x in tree) + ")"
    return "*"


def _to_host(leaf) -> Tuple[np.ndarray, str, List[int]]:
    """``(payload, dtype name, logical shape)`` of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        shape = list(t.shape)
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            return np.ascontiguousarray(bits).view(np.uint8), "bfloat16", shape
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        shape = list(arr.shape)
    return arr, str(arr.dtype), shape


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    tree: Any,
    keep_last: int = 3,
    mesh_desc: Optional[str] = None,
) -> str:
    base = pathlib.Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    leaves = _flatten(tree)
    arrays = {}
    meta = []
    for i, leaf in enumerate(leaves):
        arr, dtype, shape = _to_host(leaf)
        arrays[f"a{i}"] = arr
        meta.append({"shape": shape, "dtype": dtype})
    tmp = pathlib.Path(tempfile.mkdtemp(dir=base, prefix=".tmp_"))
    try:
        np.savez(tmp / "arrays.npz", **arrays)
        with open(tmp / "manifest.json", "w") as f:
            json.dump(
                {
                    "step": step,
                    "treedef": _describe(tree),
                    "n_leaves": len(leaves),
                    "leaves": meta,
                    "mesh": mesh_desc,
                },
                f,
            )
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    _gc(base, keep_last)
    return str(final)


def _gc(base: pathlib.Path, keep_last: int) -> None:
    steps = sorted(p for p in base.iterdir() if p.name.startswith("step_"))
    for p in steps[:-keep_last]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return None
    steps = sorted(
        int(p.name.split("_")[1])
        for p in base.iterdir()
        if p.name.startswith("step_") and (p / "manifest.json").exists()
    )
    return steps[-1] if steps else None


def _from_host(arr: np.ndarray, dtype: str, shape: List[int]) -> torch.Tensor:
    if dtype == "bfloat16":  # raw bits: uint8 bytes -> 16-bit integers -> bf16
        bits = np.ascontiguousarray(arr).view(np.uint16).reshape(shape)
        return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise TypeError(f"checkpoint: leaf stored as {arr.dtype}, manifest says {dtype}")
    return torch.from_numpy(np.array(arr).reshape(shape))


def restore_checkpoint(
    ckpt_dir: str,
    like: Any,
    step: Optional[int] = None,
    shardings: Optional[Any] = None,
) -> Tuple[Any, int]:
    """Restore into the structure of ``like``: each leaf keeps its stored
    dtype and goes to the device of ``like``'s leaf in its place (the CPU
    for a leaf that is not a tensor)."""
    if shardings is not None:
        raise NotImplementedError("restore onto a sharded layout is not ported yet")
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    data = np.load(d / "arrays.npz")
    leaves = _flatten(like)
    assert manifest["n_leaves"] == len(leaves), (
        f"checkpoint has {manifest['n_leaves']} leaves, target {len(leaves)}"
    )
    out_leaves = []
    for i, ref in enumerate(leaves):
        m = manifest["leaves"][i]
        t = _from_host(data[f"a{i}"], m["dtype"], m["shape"])
        dev = ref.device if isinstance(ref, torch.Tensor) else torch.device("cpu")
        out_leaves.append(t.to(dev))
    return _unflatten(like, out_leaves), step
