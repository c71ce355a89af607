"""Move parameter trees and KV payloads between numpy and the port's tensors.

The JAX package's weights depend on the interpreter's hash seed, so the
port is never held against them through a shared seed: a test builds
JAX's parameters, turns them into numpy arrays, and hands the same
values to both packages through :func:`params_from_numpy`.

numpy has no bfloat16 of its own.  JAX's bfloat16 arrays reach numpy as
the extension dtype named ``"bfloat16"``; those are read bit for bit
(through a 16-bit integer view).  The port hands bfloat16 tensors out
as float32 arrays, which hold every bfloat16 value exactly, so a round
trip through :func:`params_to_numpy` and :func:`params_from_numpy` with
``dtype=torch.bfloat16`` is bit-exact too.  int8 arrays (the payload of
int8 KV pages in migration tickets) and their float32 scale pools cross
as they are, int8 to int8, bit for bit.

AdamW state crosses through :func:`opt_state_from_numpy` and
:func:`opt_state_to_numpy`: ``{"step", "mv"}`` with float32 moments or,
for int8 state, ``QTensor(q int8, s float32)`` pairs (JAX's ``QTensor``
reaches numpy as a tuple of two arrays), bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .distributed.optimizer import QTensor

Tree = Dict[str, Any]
#: leaves a model keeps in float32 in a tree of any dtype (Mamba's A_log)
FLOAT32_LEAVES = frozenset({"A_log"})


def tensor_from_numpy(arr, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One numpy array (or anything ``np.asarray`` takes) as a tensor.

    Parameters
    ----------
    arr : array_like
        float32/int arrays, or bfloat16 arrays from JAX.  The values
        are copied; the tensor never shares the array's memory.
    device : str or torch.device, optional
        Target device; ``None`` means the CUDA device.
    dtype : torch.dtype, optional
        Cast to this dtype after the exact read.

    Returns
    -------
    torch.Tensor
    """
    a = np.array(arr)  # a private copy: the tensor never aliases the caller's
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(resolve_device(device))
    return t if dtype is None else t.to(dtype)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array of its own; bfloat16 widens exactly
    to float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def params_from_numpy(tree: Tree, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Tree:
    """The JAX package's parameter tree (as numpy arrays) as the port's tensors.

    Parameters
    ----------
    tree : dict
        Nested dicts of arrays, e.g. ``repro.models.init_params(cfg, key)[0]``
        mapped through ``np.asarray``.
    device : str or torch.device, optional
        Target device; ``None`` means the CUDA device.
    dtype : torch.dtype, optional
        Cast every leaf to this dtype (after the exact read), except the
        leaves the models keep in float32 whatever their dtype
        (:data:`FLOAT32_LEAVES`).

    Returns
    -------
    dict
        The same tree of tensors.
    """
    dev = resolve_device(device)
    return {
        k: params_from_numpy(v, dev, dtype) if isinstance(v, dict)
        else tensor_from_numpy(v, dev, torch.float32 if k in FLOAT32_LEAVES else dtype)
        for k, v in tree.items()
    }


def params_to_numpy(tree: Tree) -> Tree:
    """The port's parameter tree as numpy arrays (the reverse of
    :func:`params_from_numpy`; bfloat16 leaves come back as float32)."""
    return {
        k: params_to_numpy(v) if isinstance(v, dict) else tensor_to_numpy(v)
        for k, v in tree.items()
    }


def params_to(tree: Tree, device: DeviceLike) -> Tree:
    """Copy a parameter tree to another device (values unchanged)."""
    dev = resolve_device(device)
    return {
        k: params_to(v, dev) if isinstance(v, dict) else v.to(dev)
        for k, v in tree.items()
    }


def _mv_from_numpy(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _mv_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):  # an int8 moment: (q, s), JAX's QTensor or a pair
        q, s = tree
        return QTensor(tensor_from_numpy(q, dev), tensor_from_numpy(s, dev))
    return tensor_from_numpy(tree, dev)


def _mv_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _mv_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tensor_to_numpy(t) for t in tree)
    return tensor_to_numpy(tree)


def opt_state_from_numpy(state: Tree, device: DeviceLike = None) -> Tree:
    """The JAX package's AdamW state (as numpy arrays) as the port's.

    Parameters
    ----------
    state : dict
        ``{"step": int32 scalar, "mv": {...{"m", "v"}}}``, e.g.
        ``repro.distributed.optimizer.init_opt_state(...)`` mapped through
        ``np.asarray``; an int8 moment is a ``(q, s)`` pair.
    device : str or torch.device, optional
        Target device; ``None`` means the CUDA device.

    Returns
    -------
    dict
        The same state with tensors and :class:`~repro_torch.distributed.
        optimizer.QTensor` pairs, every value copied bit for bit.
    """
    dev = resolve_device(device)
    return {"step": tensor_from_numpy(np.asarray(state["step"], np.int32), dev),
            "mv": _mv_from_numpy(state["mv"], dev)}


def opt_state_to_numpy(state: Tree) -> Tree:
    """The port's AdamW state as numpy arrays (``QTensor`` as ``(q, s)``
    tuples): the reverse of :func:`opt_state_from_numpy`."""
    return {"step": tensor_to_numpy(state["step"]), "mv": _mv_to_numpy(state["mv"])}
