"""Mesh construction on DeviceMesh.

Copy of ``repro/launch/mesh.py``.  Defined as FUNCTIONS (never
module-level constants) so importing this module never touches the
process group: each builds an ``init_device_mesh`` over the ranks of the
default group, which the caller has initialised.  The meshes live on the
CUDA device type when CUDA is available, else on the CPU (a ``gloo``
group), unless ``device_type`` names one (the dry run's meshes are on
``"cpu"`` over a fake group, even where CUDA is present).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """16×16 = 256 chips per pod; 2 pods = 512 chips with a leading
    ``pod`` dim (data parallel across the inter-pod links)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: Optional[str] = None):
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_host_mesh():
    """Single-host debug mesh over however many ranks exist (≥2); ``None``
    below two ranks or without a process group."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    if n < 2:
        return None
    return make_mesh((1, n), ("data", "model"))
