"""Gradient compression: int8 all-reduce with error feedback.

Copy of ``repro/distributed/compression.py``.  Data-parallel gradient
synchronization across pods crosses the slow inter-pod links; 8-bit
quantization cuts those bytes 4× (vs f32 grads).  Residual error feedback
keeps convergence: the quantization error of step t is added back into
the gradient at step t+1, so the bias telescopes.

:func:`compressed_psum` quantizes per row, all-reduces the int8 payload
widened to int32 (exact integer addition), all-reduces the scales and the
participant count, and dequantizes with the mean scale: JAX's semantics,
inexact where the participants' scales differ.  Where JAX runs it inside
``shard_map`` over a mesh axis, the port runs it on the process group of
one mesh dim (``mesh.get_group(axis)``).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with per-row (last-dim) scales; ``torch.round``
    rounds half to even, as ``jnp.round``."""
    if x.dim() == 0:
        q, s = quantize_rowwise(x[None])
        return q[0], s[0]
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_rowwise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(x: torch.Tensor, residual: Optional[torch.Tensor] = None):
    """Local quantize→dequantize round trip with error feedback.

    Returns (x_hat, new_residual): ``x_hat`` is what the wire would carry;
    the residual accumulates what was lost and is re-injected next step.
    """
    xf = x.float()
    if residual is not None:
        xf = xf + residual
    q, s = quantize_rowwise(xf)
    x_hat = dequantize_rowwise(q, s)
    return x_hat.to(x.dtype), (xf - x_hat)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-payload sum over the ranks of ``group``.

    Exact integer summation of the int8 payloads in int32; the scales and
    the count are summed separately and the result is ``qsum *
    mean(scale)``.
    """
    q, s = quantize_rowwise(x.float())
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)          # wire: int8-worth
    ssum = s.clone()
    dist.all_reduce(ssum, group=group)
    n = torch.ones((), dtype=torch.float32, device=x.device)
    dist.all_reduce(n, group=group)
    s_mean = ssum / n
    return (qsum.float() * s_mean).to(x.dtype)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def compressed_grad_allreduce(grads: Any, mesh, axis: str = "pod"):
    """Tree-wise compressed all-reduce over one mesh dim.

    Each rank holds its own replica of every gradient (JAX's ``P()``
    in-spec); the result is :func:`compressed_psum` over the ranks that
    share this rank's place on the other mesh dims.  Returns ``grads``
    unchanged without a mesh, without that dim, or when it has size 1.
    """
    names = getattr(mesh, "mesh_dim_names", None) if mesh is not None else None
    if not names or axis not in names or mesh.size(names.index(axis)) == 1:
        return grads
    group = mesh.get_group(axis)
    return _map(lambda g: compressed_psum(g, group), grads)
