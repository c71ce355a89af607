"""Dispatch layer over the hand-written CUDA kernels and their plain versions.

Models call these entry points; ``impl`` selects:

- ``"ref"``  : the plain PyTorch version (:mod:`repro_torch.kernels.ref`);
- ``"cuda"`` : the hand-written kernel; raises on a tensor that is not on
  a CUDA device;
- ``"auto"`` : by the device of the tensor: a CPU tensor goes to the
  plain version, a CUDA tensor to the kernel.

There is no fallback: a CUDA tensor whose kernel fails to build or to
launch raises, it never goes to the plain version.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build
from . import ref as _ref
from .paged_attention import paged_decode_attention as _pda
from .paged_attention import paged_prefill_attention as _ppa
from .rmsnorm import rmsnorm as _rn

IMPLS = ("ref", "cuda", "auto")
#: the kernel wrappers, by the name their launch counts are reported under
KERNELS = {
    "paged_decode_attention": _pda,
    "paged_prefill_attention": _ppa,
    "rmsnorm": _rn,
}


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got one on {x.device}")
    return impl == "cuda" or (impl == "auto" and x.is_cuda)


def load_kernels() -> None:
    """Build (at first use) and load the kernels' library now.

    Engines call this at construction so that the one-time build never
    falls inside a serving step.
    """
    _build.library()


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Decode attention over a paged KV pool via per-request block tables."""
    if _use_kernel(impl, q):
        return _pda(q, k_pages, v_pages, block_tables, lengths, scale=scale)
    return _ref.paged_decode_attention_ref(
        q, k_pages, v_pages, block_tables, lengths, scale=scale
    )


def paged_prefill_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    past: int,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Fused chunked-prefill attention over one request's block table.

    The chunk's K/V must already be scattered into the pools; queries
    attend causally to paged history + the in-chunk segment.
    """
    if _use_kernel(impl, q):
        return _ppa(q, k_pages, v_pages, block_table, past, scale=scale)
    return _ref.paged_prefill_attention_ref(
        q, k_pages, v_pages, block_table, past, scale=scale
    )


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5,
            impl: str = "auto") -> torch.Tensor:
    if _use_kernel(impl, x):
        return _rn(x, gamma, eps=eps)
    return _ref.rmsnorm_ref(x, gamma, eps=eps)
