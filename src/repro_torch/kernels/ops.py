"""Dispatch layer over the hand-written CUDA kernels and their plain versions.

Models call these entry points; ``impl`` selects:

- ``"ref"``  : the plain PyTorch version (:mod:`repro_torch.kernels.ref`);
- ``"cuda"`` : the hand-written kernel; raises on a tensor that is not on
  a CUDA device;
- ``"auto"`` : by the device of the tensor: a CPU tensor goes to the
  plain version, a CUDA tensor to the kernel.

There is no fallback: a CUDA tensor whose kernel fails to build or to
launch raises, it never goes to the plain version.  The paged attention
entry points take ``k_scales``/``v_scales`` for int8 pools; on a CUDA
device those go to the int8 kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build
from . import ref as _ref
from .decode_attention import decode_attention as _da
from .flash_attention import flash_attention as _fa
from .paged_attention import paged_decode_attention as _pda
from .paged_attention import paged_decode_attention_int8 as _pda8
from .paged_attention import paged_prefill_attention as _ppa
from .paged_attention import paged_prefill_attention_int8 as _ppa8
from .rmsnorm import rmsnorm as _rn
from .ssm_scan import ssm_scan as _ss

IMPLS = ("ref", "cuda", "auto")
#: the kernel wrappers, by the name their launch counts are reported under
KERNELS = {
    "paged_decode_attention": _pda,
    "paged_prefill_attention": _ppa,
    "rmsnorm": _rn,
    "decode_attention": _da,
    "flash_attention": _fa,
    "paged_decode_attention_int8": _pda8,
    "paged_prefill_attention_int8": _ppa8,
    "ssm_scan": _ss,
}
#: the wrappers with a tensor-core body beside their CUDA-core one
TC_KERNELS = ("flash_attention", "paged_prefill_attention", "paged_prefill_attention_int8")
#: the wrappers with a split-context decode body beside their other one
SPLIT_KERNELS = ("decode_attention", "paged_decode_attention", "paged_decode_attention_int8")


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


def tc_launch_counts() -> Dict[str, int]:
    """Of those launches, the ones the tensor-core bodies served."""
    return {name: KERNELS[name].tc_launches for name in TC_KERNELS}


def split_launch_counts() -> Dict[str, int]:
    """Of those launches, the ones the split-context decode bodies served."""
    return {name: KERNELS[name].split_launches for name in SPLIT_KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for name in TC_KERNELS:
        KERNELS[name].tc_launches = 0
    for name in SPLIT_KERNELS:
        KERNELS[name].split_launches = 0


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Multi-head (GQA) attention: the flash kernel for CUDA tensors.

    The kernel does not take ``kv_len`` or a causal ``q_offset`` and
    raises ``NotImplementedError`` for them; they are not sent to the
    plain version instead.
    """
    if _use_kernel(impl, q):
        return _fa(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                   kv_len=kv_len)
    return _ref.attention_ref(q, k, v, causal=causal, scale=scale,
                              q_offset=q_offset, kv_len=kv_len)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Decode attention of one token per row over a dense slot cache."""
    if _use_kernel(impl, q):
        return _da(q, k_cache, v_cache, lengths, scale=scale)
    return _ref.decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Decode attention over a paged KV pool via per-request block tables.

    With ``k_scales``/``v_scales`` the pools are int8 and dequantized
    per page inside the kernel (plain version: dequantize, then attend).
    """
    if _use_kernel(impl, q):
        if k_scales is not None:
            return _pda8(q, k_pages, v_pages, block_tables, lengths,
                         k_scales, v_scales, scale=scale)
        return _pda(q, k_pages, v_pages, block_tables, lengths, scale=scale)
    return _ref.paged_decode_attention_ref(
        q, k_pages, v_pages, block_tables, lengths, scale=scale,
        k_scales=k_scales, v_scales=v_scales,
    )


def paged_prefill_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    past: int,
    scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Fused chunked-prefill attention over one request's block table.

    The chunk's K/V must already be scattered into the pools; queries
    attend causally to paged history + the in-chunk segment.  With
    ``k_scales``/``v_scales`` the pools are int8 (see decode).
    """
    if _use_kernel(impl, q):
        if k_scales is not None:
            return _ppa8(q, k_pages, v_pages, block_table, past,
                         k_scales, v_scales, scale=scale)
        return _ppa(q, k_pages, v_pages, block_table, past, scale=scale)
    return _ref.paged_prefill_attention_ref(
        q, k_pages, v_pages, block_table, past, scale=scale,
        k_scales=k_scales, v_scales=v_scales,
    )


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 KV quantization (per token, per kv head).

    Plain elementwise PyTorch on every device, as in the JAX package:
    one spec shared by the paged engine's quantize-on-scatter, the int8
    slot cache and the plain versions; see
    :func:`repro_torch.kernels.ref.quantize_kv_ref`.
    """
    return _ref.quantize_kv_ref(x)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5,
            impl: str = "auto") -> torch.Tensor:
    if _use_kernel(impl, x):
        return _rn(x, gamma, eps=eps)
    return _ref.rmsnorm_ref(x, gamma, eps=eps)


def ssm_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba selective scan; returns ``(y, h_T)`` (see ``ref.ssm_scan_ref``)."""
    if _use_kernel(impl, x):
        return _ss(x, dt, A, Bm, Cm, D, h0=h0)
    return _ref.ssm_scan_ref(x, dt, A, Bm, Cm, D, h0=h0)
