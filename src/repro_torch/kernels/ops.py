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

Training: when autograd needs a gradient of a CUDA call
(:func:`needs_grad`), :func:`attention`, :func:`rmsnorm` and
:func:`ssm_scan` go through the autograd functions
:class:`_FlashAttention`, :class:`_RMSNorm` and :class:`_SSMScan`, whose
forward runs the forward kernel (flash with its LSE output, the scan with
its checkpoints) and whose backward runs the backward kernel
(``flash_attention_bwd``, ``rmsnorm_bwd``, ``ssm_scan_bwd``).  Without
grad, the wrappers are called as before, and serving's launches do not
change.  On the CPU autograd differentiates the plain versions, as JAX
differentiates its jnp oracles.  The other wrappers have no backward
kernel: called with grad needed they raise (``_build.refuse_grad``),
never returning an output cut off from the graph.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build
from . import ref as _ref
from .decode_attention import decode_attention as _da
from .flash_attention import backward_supported as _fa_backward_supported
from .flash_attention import flash_attention as _fa
from .flash_attention import flash_attention_bwd as _fab
from .paged_attention import paged_decode_attention as _pda
from .paged_attention import paged_decode_attention_int8 as _pda8
from .paged_attention import paged_prefill_attention as _ppa
from .paged_attention import paged_prefill_attention_int8 as _ppa8
from .rmsnorm import rmsnorm as _rn
from .rmsnorm import rmsnorm_bwd as _rnb
from .ssm_scan import ssm_scan as _ss
from .ssm_scan import ssm_scan_bwd as _ssb

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
    "flash_attention_bwd": _fab,
    "rmsnorm_bwd": _rnb,
    "ssm_scan_bwd": _ssb,
}
#: the wrappers with a tensor-core body beside their CUDA-core one
TC_KERNELS = ("flash_attention", "paged_prefill_attention", "paged_prefill_attention_int8",
              "flash_attention_bwd")
#: the wrappers with a split-context decode body beside their other one
SPLIT_KERNELS = ("decode_attention", "paged_decode_attention", "paged_decode_attention_int8")


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got one on {x.device}")
    return impl == "cuda" or (impl == "auto" and x.is_cuda)


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd needs a gradient through a call on ``tensors``:
    grad mode is on and one of them requires grad (pure Python; the route
    predicate of :func:`attention`, :func:`rmsnorm` and :func:`ssm_scan`)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _FlashAttention(torch.autograd.Function):
    """Flash attention whose gradient is the backward kernel.

    Forward: the flash kernel with its LSE output; saves q, k, v, the
    output and the LSE.  Backward: ``flash_attention_bwd`` on them.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float]):
        out, lse = _fa(q, k, v, causal=causal, scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fab(q, k, v, out, lse, do, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


class _RMSNorm(torch.autograd.Function):
    """RMSNorm whose gradient is the backward kernel (saves x and gamma)."""

    @staticmethod
    def forward(ctx, x, gamma, eps: float):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return _rn(x, gamma, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma = _rnb(x, gamma, dy.contiguous(), eps=ctx.eps)
        return dx, dgamma, None


class _SSMScan(torch.autograd.Function):
    """The selective scan whose gradient is the backward kernel.

    Forward: the scan kernel with its checkpoints; saves the inputs and
    them.  Backward: ``ssm_scan_bwd`` from the gradients of y and of h_T
    (None when h_T is unused).
    """

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, h0):
        y, hT, states = _ss(x, dt, A, Bm, Cm, D, h0=h0, return_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, h0, states)
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, A, Bm, Cm, D, h0, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return _ssb(x, dt, A, Bm, Cm, D, states, dy, h0=h0, dhT=dhT)


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
    plain version instead.  When a gradient is needed it runs through
    :class:`_FlashAttention`, which raises ``NotImplementedError`` for
    head dims the backward kernel is not built for.
    """
    if _use_kernel(impl, q):
        if needs_grad(q, k, v):
            if kv_len is not None or (causal and q_offset != 0):
                raise NotImplementedError("flash attention with grad takes no kv_len "
                                          "and no causal q_offset")
            if not _fa_backward_supported(q.shape[-1], v.shape[-1]):
                raise NotImplementedError(
                    f"flash attention backward: head dims {q.shape[-1]} / "
                    f"{v.shape[-1]} (built for {_build.BWD_HEAD_DIM_PAIRS})")
            return _FlashAttention.apply(q, k, v, causal, scale)
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
        if needs_grad(x, gamma):
            return _RMSNorm.apply(x, gamma, eps)
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
    """Mamba selective scan; returns ``(y, h_T)`` (see ``ref.ssm_scan_ref``).
    When a gradient is needed it runs through :class:`_SSMScan`."""
    if _use_kernel(impl, x):
        if needs_grad(x, dt, A, Bm, Cm, D, h0):
            return _SSMScan.apply(x, dt, A, Bm, Cm, D, h0)
        return _ss(x, dt, A, Bm, Cm, D, h0=h0)
    return _ref.ssm_scan_ref(x, dt, A, Bm, Cm, D, h0=h0)
