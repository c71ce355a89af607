"""GQA flash attention (prefill): wrapper of the hand-written CUDA kernel.

Replaces the JAX package's Pallas kernel
(``repro/kernels/flash_attention.py``); the kernel is
``csrc/flash_attention.cu``.  Causal (block-skipping) or bidirectional
attention of ``(B, Sq, H, hd)`` queries over ``(B, Sk, K, hd)`` keys and
``(B, Sk, K, hd_v)`` values, with the query-head group folded into the
query rows as on the TPU, cut into blocks of :data:`BLOCK_ROWS` rows.

q, k and v are read through their strides, so the wrapper transposes
nothing.  Like the TPU kernel it does not take a per-batch ``kv_len`` or
a causal ``q_offset``: both raise ``NotImplementedError`` (the plain
version, :func:`repro_torch.kernels.ref.attention_ref`, has them, and
serves the CPU through :mod:`repro_torch.kernels.ops`).

The wrapper takes CUDA tensors only, checks what the kernel accepts,
allocates the output, launches on the current stream, raises if the
launch was refused and counts its launches in
``flash_attention.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: folded (token, group) query rows per block (the f32 accumulator is
#: BLOCK_ROWS x hd_v)
BLOCK_ROWS = 64
#: largest head dim the kernel stages in shared memory
MAX_HEAD_DIM = 256


def flash_attention(
    q: torch.Tensor,          # (B, Sq, H, hd)
    k: torch.Tensor,          # (B, Sk, K, hd)
    v: torch.Tensor,          # (B, Sk, K, hd_v)
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention with GQA; the semantics of ``ref.attention_ref``.

    With ``causal`` query token i sees key tokens 0..i; the ragged tail of
    a block past ``Sk`` is masked and never read.

    Returns
    -------
    torch.Tensor
        ``(B, Sq, H, hd_v)`` in ``q.dtype``.

    Raises
    ------
    NotImplementedError
        For ``kv_len``, or a nonzero ``q_offset`` with ``causal``, as the
        TPU kernel does.
    """
    if kv_len is not None:
        raise NotImplementedError("per-batch kv_len: use ops.attention impl='ref'")
    if causal and q_offset != 0:
        raise NotImplementedError("q_offset with causal prefill is not supported")
    tensors = (q, k, v)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"flash attention kernel takes CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    if q.dtype not in _SUFFIX or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"flash attention kernel takes f32/bf16 q, k and v of one "
                         f"dtype, got {[t.dtype for t in tensors]}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash attention kernel takes (B, S, heads, d) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    _, Sk, K, _ = k.shape
    hd_v = v.shape[3]
    if (k.shape != (B, Sk, K, hd) or v.shape[:3] != (B, Sk, K) or H % K
            or max(hd, hd_v) > MAX_HEAD_DIM):
        raise ValueError(f"flash attention kernel: q {tuple(q.shape)} does not group "
                         f"over k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"(head dims up to {MAX_HEAD_DIM})")
    out = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=q.device)
    scale = scale if scale is not None else hd ** -0.5
    name = f"flash_attention_{_SUFFIX[q.dtype]}"
    code = getattr(_build.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk, H, K,
        hd, hd_v, int(bool(causal)), BLOCK_ROWS, *q.stride(), *k.stride(),
        *v.stride(), float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(code, name)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
