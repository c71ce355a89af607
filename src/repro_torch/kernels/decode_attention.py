"""GQA decode attention over a slot KV cache: wrapper of the CUDA kernel.

Replaces the JAX package's Pallas kernel
(``repro/kernels/decode_attention.py``); the kernel is
``csrc/decode_attention.cu``.  One new query token per row attends to the
first ``lengths[b]`` rows of its slot's cache.

The cache keeps the slot engine's layout, ``(B, S_max, K, hd)``, and the
kernel reads it through its strides: a per-layer view of the stacked
cache goes in as it is, and no call transposes or copies the cache.

The wrapper takes CUDA tensors only: it checks what the kernel accepts,
allocates the output, launches on the current stream, raises if the
launch was refused and counts its launches in
``decode_attention.launches``.  The plain version is
:func:`repro_torch.kernels.ref.decode_attention_ref`, which serves the
CPU through :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: largest head dim the kernel stages in shared memory
MAX_HEAD_DIM = 256


def decode_attention(
    q: torch.Tensor,         # (B, H, hd)
    k_cache: torch.Tensor,   # (B, S_max, K, hd)
    v_cache: torch.Tensor,   # (B, S_max, K, hd_v)
    lengths: torch.Tensor,   # (B,) int32 valid cache rows
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention of one query token per row over its slot's cache.

    Cache rows at or past ``min(lengths[b], S_max)`` are never read, so
    whatever the unused tail of a slot holds (even NaN) cannot reach the
    output.  A row of length 0 returns zeros.

    Returns
    -------
    torch.Tensor
        ``(B, H, hd_v)`` in ``q.dtype``.
    """
    tensors = (q, k_cache, v_cache)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"decode attention kernel takes CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    if q.dtype not in _SUFFIX or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"decode attention kernel takes f32/bf16 q and caches of one "
                         f"dtype, got {[t.dtype for t in tensors]}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError(f"decode attention kernel takes q (B, H, hd) and caches "
                         f"(B, S, K, hd), got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, H, hd = q.shape
    _, S, K, _ = k_cache.shape
    hd_v = v_cache.shape[3]
    if (k_cache.shape != (B, S, K, hd) or v_cache.shape[:3] != (B, S, K)
            or H % K or max(hd, hd_v) > MAX_HEAD_DIM):
        raise ValueError(f"decode attention kernel: q {tuple(q.shape)} does not group "
                         f"over caches {tuple(k_cache.shape)} / {tuple(v_cache.shape)} "
                         f"(head dims up to {MAX_HEAD_DIM})")
    if (lengths.shape != (B,) or lengths.device != q.device
            or lengths.dtype != torch.int32 or not lengths.is_contiguous()):
        raise ValueError(f"lengths must be a contiguous ({B},) int32 tensor on "
                         f"{q.device}, got {lengths.dtype} {tuple(lengths.shape)} "
                         f"on {lengths.device}")
    q = q.contiguous()
    out = torch.empty((B, H, hd_v), dtype=q.dtype, device=q.device)
    scale = scale if scale is not None else hd ** -0.5
    name = f"decode_attention_{_SUFFIX[q.dtype]}"
    code = _build.entry(name)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, K, hd, hd_v, S, *k_cache.stride(), *v_cache.stride(),
        float(scale), _build.current_stream(q.device),
    )
    _build.check(code, name)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
