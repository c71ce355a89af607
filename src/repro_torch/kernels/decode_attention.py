"""GQA decode attention over a slot KV cache: wrapper of the CUDA kernel.

Replaces the JAX package's Pallas kernel
(``repro/kernels/decode_attention.py``); the kernel is
``csrc/decode_attention.cu``.  One new query token per row attends to the
first ``lengths[b]`` rows of its slot's cache.

The cache keeps the slot engine's layout, ``(B, S_max, K, hd)``, and the
kernel reads it through its strides: a per-layer view of the stacked
cache goes in as it is, and no call transposes or copies the cache.

Two bodies serve it, chosen by shape (:func:`decode_uses_split_body`),
never by failure:

- f32 or bf16 with ``hd == hd_v`` in
  :data:`~repro_torch.kernels._build.SPLIT_HEAD_DIMS` (16, 64, 128) and
  16-byte-aligned cache rows of inner stride 1: the split-context body
  (``csrc/decode_split.cuh``): each row's cache split over
  :func:`~repro_torch.kernels._build.decode_splits` CTAs of one
  cluster, chosen from shapes alone (the wrapper never reads ``lengths``
  on the host); a CTA's warps walk the cache rows side by side, on CUDA
  cores for g <= 2 and f32, on tensor cores for bf16 with g >= 3; the
  warps merge in shared memory and the splits through distributed shared
  memory;
- any other shape (MLA decode's hd 192 / hd_v 128, hd 256, misaligned or
  strided rows): the one-block-a-row body.

The wrapper takes CUDA tensors only: it checks what the kernel accepts,
allocates the output, launches on the current stream, raises if the
launch was refused and counts its launches in
``decode_attention.launches`` and, of those, the calls the split body
served in ``decode_attention.split_launches``.  The plain version is
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


def decode_uses_split_body(q_dtype: torch.dtype, cache_dtype: torch.dtype, shapes,
                           strides, misalign) -> bool:
    """Whether the split-context body serves a call (else the one-block-a-row body).

    Pure Python on what q and the two caches describe: the dtypes, their
    ``shapes``, ``strides`` (in elements) and ``data_ptr() % 16``, each a
    triple in the order q, k cache, v cache.  True for f32 or bf16 q over a
    cache of q's dtype with ``hd == hd_v`` in ``SPLIT_HEAD_DIMS`` whose rows
    are 16-byte aligned with inner stride 1.  q is read element by element,
    so its layout does not matter.
    """
    if q_dtype not in _SUFFIX or cache_dtype != q_dtype:
        return False
    hd = shapes[0][-1]
    if hd not in _build.SPLIT_HEAD_DIMS or shapes[1][-1] != hd or shapes[2][-1] != hd:
        return False
    n = q_dtype.itemsize
    return (_build.rows_16b(shapes[1], strides[1], misalign[1], n)
            and _build.rows_16b(shapes[2], strides[2], misalign[2], n))


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
    output.  A row of length 0 returns zeros.  ``lengths`` stays on the
    device: the call makes no host sync.

    Returns
    -------
    torch.Tensor
        ``(B, H, hd_v)`` in ``q.dtype``.
    """
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
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
    dev = q.device
    q = q.contiguous()
    out = torch.empty((B, H, hd_v), dtype=q.dtype, device=dev)
    scale = float(scale if scale is not None else hd ** -0.5)
    stream = _build.current_stream(dev)
    pk, pv = k_cache.data_ptr(), v_cache.data_ptr()
    ks, vs = k_cache.stride(), v_cache.stride()
    split = decode_uses_split_body(q.dtype, k_cache.dtype,
                                   (q.shape, k_cache.shape, v_cache.shape),
                                   (q.stride(), ks, vs), (0, pk % 16, pv % 16))
    if split:
        rows, splits = _build.decode_launch(B, H, K, S, q.dtype, dev.index)
        name = f"decode_attention_split_{_SUFFIX[q.dtype]}"
        code = _build.entry(name)(
            q.data_ptr(), pk, pv, lengths.data_ptr(), out.data_ptr(), B, H, K, hd, S,
            splits, rows, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, stream,
        )
    else:
        name = f"decode_attention_{_SUFFIX[q.dtype]}"
        code = _build.entry(name)(
            q.data_ptr(), pk, pv, lengths.data_ptr(), out.data_ptr(), B, H, K, hd, hd_v,
            S, *ks, *vs, scale, stream,
        )
    _build.check(code, name)
    decode_attention.launches += 1
    decode_attention.split_launches += split
    return out


decode_attention.launches = 0
decode_attention.split_launches = 0
