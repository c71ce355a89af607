"""GQA flash attention (prefill): wrapper of the hand-written CUDA kernel.

Replaces the JAX package's Pallas kernel
(``repro/kernels/flash_attention.py``); the kernel is
``csrc/flash_attention.cu``.  Causal (block-skipping) or bidirectional
attention of ``(B, Sq, H, hd)`` queries over ``(B, Sk, K, hd)`` keys and
``(B, Sk, K, hd_v)`` values, with the query-head group folded into the
query rows as on the TPU, cut into blocks of :data:`BLOCK_ROWS` rows.

Two bodies serve it, chosen by shape (:func:`uses_tensor_cores`), never
by failure:

- bf16 with ``hd == hd_v`` in :data:`~repro_torch.kernels._build.TC_HEAD_DIMS`
  (16, 64, 128: stablelm-1.6b's 64, Jamba-1.5-Large's and internlm2-20b's
  128), inner stride 1 and 16-byte-aligned rows: the tensor-core body
  (``csrc/attention_tc.cuh``: ``mma.sync`` bf16 products with f32
  accumulation, a ``cp.async`` ring of K/V tiles);
- every float32 call, and bf16 at any other shape (MLA's hd 192 / hd_v
  128, hd 256, rows that are not 16-byte aligned): the CUDA-core body in
  f32 math.

q, k and v are read through their strides, so the wrapper transposes
nothing.  Like the TPU kernel it does not take a per-batch ``kv_len`` or
a causal ``q_offset``: both raise ``NotImplementedError`` (the plain
version, :func:`repro_torch.kernels.ref.attention_ref`, has them, and
serves the CPU through :mod:`repro_torch.kernels.ops`).

The wrapper takes CUDA tensors only, checks what the kernel accepts,
allocates the output, launches on the current stream, raises if the
launch was refused and counts its calls in ``flash_attention.launches``
and, of those, the calls the tensor-core body served in
``flash_attention.tc_launches``.
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


def uses_tensor_cores(dtype: torch.dtype, shapes, strides, misalign) -> bool:
    """Whether the tensor-core body serves a call (else the CUDA-core body).

    Pure Python on what q, k and v describe: their ``dtype``, ``shapes``,
    ``strides`` (in elements) and ``data_ptr() % 16``, each a triple in
    the order q, k, v.  True for bf16 with ``hd == hd_v`` in
    ``TC_HEAD_DIMS`` whose rows are 16-byte aligned with inner stride 1.
    """
    if dtype != torch.bfloat16:
        return False
    hd = shapes[0][-1]
    if hd != shapes[2][-1] or hd not in _build.TC_HEAD_DIMS:
        return False
    return (_build.rows_16b(shapes[0], strides[0], misalign[0], 2)
            and _build.rows_16b(shapes[1], strides[1], misalign[1], 2)
            and _build.rows_16b(shapes[2], strides[2], misalign[2], 2))


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
    dev, dtype = q.device, q.dtype
    if not (q.is_cuda and k.device == dev and v.device == dev):
        raise ValueError(f"flash attention kernel takes CUDA tensors on one device, "
                         f"got {[str(t.device) for t in (q, k, v)]}")
    if dtype not in _SUFFIX or k.dtype != dtype or v.dtype != dtype:
        raise ValueError(f"flash attention kernel takes f32/bf16 q, k and v of one "
                         f"dtype, got {[t.dtype for t in (q, k, v)]}")
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
    out = torch.empty((B, Sq, H, hd_v), dtype=dtype, device=dev)
    scale = float(scale if scale is not None else hd ** -0.5)
    stream = _build.current_stream(dev)
    pq, pk, pv = q.data_ptr(), k.data_ptr(), v.data_ptr()
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    tc = uses_tensor_cores(dtype, (q.shape, k.shape, v.shape), (qs, ks, vs),
                           (pq % 16, pk % 16, pv % 16))
    if tc:
        name = "flash_attention_tc_bf16"
        code = _build.entry(name)(
            pq, pk, pv, out.data_ptr(), B, Sq, Sk, H, K, hd, int(bool(causal)), qs[0],
            qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, stream,
        )
    else:
        name = f"flash_attention_{_SUFFIX[dtype]}"
        code = _build.entry(name)(
            pq, pk, pv, out.data_ptr(), B, Sq, Sk, H, K, hd, hd_v, int(bool(causal)),
            BLOCK_ROWS, *qs, *ks, *vs, scale, stream,
        )
    _build.check(code, name)
    flash_attention.launches += 1
    flash_attention.tc_launches += tc
    return out


flash_attention.launches = 0
flash_attention.tc_launches = 0
