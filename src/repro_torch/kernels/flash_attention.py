"""GQA flash attention (prefill): wrapper of the hand-written CUDA kernel.

Replaces the JAX package's Pallas kernel
(``repro/kernels/flash_attention.py``); the kernel is
``csrc/flash_attention.cu``.  Causal (block-skipping) or bidirectional
attention of ``(B, Sq, H, hd)`` queries over ``(B, Sk, K, hd)`` keys and
``(B, Sk, K, hd_v)`` values, with the query-head group folded into the
query rows as on the TPU, cut into blocks of :data:`BLOCK_ROWS` rows.

Two bodies serve it, chosen by shape (:func:`uses_tensor_cores`), never
by failure:

- bf16 with ``(hd, hd_v)`` in
  :data:`~repro_torch.kernels._build.TC_HEAD_DIM_PAIRS` (16, 64 and 128
  at hd == hd_v: stablelm-1.6b's 64, Jamba-1.5-Large's and internlm2-20b's
  128; and MLA's 192 / 128, DeepSeek-V2-Lite's), inner stride 1 and
  16-byte-aligned rows: the tensor-core body (``csrc/attention_tc.cuh``:
  ``mma.sync`` bf16 products with f32 accumulation, a ``cp.async`` ring
  of K/V tiles);
- every float32 call, and bf16 at any other shape (MLA's smoke 24 / 16,
  hd 256, rows that are not 16-byte aligned): the CUDA-core body in f32
  math.

q, k and v are read through their strides, so the wrapper transposes
nothing.  Like the TPU kernel it does not take a per-batch ``kv_len`` or
a causal ``q_offset``: both raise ``NotImplementedError`` (the plain
version, :func:`repro_torch.kernels.ref.attention_ref`, has them, and
serves the CPU through :mod:`repro_torch.kernels.ops`).

The wrapper takes CUDA tensors only, checks what the kernel accepts,
allocates the output, launches on the current stream, raises if the
launch was refused and counts its calls in ``flash_attention.launches``
and, of those, the calls the tensor-core body served in
``flash_attention.tc_launches``.  With ``return_lse`` both bodies also
write each row's log-sum-exp, which the backward reads.

:func:`flash_attention_bwd` wraps the backward kernel
(``csrc/flash_attention_bwd.cu``: dq, dk, dv from q, k, v, the output,
its LSE and the output's gradient; deterministic, causal or
bidirectional, ragged, GQA, strided inputs) for f32 and bf16 at the head
dims of :data:`~repro_torch.kernels._build.BWD_HEAD_DIM_PAIRS`: hd == hd_v
at 16, 64 and 128, and MLA's 24 / 16 and 192 / 128
(:func:`backward_supported`; other head dims raise
``NotImplementedError``).  It too has two bodies, chosen by shape
(:func:`backward_uses_tensor_cores`): bf16 at the forward's
``TC_HEAD_DIM_PAIRS`` (MLA's 192 / 128 included) whose q, k, v, o and do
rows are 16-byte aligned with inner stride 1 takes the tensor-core body
(FlashAttention-2's backward on ``mma.sync``), everything else (f32, MLA's
smoke 24 / 16, rows off 16 bytes, strided inner dims) the CUDA-core body in
f32 math.  Its calls are counted in ``flash_attention_bwd.launches``
and, of those, the tensor-core body's in ``flash_attention_bwd.tc_launches``.  The trainer
reaches both through ``ops._FlashAttention``.  Called directly with grad
mode on and an input that requires grad, the forward wrapper raises (its
output has no gradient).
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
    the order q, k, v.  True for bf16 with ``(hd, hd_v)`` in
    ``TC_HEAD_DIM_PAIRS`` whose rows are 16-byte aligned with inner stride 1.
    """
    if dtype != torch.bfloat16:
        return False
    if (shapes[0][-1], shapes[2][-1]) not in _build.TC_HEAD_DIM_PAIRS:
        return False
    return (_build.rows_16b(shapes[0], strides[0], misalign[0], 2)
            and _build.rows_16b(shapes[1], strides[1], misalign[1], 2)
            and _build.rows_16b(shapes[2], strides[2], misalign[2], 2))


def backward_uses_tensor_cores(dtype: torch.dtype, shapes, strides, misalign) -> bool:
    """Whether the backward's tensor-core body serves a call (else its
    CUDA-core body).

    Pure Python on what q, k, v, o and do describe: ``dtype``, and their
    ``shapes``, ``strides`` (in elements) and ``data_ptr() % 16``, each a
    5-tuple in that order.  True for bf16 with ``(hd, hd_v)`` in
    ``TC_HEAD_DIM_PAIRS`` whose five tensors' rows are 16-byte aligned with
    inner stride 1.
    """
    if dtype != torch.bfloat16:
        return False
    if (shapes[0][-1], shapes[2][-1]) not in _build.TC_HEAD_DIM_PAIRS:
        return False
    return all(_build.rows_16b(sh, st, m, 2) for sh, st, m in zip(shapes, strides, misalign))


def backward_supported(hd: int, hd_v: int) -> bool:
    """Whether the backward kernel takes a call's head dims (pure Python):
    ``(hd, hd_v)`` in ``BWD_HEAD_DIM_PAIRS`` (stablelm-1.6b's 64,
    internlm2-20b's and Jamba's 128, the smoke configs' 16, MLA's 192 / 128
    and its smoke config's 24 / 16)."""
    return (hd, hd_v) in _build.BWD_HEAD_DIM_PAIRS


def flash_attention(
    q: torch.Tensor,          # (B, Sq, H, hd)
    k: torch.Tensor,          # (B, Sk, K, hd)
    v: torch.Tensor,          # (B, Sk, K, hd_v)
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,
    return_lse: bool = False,
):
    """Flash attention with GQA; the semantics of ``ref.attention_ref``.

    With ``causal`` query token i sees key tokens 0..i; the ragged tail of
    a block past ``Sk`` is masked and never read.

    Returns
    -------
    torch.Tensor or tuple of torch.Tensor
        ``(B, Sq, H, hd_v)`` in ``q.dtype``; with ``return_lse`` also the
        rows' log-sum-exp ``(B, H, Sq)`` float32 (``ref.attention_lse_ref``).

    Raises
    ------
    NotImplementedError
        For ``kv_len``, or a nonzero ``q_offset`` with ``causal``, as the
        TPU kernel does.
    RuntimeError
        With grad mode on and an input that requires grad.
    """
    _build.refuse_grad("flash_attention", q, k, v)
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
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev) if return_lse else None
    p_lse = None if lse is None else lse.data_ptr()
    scale = float(scale if scale is not None else hd ** -0.5)
    stream = _build.current_stream(dev)
    pq, pk, pv = q.data_ptr(), k.data_ptr(), v.data_ptr()
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    tc = uses_tensor_cores(dtype, (q.shape, k.shape, v.shape), (qs, ks, vs),
                           (pq % 16, pk % 16, pv % 16))
    if tc:
        name = "flash_attention_tc_bf16"
        code = _build.entry(name)(
            pq, pk, pv, out.data_ptr(), p_lse, B, Sq, Sk, H, K, hd, hd_v, int(bool(causal)),
            qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, stream,
        )
    else:
        name = f"flash_attention_{_SUFFIX[dtype]}"
        code = _build.entry(name)(
            pq, pk, pv, out.data_ptr(), p_lse, B, Sq, Sk, H, K, hd, hd_v, int(bool(causal)),
            BLOCK_ROWS, *qs, *ks, *vs, scale, stream,
        )
    _build.check(code, name)
    flash_attention.launches += 1
    flash_attention.tc_launches += tc
    return out if lse is None else (out, lse)


flash_attention.launches = 0
flash_attention.tc_launches = 0


def flash_attention_bwd(
    q: torch.Tensor,          # (B, Sq, H, hd)
    k: torch.Tensor,          # (B, Sk, K, hd)
    v: torch.Tensor,          # (B, Sk, K, hd_v)
    o: torch.Tensor,          # (B, Sq, H, hd_v) the forward's output
    lse: torch.Tensor,        # (B, H, Sq) f32, the forward's return_lse
    do: torch.Tensor,         # (B, Sq, H, hd_v) gradient of o
    causal: bool = True,
    scale: Optional[float] = None,
):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention`; the semantics
    of ``ref.attention_bwd_ref``.

    q, k, v, o and do are read through their strides; the gradients are
    contiguous, in the inputs' dtype.  Keys past ``Sk`` are never read.

    Raises
    ------
    NotImplementedError
        For head dims the kernel is not built for (:func:`backward_supported`).
    """
    dev, dtype = q.device, q.dtype
    ts = (q, k, v, o, do)
    if not all(t.is_cuda and t.device == dev for t in ts + (lse,)):
        raise ValueError("flash attention backward kernel takes CUDA tensors on one device")
    if dtype not in _SUFFIX or any(t.dtype != dtype for t in ts):
        raise ValueError(f"flash attention backward kernel takes f32/bf16 q, k, v, o and "
                         f"do of one dtype, got {[t.dtype for t in ts]}")
    if any(t.dim() != 4 for t in ts):
        raise ValueError("flash attention backward kernel takes (B, S, heads, d) tensors")
    B, Sq, H, hd = q.shape
    _, Sk, K, _ = k.shape
    hd_v = v.shape[3]
    if not backward_supported(hd, hd_v):
        raise NotImplementedError(f"flash attention backward: head dims {hd} / {hd_v} "
                                  f"(built for {_build.BWD_HEAD_DIM_PAIRS})")
    if (k.shape != (B, Sk, K, hd) or v.shape != (B, Sk, K, hd_v) or H % K
            or o.shape != (B, Sq, H, hd_v) or do.shape != (B, Sq, H, hd_v)):
        raise ValueError(f"flash attention backward kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} do not match")
    if lse.dtype != torch.float32 or lse.shape != (B, H, Sq) or not lse.is_contiguous():
        raise ValueError(f"flash attention backward kernel takes a contiguous float32 lse "
                         f"({B}, {H}, {Sq}), got {lse.dtype} {tuple(lse.shape)}")
    dq = torch.empty((B, Sq, H, hd), dtype=dtype, device=dev)
    dk = torch.empty((B, Sk, K, hd), dtype=dtype, device=dev)
    dv = torch.empty((B, Sk, K, hd_v), dtype=dtype, device=dev)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    scale = float(scale if scale is not None else hd ** -0.5)
    tc = backward_uses_tensor_cores(dtype, tuple(t.shape for t in ts),
                                    tuple(t.stride() for t in ts),
                                    tuple(t.data_ptr() % 16 for t in ts))
    name = "flash_attention_bwd_tc_bf16" if tc else f"flash_attention_bwd_{_SUFFIX[dtype]}"
    code = _build.entry(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, K, hd, hd_v,
        int(bool(causal)), *q.stride(), *k.stride(), *v.stride(), *o.stride(), *do.stride(),
        scale, _build.current_stream(dev),
    )
    _build.check(code, name)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.tc_launches += tc
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.tc_launches = 0
