"""Paged GQA attention: wrappers of the hand-written CUDA kernels.

Replaces the JAX package's Pallas kernels in
``repro/kernels/paged_attention.py``, in both of their forms:

- :func:`paged_decode_attention` (``csrc/paged_decode.cu``): one new
  query token per request attends to its paged history;
- :func:`paged_prefill_attention` (``csrc/paged_prefill.cu``): a chunk of
  C query tokens of one request attends causally to its paged history
  plus the chunk itself (the chunk's K/V are already in the pool);
- :func:`paged_decode_attention_int8` and
  :func:`paged_prefill_attention_int8`: the same kernels over int8 pools
  with float32 per-page scale pools ``(P, page_size, K)`` (the TPU
  kernels' ``quantized=True`` form), dequantized per page row inside the
  kernel.  An int8 page costs half the bytes of a bf16 page plus 4 bytes
  of scale per token slot and kv head for K and for V (1.88x fewer bytes
  a token than bf16 at hd = 64, 3.76x fewer than float32).

The decode kernel has two bodies, chosen by shape
(:func:`decode_uses_split_body`), never by failure: f32 or bf16 queries
over pages of their dtype or int8 with hd in ``SPLIT_HEAD_DIMS`` (16, 64,
128) and 16-byte-aligned page rows go to the split-context body
(``csrc/decode_split.cuh``: each row's context split over
:func:`~repro_torch.kernels._build.decode_splits` CTAs of one cluster, a
CTA's warps side by side on its tokens, on CUDA cores for g <= 2 and f32
queries and on tensor cores for bf16 with g >= 3, the warps merged in
shared memory and the splits through distributed shared memory); any
other shape (hd 256, misaligned or strided page rows) to the one-block-a-
row body.  The split count comes from shapes alone: the wrappers never
read ``lengths`` on the host.  ``paged_decode_attention.split_launches``
(and the int8 wrapper's) count the calls the split body served.

The prefill kernel has two bodies, chosen by shape
(:func:`prefill_uses_tensor_cores`), never by failure: bf16 queries over
bf16 or int8 pages with hd in ``TC_HEAD_DIMS`` (16, 64, 128), a
power-of-two page size and 16-byte-aligned rows go to the tensor-core
body (``csrc/attention_tc.cuh``: ``mma.sync`` bf16 products with f32
accumulation, a ``cp.async`` ring of 64-token key tiles, the context
split over :func:`prefill_splits` CTAs of one cluster so that one chunk
fills the card); every float32 call, and bf16 at any other shape (hd 256,
another page size, misaligned rows), to the CUDA-core body in f32 math.
``paged_prefill_attention.tc_launches`` (and the int8 wrapper's) count
the calls the tensor-core body served.

Pools keep the JAX layout, token-major ``(P, page_size, K, hd)``.  The
kernels read them (and the scale pools) through their strides, so a
per-layer view of a stacked pool goes in as it is and no call copies or
transposes a pool.

The wrappers take CUDA tensors only: they check what the kernels accept,
allocate the output (in q's dtype), launch on the current stream, raise
if the launch was refused, and count their launches in
``<wrapper>.launches``.  The plain versions live in
:mod:`repro_torch.kernels.ref` and serve the CPU through
:mod:`repro_torch.kernels.ops`.

The host-side checks :func:`check_block_table_bounds` and
:func:`check_scale_pool_finite` are numpy copies of the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: query rows per prefill block (the f32 accumulator is BM x hd)
PREFILL_BLOCK_ROWS = 64

Scales = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _check_pools(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 what: str, scales: Scales = None) -> None:
    _build.refuse_grad(what, q, k_pages, v_pages, *(scales or ()))
    dev = q.device
    if not (q.is_cuda and k_pages.device == dev and v_pages.device == dev
            and (scales is None or scales[0].device == dev and scales[1].device == dev)):
        raise ValueError(f"{what} kernel takes CUDA tensors on one device, got "
                         f"{[str(t.device) for t in (q, k_pages, v_pages) + (scales or ())]}")
    page_dtype = torch.int8 if scales is not None else q.dtype
    if q.dtype not in _SUFFIX or k_pages.dtype != page_dtype \
            or v_pages.dtype != page_dtype:
        raise ValueError(f"{what} kernel takes f32/bf16 q and {page_dtype} pages, "
                         f"got {[t.dtype for t in (q, k_pages, v_pages)]}")
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"{what} kernel takes (P, ps, K, hd) pools with hd_v == hd, "
                         f"got {tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    H, hd = q.shape[-2], q.shape[-1]
    K = k_pages.shape[2]
    if k_pages.shape[3] != hd or H % K:
        raise ValueError(f"{what} kernel: q heads {H} x {hd} do not group over "
                         f"pool heads {K} x {k_pages.shape[3]}")
    if scales is not None and not all(
            s.dtype == torch.float32 and s.shape == k_pages.shape[:3] for s in scales):
        raise ValueError(f"{what} kernel takes float32 (P, ps, K) scale pools, got "
                         f"{[(s.dtype, tuple(s.shape)) for s in scales]}")


def prefill_uses_tensor_cores(q_dtype: torch.dtype, page_dtype: torch.dtype, shapes,
                              strides, misalign) -> bool:
    """Whether the tensor-core body serves a prefill call (else the CUDA-core body).

    Pure Python on what q and the two pools describe: the dtypes, their
    ``shapes``, ``strides`` (in elements) and ``data_ptr() % 16``, each a
    triple in the order q, k pages, v pages.  True for bf16 q over bf16 or
    int8 pages of a power-of-two page size with hd in ``TC_HEAD_DIMS``,
    whose rows (q's and the page rows) are 16-byte aligned with inner
    stride 1.
    """
    if q_dtype != torch.bfloat16 or page_dtype not in (torch.bfloat16, torch.int8):
        return False
    ps = shapes[1][1]
    if shapes[0][-1] not in _build.TC_HEAD_DIMS or ps & (ps - 1):
        return False
    n = page_dtype.itemsize
    return (_build.rows_16b(shapes[0], strides[0], misalign[0], 2)
            and _build.rows_16b(shapes[1], strides[1], misalign[1], n)
            and _build.rows_16b(shapes[2], strides[2], misalign[2], n))


def prefill_splits(K: int, rows: int, n_tiles: int, sms: int) -> int:
    """Context splits of a tensor-core prefill call.

    ``K * ceil(rows / TC_ROWS)`` CTAs hold the ``rows = C * g`` folded
    query rows of the kv heads, over a context of ``n_tiles`` key tiles:
    the fewest power-of-two splits (up to ``TC_MAX_SPLITS``, and at most
    ``n_tiles``) that give at least one CTA per SM of the ``sms``, so that
    one chunk fills the card.  Each split walks an equal run of whole
    tiles of its row block's visible keys.
    """
    ctas = K * -(-rows // _build.TC_ROWS)
    splits = 1
    while splits < _build.TC_MAX_SPLITS and 2 * splits <= n_tiles and ctas * splits < sms:
        splits *= 2
    return splits


def decode_uses_split_body(q_dtype: torch.dtype, page_dtype: torch.dtype, shapes,
                           strides, misalign) -> bool:
    """Whether the split-context body serves a decode call (else the
    one-block-a-row body).

    Pure Python on what q and the two pools describe: the dtypes, their
    ``shapes``, ``strides`` (in elements) and ``data_ptr() % 16``, each a
    triple in the order q, k pages, v pages.  True for f32 or bf16 q over
    pages of q's dtype or int8, with hd in ``SPLIT_HEAD_DIMS`` and page
    rows that are 16-byte aligned with inner stride 1.  q is read element
    by element, so its layout does not matter.
    """
    if q_dtype not in _SUFFIX or page_dtype not in (q_dtype, torch.int8):
        return False
    hd = shapes[0][-1]
    if hd not in _build.SPLIT_HEAD_DIMS or shapes[1][-1] != hd or shapes[2][-1] != hd:
        return False
    n = page_dtype.itemsize
    return (_build.rows_16b(shapes[1], strides[1], misalign[1], n)
            and _build.rows_16b(shapes[2], strides[2], misalign[2], n))


def _index(t: torch.Tensor, device: torch.device, what: str) -> torch.Tensor:
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous int32 tensor on {device}, "
                         f"got {t.dtype} on {t.device}")
    return t


def _scale_args(scales: Scales) -> Tuple[tuple, tuple]:
    """The scale pools' pointers and (P, ps, K) strides, or nothing for fp pools."""
    if scales is None:
        return (), ()
    ks, vs = scales
    return (ks.data_ptr(), vs.data_ptr()), (*ks.stride(), *vs.stride())


def _decode(q, k_pages, v_pages, block_tables, lengths, scale, scales: Scales):
    """Launch one decode call; returns ``(out, whether the split body ran)``."""
    what = "paged decode" if scales is None else "int8 paged decode"
    _check_pools(q, k_pages, v_pages, what, scales)
    B, H, hd = q.shape
    P, ps, K, _ = k_pages.shape
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")
    dev = q.device
    bt = _index(block_tables, dev, "block_tables")
    lens = _index(lengths, dev, "lengths")
    q = q.contiguous()
    out = torch.empty_like(q)
    scale = float(scale if scale is not None else hd ** -0.5)
    ptrs, strides = _scale_args(scales)
    stream = _build.current_stream(dev)
    q8 = "" if scales is None else "q8_"
    pk, pv = k_pages.data_ptr(), v_pages.data_ptr()
    ks, vs = k_pages.stride(), v_pages.stride()
    npp = bt.shape[1]
    split = decode_uses_split_body(q.dtype, k_pages.dtype,
                                   (q.shape, k_pages.shape, v_pages.shape),
                                   (q.stride(), ks, vs), (0, pk % 16, pv % 16))
    if split:
        rows, splits = _build.decode_launch(B, H, K, npp * ps, q.dtype, dev.index)
        name = f"paged_decode_{q8}split_{_SUFFIX[q.dtype]}"
        code = _build.entry(name)(
            q.data_ptr(), pk, pv, *ptrs, bt.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, H, K, hd, ps, npp, P, splits, rows, ks[0], ks[1], ks[2], vs[0], vs[1],
            vs[2], *strides, scale, stream,
        )
    else:
        name = f"paged_decode_{q8}{_SUFFIX[q.dtype]}"
        code = _build.entry(name)(
            q.data_ptr(), pk, pv, *ptrs, bt.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, H, K, hd, ps, npp, P, *ks, *vs, *strides, scale, stream,
        )
    _build.check(code, name)
    return out, split


def _prefill(q, k_pages, v_pages, block_table, past, scale, scales: Scales):
    """Launch one prefill call; returns ``(out, whether the tensor-core body ran)``."""
    what = "paged prefill" if scales is None else "int8 paged prefill"
    _check_pools(q, k_pages, v_pages, what, scales)
    C, H, hd = q.shape
    P, ps, K, _ = k_pages.shape
    past = int(past)
    n_ctx_pages = -(-(past + C) // ps)
    if block_table.dim() != 1 or block_table.shape[0] < n_ctx_pages or past < 0:
        raise ValueError(f"block_table {tuple(block_table.shape)} cannot cover "
                         f"past={past} + C={C} at page size {ps}")
    dev = q.device
    bt = _index(block_table, dev, "block_table")
    q = q.contiguous()
    out = torch.empty_like(q)
    scale = float(scale if scale is not None else hd ** -0.5)
    ptrs, strides = _scale_args(scales)
    stream = _build.current_stream(dev)
    q8 = "" if scales is None else "q8_"
    pq, pk, pv = q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()
    ks, vs = k_pages.stride(), v_pages.stride()
    tc = prefill_uses_tensor_cores(q.dtype, k_pages.dtype,
                                   (q.shape, k_pages.shape, v_pages.shape),
                                   (q.stride(), ks, vs), (pq % 16, pk % 16, pv % 16))
    if tc:
        splits = prefill_splits(K, C * (H // K), -(-(past + C) // _build.TC_TILE),
                                _build.sm_count(dev.index))
        name = f"paged_prefill_{q8}tc_bf16"
        code = _build.entry(name)(
            pq, pk, pv, *ptrs, bt.data_ptr(), out.data_ptr(), C, H, K, hd, ps, P, past,
            splits, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], *strides, scale, stream,
        )
    else:
        name = f"paged_prefill_{q8}{_SUFFIX[q.dtype]}"
        code = _build.entry(name)(
            pq, pk, pv, *ptrs, bt.data_ptr(), out.data_ptr(), C, H, K, hd, ps, P, past,
            PREFILL_BLOCK_ROWS, *ks, *vs, *strides, scale, stream,
        )
    _build.check(code, name)
    return out, tc


def paged_decode_attention(
    q: torch.Tensor,             # (B, H, hd)
    k_pages: torch.Tensor,       # (P, page_size, K, hd) physical page pool
    v_pages: torch.Tensor,       # (P, page_size, K, hd)
    block_tables: torch.Tensor,  # (B, pages_per_seq) int32 page ids
    lengths: torch.Tensor,       # (B,) int32 — valid tokens (incl. current)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over a paged KV pool through per-request block tables.

    Pages at or past ``ceil(lengths[b] / page_size)`` are never read;
    positions at or past ``lengths[b]`` get weight exactly 0 and never
    reach P.V (the split body does not load them, the other body zeroes
    their V rows), so garbage (even NaN) in recycled pages cannot leak.
    A row of length 0 returns zeros.  ``lengths`` stays on the device: the
    call makes no host sync.

    Returns
    -------
    torch.Tensor
        ``(B, H, hd)`` in ``q.dtype``.
    """
    out, split = _decode(q, k_pages, v_pages, block_tables, lengths, scale, None)
    paged_decode_attention.launches += 1
    paged_decode_attention.split_launches += split
    return out


paged_decode_attention.launches = 0
paged_decode_attention.split_launches = 0


def paged_decode_attention_int8(
    q: torch.Tensor,             # (B, H, hd) f32 or bf16
    k_pages: torch.Tensor,       # (P, page_size, K, hd) int8
    v_pages: torch.Tensor,       # (P, page_size, K, hd) int8
    block_tables: torch.Tensor,  # (B, pages_per_seq) int32 page ids
    lengths: torch.Tensor,       # (B,) int32 — valid tokens (incl. current)
    k_scales: torch.Tensor,      # (P, page_size, K) f32
    v_scales: torch.Tensor,      # (P, page_size, K) f32
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`paged_decode_attention` over int8 pools and their scale pools.

    The int8 values are widened exactly and the scales applied in f32
    (the split body scales the score by k_scale after the product and the
    weight by v_scale; the other body dequantizes each staged row).  The
    masking is the fp kernel's, applied after the scales, so a NaN, Inf or
    1e30 scale of a slot past the length (an unwritten or recycled slot)
    cannot reach the output.

    Returns
    -------
    torch.Tensor
        ``(B, H, hd)`` in ``q.dtype`` (f32 accumulation, one rounding).
    """
    out, split = _decode(q, k_pages, v_pages, block_tables, lengths, scale,
                         (k_scales, v_scales))
    paged_decode_attention_int8.launches += 1
    paged_decode_attention_int8.split_launches += split
    return out


paged_decode_attention_int8.launches = 0
paged_decode_attention_int8.split_launches = 0


def paged_prefill_attention(
    q: torch.Tensor,            # (C, H, hd) — one request's chunk queries
    k_pages: torch.Tensor,      # (P, page_size, K, hd) physical page pool
    v_pages: torch.Tensor,      # (P, page_size, K, hd)
    block_table: torch.Tensor,  # (pages_per_seq,) int32 page ids
    past: int,                  # prompt tokens already prefilled (chunk offset)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused chunked-prefill attention over one request's block table.

    The chunk's K/V must already be scattered into the pools (positions
    ``past .. past+C``); its queries attend causally to the
    ``ceil((past+C)/page_size)`` context pages named by the block table.
    ``past`` is a runtime argument of the kernel: no chunk offset builds
    anything new.

    Returns
    -------
    torch.Tensor
        ``(C, H, hd)`` in ``q.dtype``.
    """
    out, tc = _prefill(q, k_pages, v_pages, block_table, past, scale, None)
    paged_prefill_attention.launches += 1
    paged_prefill_attention.tc_launches += tc
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.tc_launches = 0


def paged_prefill_attention_int8(
    q: torch.Tensor,            # (C, H, hd) f32 or bf16
    k_pages: torch.Tensor,      # (P, page_size, K, hd) int8
    v_pages: torch.Tensor,      # (P, page_size, K, hd) int8
    block_table: torch.Tensor,  # (pages_per_seq,) int32 page ids
    past: int,                  # prompt tokens already prefilled (chunk offset)
    k_scales: torch.Tensor,     # (P, page_size, K) f32
    v_scales: torch.Tensor,     # (P, page_size, K) f32
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`paged_prefill_attention` over int8 pools and their scale pools.

    Returns
    -------
    torch.Tensor
        ``(C, H, hd)`` in ``q.dtype`` (f32 accumulation, one rounding).
    """
    out, tc = _prefill(q, k_pages, v_pages, block_table, past, scale,
                   (k_scales, v_scales))
    paged_prefill_attention_int8.launches += 1
    paged_prefill_attention_int8.tc_launches += tc
    return out


paged_prefill_attention_int8.launches = 0
paged_prefill_attention_int8.tc_launches = 0


def check_block_table_bounds(
    block_tables,
    lengths,
    num_pages: int,
    page_size: int,
    trash_page: int = 0,
) -> None:
    """Host-side static bounds check of a decode call's block tables.

    The kernels read ``bt[b, j]`` only for pages the length covers and
    trap on an id outside the pool, but a trash entry inside a row's
    covered range means a live token's KV was never given a real page,
    and the engine's scatter-write would land out of bounds on a bad id.
    This check runs on the host arrays immediately before the kernel
    (under ``REPRO_SANITIZE``/``sanitize=True``) and in unit tests with
    adversarial tables.

    Parameters
    ----------
    block_tables : array_like, shape (B, pages_per_seq)
        Physical page ids per row (``trash_page`` marks padding).
    lengths : array_like, shape (B,)
        Valid tokens per row *excluding* the token being decoded (the
        engine's convention: the incoming token writes at position
        ``lengths[b]``); 0 marks a padding row.
    num_pages : int
        The allocator's pool size.
    page_size : int
        Tokens per page.
    trash_page : int, optional
        The reserved padding page id.

    Raises
    ------
    ValueError
        Naming the offending row/entry on any out-of-range index or
        any trash entry within a live row's covered page range.
    """
    bt = np.asarray(block_tables)
    lens = np.asarray(lengths)
    if bt.ndim != 2 or lens.shape != (bt.shape[0],):
        raise ValueError(
            f"shape mismatch: block_tables {bt.shape} vs lengths {lens.shape}"
        )
    bad = (bt < 0) | (bt >= num_pages)
    if bad.any():
        b, j = map(int, np.argwhere(bad)[0])
        raise ValueError(
            f"block-table entry out of pool bounds: bt[{b}, {j}] = "
            f"{int(bt[b, j])} not in [0, {num_pages})"
        )
    # a live row writes at position lengths[b]: pages 0..lengths[b]//ps
    # inclusive must be real pages
    cov = np.where(lens > 0, lens // page_size + 1, 0)
    if (cov > bt.shape[1]).any():
        b = int(np.argmax(cov > bt.shape[1]))
        raise ValueError(
            f"row {b} needs {int(cov[b])} pages for length {int(lens[b])} "
            f"but the block table holds only {bt.shape[1]}"
        )
    pos = np.arange(bt.shape[1])[None, :]
    covered_trash = (pos < cov[:, None]) & (bt == trash_page)
    if covered_trash.any():
        b, j = map(int, np.argwhere(covered_trash)[0])
        raise ValueError(
            f"trash page inside covered range: bt[{b}, {j}] is the trash "
            f"page but row {b} has length {int(lens[b])} "
            f"(covers {int(cov[b])} pages)"
        )


def check_scale_pool_finite(
    k_scales,
    v_scales,
    block_tables,
    lengths,
    page_size: int,
) -> None:
    """Host-side check that quantized pages' scales are finite and positive.

    A corrupted scale entry (NaN/inf/non-positive) inside a live row's
    covered range would poison every logit that touches the page — and
    unlike garbage K/V *values* (masked to softmax weight 0), a bad
    scale multiplies *valid* dequantized history.

    Parameters
    ----------
    k_scales, v_scales : array_like, shape (P, page_size, K)
        Per-page scale pools (float32).
    block_tables : array_like, shape (B, pages_per_seq)
        Physical page ids per row.
    lengths : array_like, shape (B,)
        Valid tokens per row *excluding* the token being decoded.
    page_size : int
        Tokens per page.

    Raises
    ------
    ValueError
        Naming the offending (row, page, slot) on the first bad scale
        covering a live token.
    """
    bt = np.asarray(block_tables)
    lens = np.asarray(lengths)
    for name, scales in (("k_scales", k_scales), ("v_scales", v_scales)):
        sc = np.asarray(scales)
        bad = ~np.isfinite(sc) | (sc <= 0)
        if not bad.any():
            continue
        # bad entries only matter where a live token's KV lives
        for b in range(bt.shape[0]):
            n = int(lens[b])
            for t in range(n):
                page, slot = int(bt[b, t // page_size]), t % page_size
                if bad[page, slot].any():
                    kh = int(np.argmax(bad[page, slot]))
                    raise ValueError(
                        f"{name}[{page}, {slot}, {kh}] = "
                        f"{float(sc[page, slot, kh])!r} covers live token "
                        f"{t} of row {b}: scales must be finite and > 0"
                    )
