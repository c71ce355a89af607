"""Which body serves a kernel call, decided on the host, without a card.

The flash and paged-prefill wrappers choose between a bf16 tensor-core
body and the f32 CUDA-core body by a pure-Python predicate on shapes,
strides, dtypes and ``data_ptr() % 16``; the paged prefill also splits a
chunk's context over a number of CTAs chosen on the host.  The two decode
wrappers choose their split-context body the same way and split each
row's context by shapes alone.  All are held here on plain tuples.  The last tests hold that :mod:`repro_torch.kernels.ops`
sends a CPU tensor to :mod:`repro_torch.kernels.ref` and nowhere else: the
kernels' library is made to raise if anything reaches for it.

The trainer's routes too: ``ops.needs_grad`` (whether a call takes the
autograd functions ``_FlashAttention`` / ``_RMSNorm``), the head dims the
flash backward kernel takes and which of its two bodies serves a call,
the RMSNorm backward's row split and register slots, and the raise of
every kernel wrapper called directly with an input that requires grad
(its output would carry no gradient).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as R
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssm_scan as SS
from repro_torch.kernels.flash_attention import uses_tensor_cores
from repro_torch.kernels.paged_attention import prefill_splits, prefill_uses_tensor_cores

BF16, F32 = torch.bfloat16, torch.float32


def _contig(shape):
    return tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))


def _flash(q_shape, k_shape, v_shape, dtype=BF16, strides=None, misalign=(0, 0, 0)):
    shapes = (q_shape, k_shape, v_shape)
    return uses_tensor_cores(dtype, shapes, strides or tuple(map(_contig, shapes)), misalign)


# (q, k, v shapes, dtype, expected): the main path's widths and the rest
FLASH_SHAPES = [
    ((1, 386, 32, 64), (1, 386, 32, 64), (1, 386, 32, 64), BF16, True),     # stablelm-1.6b
    ((1, 512, 64, 128), (1, 512, 8, 128), (1, 512, 8, 128), BF16, True),    # Jamba-1.5-Large
    ((2, 97, 48, 128), (2, 97, 8, 128), (2, 97, 8, 128), BF16, True),       # internlm2-20b
    ((1, 9, 4, 16), (1, 9, 4, 16), (1, 9, 4, 16), BF16, True),              # smoke widths
    ((1, 386, 32, 64), (1, 386, 32, 64), (1, 386, 32, 64), F32, False),     # f32: exact tokens
    ((1, 70, 16, 192), (1, 70, 16, 192), (1, 70, 16, 128), BF16, True),     # MLA 192 / 128
    ((2, 100, 16, 192), (2, 100, 4, 192), (2, 100, 4, 128), BF16, True),    # MLA, GQA
    ((1, 70, 16, 192), (1, 70, 16, 192), (1, 70, 16, 128), F32, False),     # MLA in f32
    ((2, 37, 4, 24), (2, 37, 4, 24), (2, 37, 4, 16), BF16, False),          # MLA smoke 24 / 16
    ((1, 70, 16, 128), (1, 70, 16, 128), (1, 70, 16, 192), BF16, False),    # 128 / 192
    ((1, 70, 8, 256), (1, 70, 8, 256), (1, 70, 8, 256), BF16, False),       # hd 256
    ((1, 70, 8, 96), (1, 70, 8, 96), (1, 70, 8, 96), BF16, False),          # hd 96
    ((1, 70, 8, 64), (1, 70, 8, 64), (1, 70, 8, 128), BF16, False),         # hd != hd_v
    ((1, 70, 8, 64), (1, 70, 8, 64), (1, 70, 8, 64), torch.float16, False),
]


@pytest.mark.parametrize("q,k,v,dtype,want", FLASH_SHAPES)
def test_flash_route_by_dtype_and_head_dim(q, k, v, dtype, want):
    assert _flash(q, k, v, dtype) is want


def test_flash_route_takes_transposed_views_with_aligned_rows():
    """(B, H, S, hd) buffers seen as (B, S, H, hd): strides are multiples of
    8 elements and the inner stride is 1, so rows stay 16-byte aligned."""
    B, S, H, hd = 2, 150, 12, 64
    st = (H * S * hd, hd, S * hd, 1)
    assert _flash((B, S, H, hd), (B, S, 2, hd), (B, S, 2, hd),
                  strides=(st, (2 * S * hd, hd, S * hd, 1), (2 * S * hd, hd, S * hd, 1)))


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_route_refuses_misaligned_or_strided_rows(which):
    shape = (1, 70, 4, 64)
    good = _contig(shape)
    # a data pointer off the 16-byte grid
    mis = [0, 0, 0]
    mis[which] = 2
    assert not _flash(shape, shape, shape, misalign=tuple(mis))
    # rows 65 elements apart (a slice of a wider buffer): 130 bytes
    strides = [good] * 3
    strides[which] = (70 * 4 * 65, 4 * 65, 65, 1)
    assert not _flash(shape, shape, shape, strides=tuple(strides))
    # an inner stride of 2
    strides = [good] * 3
    strides[which] = (70 * 4 * 128, 4 * 128, 128, 2)
    assert not _flash(shape, shape, shape, strides=tuple(strides))


MLA = ((1, 70, 16, 192), (1, 70, 16, 192), (1, 70, 16, 128))


def test_flash_route_takes_mla_transposed_views_with_aligned_rows():
    """(B, H, S, d) buffers at MLA's 192 / 128 seen as (B, S, H, d): rows
    of 384 and 256 bytes, inner stride 1."""
    (B, S, H, hd), _, (_, _, _, hd_v) = MLA
    qk = (H * S * hd, hd, S * hd, 1)
    assert _flash(*MLA, strides=(qk, qk, (H * S * hd_v, hd_v, S * hd_v, 1)))


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_route_refuses_mla_misaligned_or_strided_rows(which):
    """MLA's 192 / 128 off the 16-byte grid, with rows a slice of a wider
    buffer (one element wider than the head dim), an inner stride of 2, or
    the head dim transposed with the heads ((B, S, d, heads) seen as (B, S,
    heads, d): inner stride 16) takes the CUDA-core body."""
    good = tuple(map(_contig, MLA))
    assert _flash(*MLA)
    mis = [0, 0, 0]
    mis[which] = 2
    assert not _flash(*MLA, misalign=tuple(mis))
    d = MLA[which][-1]
    for bad in ((70 * 16 * (d + 1), 16 * (d + 1), d + 1, 1),
                (70 * 16 * 2 * d, 16 * 2 * d, 2 * d, 2),
                (70 * 16 * d, 16 * d, 1, 16)):
        strides = list(good)
        strides[which] = bad
        assert not _flash(*MLA, strides=tuple(strides))


def test_flash_route_ignores_the_stride_of_a_size_one_dim():
    shape = (1, 70, 4, 64)
    odd = (3, 4 * 64, 64, 1)   # the batch dim is never stepped
    assert _flash(shape, shape, shape, strides=(odd, odd, odd))


def _pools(P=20, ps=16, K=8, hd=128):
    return (P, ps, K, hd)


def _prefill(q_dtype, page_dtype, q_shape=(64, 48, 128), pool=None, strides=None,
             misalign=(0, 0, 0)):
    pool = pool or _pools(hd=q_shape[-1])
    shapes = (q_shape, pool, pool)
    return prefill_uses_tensor_cores(q_dtype, page_dtype, shapes,
                                     strides or tuple(map(_contig, shapes)), misalign)


# (q dtype, page dtype, q shape, page size, expected)
PREFILL_CASES = [
    (BF16, BF16, (64, 48, 128), 16, True),      # internlm2-20b, bf16 pages
    (BF16, torch.int8, (64, 48, 128), 16, True),  # int8 pages
    (BF16, BF16, (64, 32, 64), 16, True),       # stablelm-1.6b
    (BF16, torch.int8, (64, 32, 64), 16, True),
    (BF16, BF16, (8, 4, 16), 8, True),          # smoke widths, page 8
    (BF16, torch.int8, (8, 4, 16), 8, True),
    (F32, F32, (64, 32, 64), 16, False),        # f32: exact tokens
    (F32, torch.int8, (64, 32, 64), 16, False),
    (BF16, BF16, (64, 8, 256), 16, False),      # hd 256
    (BF16, BF16, (64, 32, 64), 12, False),      # a page size that is not a power of two
    (BF16, F32, (64, 32, 64), 16, False),
]


@pytest.mark.parametrize("q_dtype,page_dtype,q_shape,ps,want", PREFILL_CASES)
def test_prefill_route_by_dtype_head_dim_and_page_size(q_dtype, page_dtype, q_shape, ps, want):
    pool = (20, ps, q_shape[1] // (6 if q_shape[1] == 48 else 1), q_shape[2])
    assert _prefill(q_dtype, page_dtype, q_shape, pool) is want


def test_prefill_route_takes_a_layer_view_of_stacked_pools():
    """pool[i] of a (layers, P, ps, K, hd) stack: a page-sized stride and an
    offset of whole layers keep every row 16-byte aligned."""
    pool = (20, 16, 8, 128)
    st = _contig(pool)
    assert _prefill(BF16, BF16, pool=pool, strides=(_contig((64, 48, 128)), st, st))
    assert _prefill(BF16, torch.int8, pool=pool, strides=(_contig((64, 48, 128)), st, st))


def test_prefill_route_refuses_misaligned_page_rows():
    pool = (20, 16, 8, 72)
    q = (64, 48, 72)
    assert not _prefill(BF16, torch.int8, q_shape=q, pool=pool)   # 72 not a TC width
    pool = (20, 16, 8, 64)
    q = (64, 48, 64)
    rows_72 = (16 * 8 * 72, 8 * 72, 72, 1)     # int8 rows 72 bytes apart
    assert not _prefill(BF16, torch.int8, q_shape=q, pool=pool,
                        strides=(_contig(q), rows_72, rows_72))
    assert not _prefill(BF16, BF16, q_shape=q, pool=pool, misalign=(0, 0, 8))
    assert not _prefill(BF16, BF16, q_shape=q, pool=pool, misalign=(4, 0, 0))


@pytest.mark.parametrize("shape,strides,misalign,itemsize,want", [
    ((4, 8), (8, 1), 0, 2, True),
    ((4, 8), (8, 1), 2, 2, False),
    ((4, 8), (9, 1), 0, 2, False),
    ((4, 8), (16, 2), 0, 2, False),
    ((4, 16), (16, 1), 0, 1, True),
    ((4, 16), (24, 1), 0, 1, False),
    ((1, 8), (5, 1), 0, 2, True),
])
def test_rows_16b(shape, strides, misalign, itemsize, want):
    assert _build.rows_16b(shape, strides, misalign, itemsize) is want


@pytest.mark.parametrize("K,rows,n_tiles,sms,want", [
    (32, 64, 8, 132, 8),     # stablelm-1.6b, C = 64 at past = 448: 256 CTAs
    (8, 384, 8, 132, 4),     # internlm2-20b, C = 64 at past = 448: 192 CTAs
    (32, 64, 1, 132, 1),     # one key tile: nothing to split
    (32, 64, 3, 132, 2),     # never more splits than tiles
    (8, 48, 100, 132, 8),    # at most one cluster of 8
    (48, 6 * 64, 8, 132, 1),  # the row blocks alone fill the card
    (1, 64, 16, 4, 4),
])
def test_prefill_splits(K, rows, n_tiles, sms, want):
    splits = prefill_splits(K, rows, n_tiles, sms)
    assert splits == want
    assert splits & (splits - 1) == 0 and splits <= _build.TC_MAX_SPLITS


# ---------------------------------------------------------------------------
# the split-context decode bodies: which calls they serve, how many splits
# ---------------------------------------------------------------------------
I8 = torch.int8


def _slot_route(q_dtype, cache_dtype, q, k, v, strides=None, misalign=(0, 0, 0)):
    shapes = (q, k, v)
    return DA.decode_uses_split_body(q_dtype, cache_dtype, shapes,
                                     strides or tuple(map(_contig, shapes)), misalign)


def _paged_route(q_dtype, page_dtype, q, pool, strides=None, misalign=(0, 0, 0)):
    shapes = (q, pool, pool)
    return PA.decode_uses_split_body(q_dtype, page_dtype, shapes,
                                     strides or tuple(map(_contig, shapes)), misalign)


# (q dtype, cache dtype, q, k, v shapes, expected): the slot engine's
# widths (stablelm-1.6b, internlm2-20b, Jamba-1.5-Large, the smoke configs)
SLOT_SPLIT_CASES = [
    (BF16, BF16, (4, 32, 64), (4, 1024, 32, 64), (4, 1024, 32, 64), True),
    (F32, F32, (4, 32, 64), (4, 1024, 32, 64), (4, 1024, 32, 64), True),
    (BF16, BF16, (4, 64, 128), (4, 1024, 8, 128), (4, 1024, 8, 128), True),
    (F32, F32, (4, 64, 128), (4, 1024, 8, 128), (4, 1024, 8, 128), True),
    (BF16, BF16, (8, 48, 128), (8, 512, 8, 128), (8, 512, 8, 128), True),
    (BF16, BF16, (3, 6, 16), (3, 64, 2, 16), (3, 64, 2, 16), True),
    (F32, F32, (3, 4, 16), (3, 64, 4, 16), (3, 64, 4, 16), True),
    (BF16, BF16, (2, 16, 192), (2, 64, 16, 192), (2, 64, 16, 128), False),   # MLA 192 / 128
    (BF16, BF16, (2, 8, 256), (2, 64, 8, 256), (2, 64, 8, 256), False),      # hd 256
    (BF16, BF16, (2, 8, 96), (2, 64, 8, 96), (2, 64, 8, 96), False),         # hd 96
    (BF16, BF16, (2, 8, 64), (2, 64, 8, 64), (2, 64, 8, 128), False),        # hd != hd_v
    (torch.float16, torch.float16, (2, 8, 64), (2, 64, 8, 64), (2, 64, 8, 64), False),
    (F32, BF16, (2, 8, 64), (2, 64, 8, 64), (2, 64, 8, 64), False),          # mixed dtypes
]


@pytest.mark.parametrize("q_dtype,cache_dtype,q,k,v,want", SLOT_SPLIT_CASES)
def test_slot_decode_route_by_dtype_and_head_dim(q_dtype, cache_dtype, q, k, v, want):
    assert _slot_route(q_dtype, cache_dtype, q, k, v) is want


# (q dtype, page dtype, q shape, pool shape, expected)
PAGED_SPLIT_CASES = [
    (BF16, BF16, (8, 32, 64), (515, 16, 32, 64), True),       # stablelm-1.6b
    (F32, F32, (8, 32, 64), (515, 16, 32, 64), True),
    (BF16, I8, (8, 32, 64), (515, 16, 32, 64), True),          # int8 pages
    (F32, I8, (8, 32, 64), (515, 16, 32, 64), True),
    (BF16, BF16, (8, 48, 128), (515, 16, 8, 128), True),      # internlm2-20b
    (BF16, I8, (8, 48, 128), (515, 16, 8, 128), True),
    (F32, I8, (8, 48, 128), (515, 16, 8, 128), True),
    (BF16, BF16, (4, 6, 16), (33, 8, 2, 16), True),           # smoke widths, page 8
    (BF16, I8, (4, 4, 16), (33, 8, 4, 16), True),
    (BF16, BF16, (4, 32, 64), (33, 12, 32, 64), True),        # any page size
    (BF16, BF16, (4, 8, 256), (33, 16, 8, 256), False),       # hd 256
    (BF16, I8, (4, 8, 256), (33, 16, 8, 256), False),
    (BF16, BF16, (4, 8, 96), (33, 16, 8, 96), False),         # hd 96
    (BF16, F32, (4, 8, 64), (33, 16, 8, 64), False),          # pages of another float dtype
    (torch.float16, torch.float16, (4, 8, 64), (33, 16, 8, 64), False),
]


@pytest.mark.parametrize("q_dtype,page_dtype,q,pool,want", PAGED_SPLIT_CASES)
def test_paged_decode_route_by_dtype_and_head_dim(q_dtype, page_dtype, q, pool, want):
    assert _paged_route(q_dtype, page_dtype, q, pool) is want


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_decode_routes_take_layer_views_of_stacked_caches_and_pools(dtype):
    """cache[i] of a (layers, B, S, K, hd) stack, pool[i] of a (layers, P,
    ps, K, hd) stack and a slot cache of every other kv head: whole rows
    apart, offsets of whole rows, so every row stays 16-byte aligned."""
    B, S, K, hd = 4, 1024, 8, 128
    k = (B, S, K, hd)
    st = _contig(k)
    assert _slot_route(dtype, dtype, (B, 64, hd), k, k, strides=((64 * hd, hd, 1), st, st))
    every_other = (S * 2 * K * hd, 2 * K * hd, 2 * hd, 1)
    assert _slot_route(dtype, dtype, (B, 64, hd), k, k,
                       strides=((64 * hd, hd, 1), every_other, every_other))
    pool = (20, 16, 8, 128)
    pst = _contig(pool)
    for page_dtype in (dtype, I8):
        assert _paged_route(dtype, page_dtype, (4, 48, 128), pool,
                            strides=(_contig((4, 48, 128)), pst, pst))


@pytest.mark.parametrize("which", [1, 2])
def test_decode_routes_refuse_misaligned_or_strided_rows(which):
    q, k = (2, 8, 64), (2, 70, 4, 64)
    good = (_contig(q), _contig(k), _contig(k))
    mis = [0, 0, 0]
    mis[which] = 2
    assert not _slot_route(BF16, BF16, q, k, k, misalign=tuple(mis))
    assert not _paged_route(BF16, BF16, q, k, misalign=tuple(mis))
    mis[which] = 8                       # int8 rows must start on 16 bytes too
    assert not _paged_route(BF16, I8, q, k, misalign=tuple(mis))
    strides = list(good)
    strides[which] = (70 * 4 * 65, 4 * 65, 65, 1)      # rows 65 elements apart
    assert not _slot_route(BF16, BF16, q, k, k, strides=tuple(strides))
    assert not _paged_route(BF16, BF16, q, k, strides=tuple(strides))
    strides[which] = (70 * 4 * 128, 4 * 128, 128, 2)   # an inner stride of 2
    assert not _slot_route(BF16, BF16, q, k, k, strides=tuple(strides))
    assert not _paged_route(BF16, I8, q, k, strides=tuple(strides))
    strides[which] = (70 * 4 * 72, 4 * 72, 72, 1)      # int8 rows 72 bytes apart
    assert not _paged_route(BF16, I8, q, k, strides=tuple(strides))


def test_decode_routes_ignore_q_layout():
    """q is read element by element: a misaligned or strided q still takes
    the split body."""
    q, k = (2, 8, 64), (2, 70, 4, 64)
    st = (_contig(q), _contig(k), _contig(k))
    odd = ((8 * 65, 65, 1), st[1], st[2])
    assert _slot_route(BF16, BF16, q, k, k, strides=odd, misalign=(2, 0, 0))
    assert _paged_route(F32, I8, q, k, strides=odd, misalign=(4, 0, 0))


# (B, K, query group, q dtype, capacity, SMs, expected splits) at the main
# path's shapes
DECODE_SPLIT_COUNTS = [
    (4, 32, 1, BF16, 1024, 132, 1),   # stablelm-1.6b slot decode, the testbed's 4 slots
    (8, 32, 1, BF16, 1024, 132, 1),   # stablelm-1.6b paged decode, 8 rows of 64 pages
    (8, 8, 6, BF16, 1024, 132, 1),    # internlm2-20b paged decode: one 16-row group
    (4, 8, 8, BF16, 1024, 132, 2),    # Jamba-1.5-Large slot decode at B = 4
    (4, 8, 8, F32, 1024, 132, 1),     # ... in f32: two CUDA-core row groups of 4
    (1, 32, 1, BF16, 1024, 132, 2),   # one request
    (1, 8, 6, BF16, 1024, 132, 8),
    (4, 32, 1, BF16, 16, 132, 1),     # a capacity below one tile: nothing to split
    (1, 8, 1, BF16, 32, 132, 1),      # one tile
    (1, 8, 1, BF16, 64, 132, 2),      # never more splits than tiles
    (2, 2, 3, BF16, 64, 132, 2),      # the smoke configs' max_len 64
    (1, 1, 1, F32, 4096, 132, 8),     # at most one cluster of 8
]


@pytest.mark.parametrize("B,K,g,dtype,cap,sms,want", DECODE_SPLIT_COUNTS)
def test_decode_splits(B, K, g, dtype, cap, sms, want):
    groups = -(-g // _build.decode_group_rows(g, dtype))
    splits = _build.decode_splits(B, K, cap, sms, groups)
    assert splits == want
    assert splits & (splits - 1) == 0 and splits <= _build.SPLIT_MAX_SPLITS
    # it reaches a CTA for every SPLIT_SMS_PER_CTA SMs, or stops at the
    # cluster's size or at the tiles of the capacity
    tiles = -(-cap // _build.SPLIT_TILE)
    assert (B * K * groups * splits * _build.SPLIT_SMS_PER_CTA >= sms
            or splits == _build.SPLIT_MAX_SPLITS or 2 * splits > tiles)


@pytest.mark.parametrize("g,dtype,want", [
    (1, BF16, 1), (2, BF16, 1), (2, F32, 1),
    (3, BF16, 1), (6, BF16, 1), (8, BF16, 1), (16, BF16, 1), (40, BF16, 3),
    (3, F32, 1), (6, F32, 2), (8, F32, 2), (40, F32, 10),
])
def test_decode_row_groups(g, dtype, want):
    """bf16 groups above 2 take the tensor-core form, 16 rows a CTA; f32
    groups take CUDA-core CTAs of 4 rows; a group of 1 or 2 one CTA of its
    size.  Only those four sizes have a form in the launcher."""
    rows = _build.decode_group_rows(g, dtype)
    assert -(-g // rows) == want
    assert rows == (g if g <= 2 else 16 if dtype == BF16 else 4)


@pytest.mark.parametrize("B,K,g,dtype,cap,sms,want", DECODE_SPLIT_COUNTS)
def test_slot_wrapper_uses_the_same_split_rule(monkeypatch, B, K, g, dtype, cap, sms, want):
    """Both decode wrappers take their launch from ``_build.decode_launch``
    alone: neither module keeps a rule of its own."""
    for mod in (DA, PA):
        assert not hasattr(mod, "decode_splits") and not hasattr(mod, "decode_row_groups")
    monkeypatch.setattr(_build, "sm_count", lambda index: sms)
    assert _build.decode_launch(B, K * g, K, cap, dtype, 0) == (
        _build.decode_group_rows(g, dtype), want)


# ---------------------------------------------------------------------------
# the RMSNorm and selective-scan launch shapes
# ---------------------------------------------------------------------------
def _values_per_warp(dtype):
    return 32 * _build.RMSNORM_SLOTS * (16 // (4 if dtype == F32 else 2))


# (d, dtype, expected warps a row): the main path's widths (stablelm-1.6b's
# 2048, Jamba-1.5-Large's 8192), the smoke configs' and rows wider than 16
# warps' slots hold
RMSNORM_WARP_CASES = [
    (2048, BF16, 1),
    (8192, BF16, 4),
    (2048, F32, 2),
    (8192, F32, 8),
    (64, BF16, 1),
    (100, F32, 1),
    (2049, BF16, 2),
    (32768, BF16, 16),
    (40001, BF16, 16),
    (20000, F32, 16),
]


@pytest.mark.parametrize("d,dtype,want", RMSNORM_WARP_CASES)
def test_rmsnorm_warps(d, dtype, want):
    warps = _build.rmsnorm_warps(d, dtype)
    assert warps == want and warps in _build.RMSNORM_WARPS


@pytest.mark.parametrize("d", [1, 63, 100, 1024, 1025, 2048, 2049, 4096, 8192, 16384, 16385,
                               32768, 32769, 65536])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_rmsnorm_warps_are_the_fewest_whose_slots_hold_the_row(d, dtype):
    """A form the launcher has: the fewest warps whose slots take all d
    values, or the most (16) where none do and the rest is streamed."""
    warps = _build.rmsnorm_warps(d, dtype)
    assert warps in _build.RMSNORM_WARPS
    assert warps * _values_per_warp(dtype) >= d or warps == _build.RMSNORM_WARPS[-1]
    assert warps == 1 or (warps // 2) * _values_per_warp(dtype) < d


@pytest.mark.parametrize("d,dtype", [(64, torch.float16), (0, BF16), (-1, F32),
                                     (64, torch.int8)])
def test_rmsnorm_warps_refuse_what_has_no_form(d, dtype):
    with pytest.raises(ValueError, match="rmsnorm_warps"):
        _build.rmsnorm_warps(d, dtype)


@pytest.mark.parametrize("N,want", [(1, 1), (3, 1), (4, 1), (5, 2), (8, 2), (9, 4), (13, 4),
                                    (16, 4)])
def test_ssm_scan_lanes(N, want):
    """The fewest lanes whose states hold N: 4 lanes of 4 at Jamba's N = 16
    (coalesced 16-byte state accesses), one lane at N <= 4."""
    lanes = _build.ssm_scan_lanes(N)
    assert lanes == want and lanes in _build.SSM_LANES
    assert lanes * _build.SSM_STATES_PER_LANE >= N
    fewer = [L for L in _build.SSM_LANES if L < lanes]
    assert all(L * _build.SSM_STATES_PER_LANE < N for L in fewer)


def test_ssm_scan_lane_forms_hold_up_to_the_largest_state():
    assert max(_build.SSM_LANES) * _build.SSM_STATES_PER_LANE == _build.SSM_MAX_STATE


@pytest.mark.parametrize("N", [0, 17, 64, -1])
def test_ssm_scan_lanes_refuse_what_has_no_form(N):
    with pytest.raises(ValueError, match="ssm_scan_lanes"):
        _build.ssm_scan_lanes(N)


# ---------------------------------------------------------------------------
# a CPU tensor never reaches the kernels
# ---------------------------------------------------------------------------
def _no_library(*args, **kwargs):
    raise AssertionError("a CPU tensor reached the CUDA kernels' library")


@pytest.fixture
def no_kernels(monkeypatch):
    monkeypatch.setattr(_build, "library", _no_library)
    monkeypatch.setattr(_build, "entry", _no_library)
    before = (ops.launch_counts(), ops.tc_launch_counts(), ops.split_launch_counts())
    yield
    assert (ops.launch_counts(), ops.tc_launch_counts(), ops.split_launch_counts()) == before


def _t(rng, shape, dtype):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)


def _paged_inputs(rng, dtype, q8):
    P, ps, K, hd = 9, 8, 2, 16
    kp, vp = _t(rng, (P, ps, K, hd), F32), _t(rng, (P, ps, K, hd), F32)
    scales = {}
    if q8:
        kp, ks = ops.quantize_kv(kp)
        vp, vs = ops.quantize_kv(vp)
        scales = {"k_scales": ks, "v_scales": vs}
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    return kp, vp, scales


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("causal", [True, False])
def test_ops_attention_sends_cpu_tensors_to_the_plain_version(no_kernels, dtype, causal):
    rng = np.random.default_rng(80)
    q, k, v = _t(rng, (1, 11, 6, 16), dtype), _t(rng, (1, 11, 2, 16), dtype), \
        _t(rng, (1, 11, 2, 16), dtype)
    assert torch.equal(ops.attention(q, k, v, causal=causal),
                       R.attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_ops_decode_attention_sends_cpu_tensors_to_the_plain_version(no_kernels, dtype):
    rng = np.random.default_rng(81)
    q, kc, vc = _t(rng, (3, 6, 16), dtype), _t(rng, (3, 20, 2, 16), dtype), \
        _t(rng, (3, 20, 2, 16), dtype)
    ln = torch.tensor([1, 7, 20], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q, kc, vc, ln), R.decode_attention_ref(q, kc, vc, ln))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("q8", [False, True])
def test_ops_paged_attention_sends_cpu_tensors_to_the_plain_versions(no_kernels, dtype, q8):
    rng = np.random.default_rng(82)
    kp, vp, scales = _paged_inputs(rng, dtype, q8)
    bt = torch.tensor([[3, 5, 1], [2, 7, 8]], dtype=torch.int32)
    ln = torch.tensor([17, 9], dtype=torch.int32)
    q = _t(rng, (2, 4, 16), dtype)
    assert torch.equal(ops.paged_decode_attention(q, kp, vp, bt, ln, **scales),
                       R.paged_decode_attention_ref(q, kp, vp, bt, ln, **scales))
    qc = _t(rng, (7, 4, 16), dtype)
    assert torch.equal(ops.paged_prefill_attention(qc, kp, vp, bt[0], 10, **scales),
                       R.paged_prefill_attention_ref(qc, kp, vp, bt[0], 10, **scales))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_ops_rmsnorm_and_scan_send_cpu_tensors_to_the_plain_versions(no_kernels, dtype):
    rng = np.random.default_rng(83)
    x, g = _t(rng, (5, 32), dtype), _t(rng, (32,), dtype)
    assert torch.equal(ops.rmsnorm(x, g), R.rmsnorm_ref(x, g))
    B, T, D, N = 2, 5, 12, 4
    xs, dt = _t(rng, (B, T, D), dtype), _t(rng, (B, T, D), dtype).abs() * 0.1
    A = -_t(rng, (D, N), F32).abs() - 0.1
    Bm, Cm, Dk = _t(rng, (B, T, N), dtype), _t(rng, (B, T, N), dtype), _t(rng, (D,), dtype)
    y, h = ops.ssm_scan(xs, dt, A, Bm, Cm, Dk)
    yr, hr = R.ssm_scan_ref(xs, dt, A, Bm, Cm, Dk)
    assert torch.equal(y, yr) and torch.equal(h, hr)


def test_ops_cuda_route_refuses_cpu_tensors(no_kernels):
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_prefill_attention(q[0], q, q, torch.zeros(2, dtype=torch.int32), 0,
                                    impl="cuda")


# ---------------------------------------------------------------------------
# the trainer's routes: autograd functions on CUDA tensors, the raise
# ---------------------------------------------------------------------------
def test_needs_grad_is_grad_mode_and_an_input_that_requires_it():
    a, b = torch.zeros(2), torch.zeros(2, requires_grad=True)
    assert ops.needs_grad(a, b) and not ops.needs_grad(a, a) and not ops.needs_grad()
    assert ops.needs_grad(None, b) and not ops.needs_grad(None)
    with torch.no_grad():
        assert not ops.needs_grad(a, b)


@pytest.mark.parametrize("hd,hd_v,want", [
    (64, 64, True),      # stablelm-1.6b
    (128, 128, True),    # internlm2-20b, Jamba-1.5-Large
    (16, 16, True),      # the smoke configs
    (192, 128, True),    # MLA: DeepSeek-V2-Lite (tensor-core body in bf16)
    (24, 16, True),      # MLA: DeepSeek's smoke config (CUDA-core body)
    (32, 32, False), (256, 256, False), (64, 128, False), (128, 192, False), (16, 24, False),
])
def test_flash_backward_head_dims(hd, hd_v, want):
    assert FA.backward_supported(hd, hd_v) is want


def _flash_bwd(q_shape, k_shape, v_shape, dtype=BF16, strides=None, misalign=(0,) * 5):
    """The backward's route for q, k, v and o, do shaped as q (v's head dim)."""
    o_shape = q_shape[:-1] + v_shape[-1:]
    shapes = (q_shape, k_shape, v_shape, o_shape, o_shape)
    return FA.backward_uses_tensor_cores(dtype, shapes, strides or tuple(map(_contig, shapes)),
                                         misalign)


@pytest.mark.parametrize("q,k,v,dtype,want", FLASH_SHAPES)
def test_flash_backward_route_by_dtype_and_head_dim(q, k, v, dtype, want):
    """The backward's tensor-core body takes what the forward's takes:
    bf16 at TC_HEAD_DIM_PAIRS (the training widths: stablelm's 64,
    internlm2's and Jamba's 128, the smoke configs' 16, DeepSeek-V2-Lite's
    MLA 192 / 128, with GQA too), never f32 nor MLA's smoke 24 / 16."""
    assert _flash_bwd(q, k, v, dtype) is want


def test_flash_backward_route_takes_transposed_views_with_aligned_rows():
    B, S, H, hd = 2, 150, 12, 64
    st = (H * S * hd, hd, S * hd, 1)
    kst = (2 * S * hd, hd, S * hd, 1)
    assert _flash_bwd((B, S, H, hd), (B, S, 2, hd), (B, S, 2, hd),
                      strides=(st, kst, kst, st, st))


def test_flash_backward_route_takes_mla_transposed_views_with_aligned_rows():
    (B, S, H, hd), _, (_, _, _, hd_v) = MLA
    qk = (H * S * hd, hd, S * hd, 1)
    vo = (H * S * hd_v, hd_v, S * hd_v, 1)
    assert _flash_bwd(*MLA, strides=(qk, qk, vo, vo, vo))


@pytest.mark.parametrize("which", [0, 1, 2, 3, 4])
def test_flash_backward_route_refuses_mla_misaligned_or_strided_rows(which):
    """Any one of q, k, v, o and do at MLA's 192 / 128 off the 16-byte grid,
    with rows one element wider than the head dim, an inner stride of 2 or
    the head dim transposed with the heads, takes the CUDA-core body."""
    shapes = MLA + (MLA[0][:-1] + MLA[2][-1:],) * 2
    good = tuple(map(_contig, shapes))
    assert _flash_bwd(*MLA)
    mis = [0] * 5
    mis[which] = 2
    assert not _flash_bwd(*MLA, misalign=tuple(mis))
    d = shapes[which][-1]
    for bad in ((70 * 16 * (d + 1), 16 * (d + 1), d + 1, 1),
                (70 * 16 * 2 * d, 16 * 2 * d, 2 * d, 2),
                (70 * 16 * d, 16 * d, 1, 16)):
        strides = list(good)
        strides[which] = bad
        assert not _flash_bwd(*MLA, strides=tuple(strides))


@pytest.mark.parametrize("which", [0, 1, 2, 3, 4])
def test_flash_backward_route_refuses_misaligned_or_strided_rows(which):
    """Any one of q, k, v, o and do off the 16-byte grid, with rows 65
    elements apart or an inner stride of 2 sends the call to the CUDA-core
    body."""
    shape = (1, 70, 4, 64)
    good = _contig(shape)
    assert _flash_bwd(shape, shape, shape)
    mis = [0] * 5
    mis[which] = 2
    assert not _flash_bwd(shape, shape, shape, misalign=tuple(mis))
    strides = [good] * 5
    strides[which] = (70 * 4 * 65, 4 * 65, 65, 1)
    assert not _flash_bwd(shape, shape, shape, strides=tuple(strides))
    strides = [good] * 5
    strides[which] = (70 * 4 * 128, 4 * 128, 128, 2)
    assert not _flash_bwd(shape, shape, shape, strides=tuple(strides))


@pytest.mark.parametrize("d,dtype,want", [
    (2048, BF16, 1),     # stablelm-1.6b training: one 16-byte vector a thread
    (2048, F32, 1 * 2),  # the same width in f32: two
    (8192, BF16, 4),     # Jamba, internlm2's 6144 too
    (6144, BF16, 4), (4096, BF16, 2), (100, BF16, 1), (1, F32, 1),
    (28672, BF16, 4), (28672, F32, 4),   # wider than the slots: the rest streams
])
def test_rmsnorm_bwd_slots(d, dtype, want):
    assert _build.rmsnorm_bwd_slots(d, dtype) == want


@pytest.mark.parametrize("d,dtype", [(0, BF16), (64, torch.float16)])
def test_rmsnorm_bwd_slots_refuse_what_has_no_form(d, dtype):
    with pytest.raises(ValueError, match="no form"):
        _build.rmsnorm_bwd_slots(d, dtype)


@pytest.mark.parametrize("rows,sms,ctas_per_sm,want", [
    (4096, 132, 2, 16),   # stablelm-1.6b training, batch 4 x 1024: 256 CTAs, two a SM
    (512, 132, 1, 4),     # Jamba's d = 8192 (four slots): 128 CTAs, one a SM
    (386, 132, 2, 2),     # a 386-token admission's rows: 193 CTAs
    (386, 132, 1, 3),
    (1, 132, 2, 1), (264, 132, 2, 1), (265, 132, 2, 2), (10, 4, 2, 2), (10, 4, 1, 3),
])
def test_rmsnorm_bwd_rows(rows, sms, ctas_per_sm, want):
    run = _build.rmsnorm_bwd_rows(rows, sms, ctas_per_sm)
    assert run == want
    ctas = -(-rows // run)
    assert ctas <= ctas_per_sm * sms and (ctas - 1) * run < rows


@pytest.mark.parametrize("d,itemsize,ptrs,want", [
    (2048, 2, (0, 4096, 8192, 16), True),     # stablelm's rows, every base on 16 bytes
    (2048, 4, (0, 16, 32, 48), True),
    (100, 2, (0, 0, 0, 0), False),            # 100 bf16 values: 12.5 vectors a row
    (100, 4, (0, 0, 0, 0), True),             # 100 f32 values: 25 vectors
    (2048, 2, (0, 0, 2, 0), False),           # dy one bf16 past a 16-byte base
    (2048, 2, (8, 0, 0, 0), False),
])
def test_rmsnorm_bwd_aligned(d, itemsize, ptrs, want):
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_aligned

    assert rmsnorm_bwd_aligned(d, itemsize, *ptrs) is want


def _grad_inputs():
    rng = np.random.default_rng(90)
    q = _t(rng, (1, 9, 4, 16), F32).requires_grad_()
    kv = _t(rng, (1, 9, 2, 16), F32)
    return q, kv


def _wrapper_calls(q, kv):
    """Every kernel wrapper, called directly with ``q`` (which requires grad)."""
    lens = torch.tensor([5], dtype=torch.int32)
    pool = kv[0, :8].reshape(2, 4, 2, 16)
    pq, ps = torch.zeros(2, 4, 2, dtype=torch.int8), torch.ones(2, 4, 2)
    bt = torch.tensor([[0, 1]], dtype=torch.int32)
    x = q[0, :, 0]
    return {
        "flash_attention": lambda: FA.flash_attention(q, kv, kv),
        "rmsnorm": lambda: RN.rmsnorm(x, torch.ones(16)),
        "decode_attention": lambda: DA.decode_attention(q[:, 0], kv, kv, lens),
        "paged_decode_attention": lambda: PA.paged_decode_attention(q[:, 0], pool, pool, bt,
                                                                    lens),
        "paged_decode_attention_int8": lambda: PA.paged_decode_attention_int8(
            q[:, 0], pq, pq, bt, lens, ps, ps),
        "paged_prefill_attention": lambda: PA.paged_prefill_attention(q[0], pool, pool,
                                                                      bt[0], 0),
        "paged_prefill_attention_int8": lambda: PA.paged_prefill_attention_int8(
            q[0], pq, pq, bt[0], 0, ps, ps),
        "ssm_scan": lambda: SS.ssm_scan(x[None], x[None], torch.zeros(16, 4),
                                        torch.zeros(1, 9, 4), torch.zeros(1, 9, 4),
                                        torch.zeros(16)),
    }


@pytest.mark.parametrize("name", ["flash_attention", "rmsnorm", "decode_attention",
                                  "paged_decode_attention", "paged_decode_attention_int8",
                                  "paged_prefill_attention", "paged_prefill_attention_int8",
                                  "ssm_scan"])
def test_a_wrapper_called_with_grad_raises(no_kernels, name):
    """A wrapper's output has no grad_fn, so with grad needed it raises
    (before it looks at the device); without grad it goes on to its
    device check (a CPU tensor: ValueError), as before."""
    q, kv = _grad_inputs()
    call = _wrapper_calls(q, kv)[name]
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        call()


def test_backward_wrappers_refuse_cpu_tensors(no_kernels):
    q, kv = _grad_inputs()
    q = q.detach()
    lse = torch.zeros(1, 4, 9)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bwd(q, kv, kv, q, lse, q)
    with pytest.raises(ValueError, match="CUDA"):
        RN.rmsnorm_bwd(q[0, :, 0], torch.ones(16), q[0, :, 0])
    x = q[0, :, 0][None]
    with pytest.raises(ValueError, match="CUDA"):
        SS.ssm_scan_bwd(x, x, torch.zeros(16, 4), torch.zeros(1, 9, 4), torch.zeros(1, 9, 4),
                        torch.zeros(16), torch.zeros(1, 1, 16, 4), x)


@pytest.mark.parametrize("T,want", [(1, 1), (31, 1), (32, 1), (33, 2), (1024, 32), (1025, 33)])
def test_ssm_checkpoints(T, want):
    """The scan's forward keeps the state before every SSM_CKPT_STEPS (32)
    steps: Jamba's training T = 1024 keeps 32."""
    assert _build.SSM_CKPT_STEPS == 32 and _build.ssm_checkpoints(T) == want


@pytest.mark.parametrize("source", ["ssm_scan.cu", "ssm_scan_bwd.cu"])
def test_ssm_layout_has_one_owner(source):
    """Both scan kernels take their channels a CTA and their checkpoint
    interval from ``_build``'s constants through the compiler's flags (the
    wrappers size ``states`` and the dB/dC partials from the same values),
    and neither source holds a value of its own."""
    assert f"-DREPRO_SSM_CHANNELS={_build.SSM_CHANNELS_PER_CTA}" in _build.CFLAGS
    assert f"-DREPRO_SSM_CKPT={_build.SSM_CKPT_STEPS}" in _build.CFLAGS
    text = (_build.CSRC / source).read_text()
    assert "constexpr int kChannels = REPRO_SSM_CHANNELS;" in text
    assert "constexpr int kCkpt = REPRO_SSM_CKPT;" in text


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("causal", [True, False])
def test_ops_attention_on_cpu_differentiates_the_plain_version(no_kernels, dtype, causal):
    """Autograd of the plain version (the CPU route, as JAX's) gives the
    plain backward version's gradients."""
    rng = np.random.default_rng(91)
    q = _t(rng, (2, 13, 6, 16), dtype).requires_grad_()
    k = _t(rng, (2, 13, 2, 16), dtype).requires_grad_()
    v = _t(rng, (2, 13, 2, 16), dtype).requires_grad_()
    o = ops.attention(q, k, v, causal=causal)
    assert o.grad_fn is not None and not isinstance(o.grad_fn, ops._FlashAttention)
    do = _t(rng, o.shape, dtype)
    got = torch.autograd.grad(o, (q, k, v), do)
    lse = R.attention_lse_ref(q.detach(), k.detach(), causal=causal)
    want = R.attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), lse, do,
                               causal=causal)
    tol = 3e-5 if dtype == F32 else 2e-2
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_ops_rmsnorm_on_cpu_differentiates_the_plain_version(no_kernels, dtype):
    rng = np.random.default_rng(92)
    x = _t(rng, (3, 5, 48), dtype).requires_grad_()
    g = (1 + 0.2 * _t(rng, (48,), F32)).to(dtype).requires_grad_()
    y = ops.rmsnorm(x, g)
    dy = _t(rng, y.shape, dtype)
    got = torch.autograd.grad(y, (x, g), dy)
    want = R.rmsnorm_bwd_ref(x.detach(), g.detach(), dy)
    tol = 3e-5 if dtype == F32 else 2e-2
    for a, b in zip(got, want):    # dgamma sums 15 rows: 15 roundings' worth of atol
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), atol=tol * 15, rtol=tol)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_ops_ssm_scan_on_cpu_differentiates_the_plain_version(no_kernels, dtype):
    """Autograd of the plain scan (the CPU route) gives the plain backward
    version's gradients, with and without the gradient of h_T."""
    rng = np.random.default_rng(93)
    B, T, D, N = 2, 11, 12, 8
    x = (0.5 * _t(rng, (B, T, D), F32)).to(dtype).requires_grad_()
    dt = (0.1 * _t(rng, (B, T, D), F32).abs()).to(dtype).requires_grad_()
    A = (-_t(rng, (D, N), F32).abs() - 0.1).requires_grad_()
    Bm, Cm = ((0.3 * _t(rng, (B, T, N), F32)).to(dtype).requires_grad_() for _ in range(2))
    Dk = _t(rng, (D,), dtype).requires_grad_()
    h0 = (0.2 * _t(rng, (B, D, N), F32)).requires_grad_()
    y, h = ops.ssm_scan(x, dt, A, Bm, Cm, Dk, h0=h0)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ != "_SSMScanBackward"
    dy, dhT = _t(rng, y.shape, dtype), _t(rng, h.shape, F32)
    tol = 3e-5 if dtype == F32 else 2e-2
    ins = (x, dt, A, Bm, Cm, Dk, h0)
    for out, grads, dh in (((y, h), (dy, dhT), dhT), ((y,), (dy,), None)):
        got = torch.autograd.grad(out, ins, grads, retain_graph=True)
        want = R.ssm_scan_bwd_ref(*(t.detach() for t in ins[:6]), dy, h0=h0.detach(), dhT=dh)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            scale = max(1.0, float(b.float().abs().max()))
            torch.testing.assert_close(a.float(), b.float(), atol=tol * scale, rtol=tol)


def test_ssm_scan_grad_route_wires_the_backward_kernel(monkeypatch):
    """``ops.ssm_scan`` with grad needed on a tensor the kernel takes: the
    forward wrapper runs once with ``return_states`` and grad mode off, the
    backward wrapper once with the saved inputs, checkpoints and the
    gradients of y and h_T (None when h_T is unused), and each of its seven
    gradients reaches its input.  The wrappers are emulated by their plain
    versions (the kernels run on the card only)."""
    calls = []

    def fwd(x, dt, A, Bm, Cm, D, h0=None, return_states=False):
        assert return_states and not torch.is_grad_enabled()
        y, hT = R.ssm_scan_ref(x, dt, A, Bm, Cm, D, h0=h0)
        states = torch.full((x.shape[0], _build.ssm_checkpoints(x.shape[1]), x.shape[2],
                             A.shape[1]), 7.0)
        calls.append("fwd")
        return y, hT, states

    def bwd(x, dt, A, Bm, Cm, D, states, dy, h0=None, dhT=None):
        assert torch.equal(states, torch.full_like(states, 7.0))
        calls.append(("bwd", dhT is None))
        return R.ssm_scan_bwd_ref(x, dt, A, Bm, Cm, D, dy, h0=h0, dhT=dhT)

    monkeypatch.setattr(ops, "_use_kernel", lambda impl, x: True)
    monkeypatch.setattr(ops, "_ss", fwd)
    monkeypatch.setattr(ops, "_ssb", bwd)
    rng = np.random.default_rng(94)
    B, T, D, N = 2, 70, 6, 4
    x = (0.5 * _t(rng, (B, T, D), F32)).requires_grad_()
    dt = (0.1 * _t(rng, (B, T, D), F32).abs()).requires_grad_()
    A = (-_t(rng, (D, N), F32).abs() - 0.1).requires_grad_()
    proj = (0.3 * _t(rng, (B, T, 3 + 2 * N), F32)).requires_grad_()
    Dk = _t(rng, (D,), F32).requires_grad_()
    h0 = (0.2 * _t(rng, (B, D, N), F32)).requires_grad_()
    ins = (x, dt, A, proj, Dk, h0)
    for use_h in (True, False):
        calls.clear()
        y, h = ops.ssm_scan(x, dt, A, proj[..., 3:3 + N], proj[..., 3 + N:], Dk, h0=h0)
        assert type(y.grad_fn).__name__ == "_SSMScanBackward"
        loss = y.square().sum() + (h.sum() if use_h else 0)
        got = torch.autograd.grad(loss, ins)
        assert calls == ["fwd", ("bwd", not use_h)]
        ref = [t.detach().requires_grad_() for t in ins]
        yr, hr = R.ssm_scan_ref(ref[0], ref[1], ref[2], ref[3][..., 3:3 + N],
                                ref[3][..., 3 + N:], ref[4], h0=ref[5])
        want = torch.autograd.grad(yr.square().sum() + (hr.sum() if use_h else 0), ref)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
