"""The yardstick's counts at shapes worked out by hand."""

from __future__ import annotations

import json

import pytest

from bench import roofline


def test_peaks_are_the_data_sheet_figures():
    assert roofline.PEAK_BF16_FLOPS == 989e12
    assert roofline.HBM_BYTES_PER_S == 3.35e12


def test_flash_call_counts_the_causal_triangle_and_each_byte_once():
    # B=1, S=4, H=2, dk=3, dv=2, K=2, bf16
    info = {"q": (1, 4, 2, 3), "k": (1, 4, 2, 3), "v": (1, 4, 2, 2), "itemsize": 2,
            "causal": True}
    flops, nbytes = roofline.attention_call("attention", info)
    assert flops == 2.0 * 2 * (3 + 2) * 10            # 10 (q, k) pairs of 16
    assert nbytes == 2 * (4 * 2 * 3 + 4 * 2 * 5 + 4 * 2 * 2)
    flops_full, _ = roofline.attention_call("attention", dict(info, causal=False))
    assert flops_full == 2.0 * 2 * 5 * 16


def test_paged_prefill_chunk_counts_past_and_chunk():
    # chunk of C=3 after past=5, H=2, K=1, d=4, pages of 4 tokens
    info = {"q": (3, 2, 4), "k": (10, 4, 1, 4), "v": (10, 4, 1, 4), "itemsize": 2,
            "past": 5}
    flops, nbytes = roofline.attention_call("paged_prefill_attention", info)
    assert flops == 2.0 * 2 * 8 * (3 * 5 + 6)          # 6 + 7 + 8 keys
    assert nbytes == 2 * (3 * 2 * 4 + 8 * 1 * 8 + 3 * 2 * 4) + 4 * 2


def test_paged_decode_skips_padding_rows():
    info = {"q": (4, 2, 4), "k": (10, 4, 1, 4), "v": (10, 4, 1, 4), "itemsize": 2,
            "lengths": [5, 1, 0, 0]}
    flops, nbytes = roofline.attention_call("paged_decode_attention", info)
    assert flops == 2.0 * 2 * 8 * 6
    assert nbytes == 2 * (2 * 2 * 8 + 6 * 1 * 8) + 4 * (2 + 1) + 4 * 2


def test_bound_takes_the_larger_term():
    assert roofline.bound_s(989e12, 1.0) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_model_flops_of_stablelm_by_hand(root):
    cfg = json.loads((root / "bench/configs/stablelm-1.6b.json").read_text())
    d, ff, V, L = 2048, 5632, 100352, 24
    n = L * (4 * d * d + 3 * d * ff) + d * V
    assert n == 1_438_646_272
    f = roofline.model_flops(cfg)
    assert f == {"per_token": 2.0 * n, "per_ctx": 2.0 * L * 32 * (64 + 64)}


def test_model_flops_of_deepseek_by_hand(root):
    cfg = json.loads((root / "bench/configs/deepseek-v2-lite-16b.json").read_text())
    d, H, L, V = 2048, 16, 27, 102400
    attn = d * H * 192 + d * (512 + 64) + 512 * H * (128 + 128) + H * 128 * d
    moe = d * 64 + (6 + 2) * 3 * d * 1408
    n = L * attn + 3 * d * 10944 + 26 * moe + d * V
    assert 2.2e9 < n < 2.6e9                            # "16B-A2.4B"
    assert roofline.model_flops(cfg) == {"per_token": 2.0 * n,
                                         "per_ctx": 2.0 * L * H * (192 + 128)}


def test_attention_kernels_by_name():
    assert roofline.is_attention_kernel("void attention_tc_kernel<64, 64>(Params)")
    assert roofline.is_attention_kernel("decode_split_tc_kernel")
    assert not roofline.is_attention_kernel("rmsnorm_kernel")
