"""The port's CUDA kernels on the card, against their plain versions.

A CUDA kernel has no CPU mode, so every test here is marked ``gpu`` and
skips where ``torch.cuda.is_available()`` is false.  On a GPU machine::

    python -m pytest -q -m gpu tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import dataclasses

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_int8,
    paged_prefill_attention,
    paged_prefill_attention_int8,
)
from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models import init_params
from repro_torch.serving import LLMEngine, PagedLLMEngine, Request

# tolerances of tests/test_paged_kernels.py
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]
# (H, K, hd, ps): the two smoke configs, stablelm-1.6b and internlm2-20b widths
WIDTHS = [(4, 4, 16, 8), (6, 2, 16, 8), (32, 32, 64, 16), (48, 8, 128, 16)]
# (H, K, hd, hd_v) of the slot kernels: stablelm-1.6b, internlm2-20b, MLA
SLOT_WIDTHS = [(32, 32, 64, 64), (48, 8, 128, 128), (16, 16, 192, 128)]
# the selective scan against its plain version: f32 state math in both, in
# another summation order over N and with expf's last bit, compounding over
# T (tests/test_kernels.py's 2e-4); bf16 adds one rounding of y
SSM_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# (B, T, D, N): Jamba-1.5-Large decode at B = 4 and prefill of 17 and 512
# tokens (D = 16384, N = 16), the smoke config's widths, ragged T and D
SSM_SHAPES = [(4, 1, 16384, 16), (1, 17, 16384, 16), (1, 512, 16384, 16),
              (2, 13, 128, 8), (3, 37, 100, 16),
              # state sizes each lane form serves: 1 and 4 (one lane), 13 (ragged)
              (2, 13, 128, 1), (3, 37, 100, 4), (2, 19, 100, 13)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pools(rng, P, ps, K, hd, dtype, dev):
    kp = torch.from_numpy(rng.normal(size=(P, ps, K, hd)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(P, ps, K, hd)).astype(np.float32))
    return kp.to(dev, dtype), vp.to(dev, dtype)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,K,hd,ps", WIDTHS)
def test_decode_kernel_matches_plain_and_ignores_nan_garbage(dev, H, K, hd, ps, dtype):
    rng = np.random.default_rng(31)
    npp = 8
    lens = np.array([1, ps, ps + 1, npp * ps], np.int32)
    B, P = len(lens), len(lens) * npp + 2
    q = torch.from_numpy(rng.normal(size=(B, H, hd)).astype(np.float32)).to(dev, dtype)
    kp, vp = _pools(rng, P, ps, K, hd, dtype, dev)
    bt = rng.permutation(np.arange(1, P))[: B * npp].reshape(B, npp).astype(np.int32)
    bt_t, ln = torch.from_numpy(bt).to(dev), torch.from_numpy(lens).to(dev)
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, kp, vp, bt_t, ln)
    assert paged_decode_attention.launches == before + 1
    _close(got, R.paged_decode_attention_ref(q, kp, vp, bt_t, ln), dtype)
    # every slot past each length (and the spare pages) holds NaN
    live = torch.zeros(P, ps, dtype=torch.bool)
    for b in range(B):
        for t in range(int(lens[b])):
            live[bt[b, t // ps], t % ps] = True
    k2, v2 = kp.clone(), vp.clone()
    k2[~live.to(dev)], v2[~live.to(dev)] = float("nan"), float("nan")
    assert torch.equal(paged_decode_attention(q, k2, v2, bt_t, ln), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,K,hd,ps", WIDTHS)
@pytest.mark.parametrize("past,C", [(0, 16), (5, 23), (64, 64)])
def test_prefill_kernel_matches_plain_and_ignores_nan_garbage(
        dev, H, K, hd, ps, past, C, dtype):
    rng = np.random.default_rng(32)
    ctx = past + C
    npp = -(-ctx // ps) + 1
    P = npp + 3
    q = torch.from_numpy(rng.normal(size=(C, H, hd)).astype(np.float32)).to(dev, dtype)
    kp, vp = _pools(rng, P, ps, K, hd, dtype, dev)
    bt = rng.permutation(np.arange(1, P))[:npp].astype(np.int32)
    bt_t = torch.from_numpy(bt).to(dev)
    got = paged_prefill_attention(q, kp, vp, bt_t, past)
    _close(got, R.paged_prefill_attention_ref(q, kp, vp, bt_t, past), dtype)
    live = torch.zeros(P, ps, dtype=torch.bool)
    for t in range(ctx):
        live[bt[t // ps], t % ps] = True
    k2, v2 = kp.clone(), vp.clone()
    k2[~live.to(dev)], v2[~live.to(dev)] = float("nan"), float("nan")
    assert torch.equal(paged_prefill_attention(q, k2, v2, bt_t, past), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 64), (3, 5, 96), (64, 2048)])
def test_rmsnorm_kernel_matches_plain(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(33)
    x = torch.randn(shape, generator=g, device=dev).mul(3).to(dtype)
    gamma = torch.randn(shape[-1:], generator=g, device=dev).to(dtype)
    _close(rmsnorm(x, gamma), R.rmsnorm_ref(x, gamma), dtype)


def _off16(t):
    """A contiguous copy of ``t`` one element past its buffer's start."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 100, 2048, 7168, 8192, 16384])
@pytest.mark.parametrize("rows", [0, 1, 8, 64, 386, 512])
def test_rmsnorm_kernel_at_the_main_paths_rows_and_widths(dev, rows, d, dtype, misaligned):
    """Every row count and width of the main path and the smoke configs,
    d = 100 (not a multiple of the 16-byte vector: odd rows start off 16
    bytes), and x and gamma one element off 16 bytes: against the plain
    version, one launch a call (none without rows)."""
    g = torch.Generator(device=dev).manual_seed(34)
    x = torch.randn(rows, d, generator=g, device=dev).mul(3).to(dtype)
    gamma = torch.randn(d, generator=g, device=dev).to(dtype)
    if misaligned:
        x, gamma = _off16(x), _off16(gamma)
        assert x.is_contiguous() and gamma.data_ptr() % 16 and (rows == 0 or x.data_ptr() % 16)
    before = rmsnorm.launches
    got = rmsnorm(x, gamma)
    assert rmsnorm.launches == before + (1 if rows else 0)
    assert got.shape == x.shape and got.dtype == dtype
    _close(got, R.rmsnorm_ref(x, gamma), dtype)


@pytest.mark.gpu
def test_rmsnorm_kernel_streams_rows_wider_than_its_slots(dev):
    """Rows past what 16 warps' slots hold (32768 bf16, 16384 f32 values)
    are streamed and read again for the output, in the same body."""
    g = torch.Generator(device=dev).manual_seed(35)
    for dtype, d in ((torch.bfloat16, 40001), (torch.float32, 20000)):
        x = torch.randn(3, d, generator=g, device=dev).to(dtype)
        gamma = torch.randn(d, generator=g, device=dev).to(dtype)
        assert _build.rmsnorm_warps(d, dtype) == 16
        _close(rmsnorm(x, gamma), R.rmsnorm_ref(x, gamma), dtype)


@pytest.mark.gpu
def test_rmsnorm_launcher_refuses_forms_it_lacks(dev):
    """Warps a row are a launch argument: a value the launcher has no form
    for is refused, never run."""
    x = torch.zeros(4, 64, device=dev)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for warps in (0, 3, 32, 64):
        code = _build.library().rmsnorm_f32(x.data_ptr(), x[0].data_ptr(), out.data_ptr(),
                                            4, 64, warps, 1e-5, stream)
        with pytest.raises(_build.KernelError, match="rmsnorm_f32"):
            _build.check(code, "rmsnorm_f32")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("warps", [1, 2, 4, 8, 16])
def test_rmsnorm_every_warp_form_matches_plain(dev, monkeypatch, warps, dtype):
    """Every warps-a-row form the launcher has, at d = 2048, 100 and 8192
    (rows past one warp's slots streamed where the form is narrow)."""
    monkeypatch.setattr(_build, "rmsnorm_warps", lambda *a: warps)
    g = torch.Generator(device=dev).manual_seed(36)
    for d in (2048, 100, 8192):
        x = torch.randn(37, d, generator=g, device=dev).mul(3).to(dtype)
        gamma = torch.randn(d, generator=g, device=dev).to(dtype)
        _close(rmsnorm(x, gamma), R.rmsnorm_ref(x, gamma), dtype)


@pytest.mark.gpu
def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32/bf16"):
        rmsnorm(x, torch.ones(64, device=dev, dtype=torch.float16))
    q = torch.zeros(2, 4, 16, device=dev)
    pool = torch.zeros(5, 8, 4, 16, device=dev)
    bt = torch.ones(2, 2, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, pool, pool, bt, torch.ones(2, dtype=torch.int32,
                                                             device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm_1_6b", "internlm2_20b"])
def test_engine_on_card_matches_cpu_tokens(dev, arch):
    """float32 smoke model: the engine on the card (through the kernels)
    and on the CPU (plain versions) give the same greedy tokens."""
    cfg = get_smoke_config(arch).with_(dtype="float32")
    params = init_params(cfg, seed=3, device="cpu")
    prompts = [[1, 2, 3], list(range(4, 30)), [7] * 9, list(range(40, 57))]
    outs = {}
    ops.reset_launch_counts()
    for d in ("cpu", dev):
        eng = PagedLLMEngine(cfg, max_seqs=4, max_len=64, page_size=8,
                             prefill_chunk=8, params=params, device=d)
        out = {}
        for i, p in enumerate(prompts):
            assert eng.admit(Request(
                rid=i, prompt=p, max_new_tokens=10,
                on_finish=lambda r, out=out: out.__setitem__(r.rid, list(r.out_tokens))))
        while eng.batch_size or eng.waiting:
            eng.step()
        outs[str(d)] = out
    torch.cuda.synchronize()
    assert outs["cpu"] == outs[str(dev)]
    counts = ops.launch_counts()
    n = cfg.n_layers
    assert counts["paged_decode_attention"] == n * eng.decode_steps
    assert counts["paged_prefill_attention"] == n * eng.prefill_chunks
    assert counts["rmsnorm"] == (2 * n + 1) * (eng.decode_steps + eng.prefill_chunks)


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,K,hd,hd_v", SLOT_WIDTHS)
def test_slot_decode_kernel_matches_plain_and_ignores_nan_tails(dev, H, K, hd, hd_v,
                                                                 dtype):
    """chip_smoke's decode shapes: B = 4, S_max = 1024, lengths 1, 17, 511
    and 1024; each slot's tail past its length poisoned with +-99, then NaN."""
    rng = np.random.default_rng(34)
    B, S = 4, 1024
    lens = np.array([1, 17, 511, 1024], np.int32)
    q = _randn(rng, (B, H, hd), dtype, dev)
    kc, vc = _randn(rng, (B, S, K, hd), dtype, dev), _randn(rng, (B, S, K, hd_v), dtype, dev)
    tail = torch.from_numpy(np.arange(S)[None, :] >= lens[:, None]).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    k99, v99 = kc.clone(), vc.clone()
    k99[tail], v99[tail] = 99.0, -99.0
    before = decode_attention.launches
    got = decode_attention(q, k99, v99, ln)
    assert decode_attention.launches == before + 1
    assert got.shape == (B, H, hd_v)
    _close(got, R.decode_attention_ref(q, k99, v99, ln), dtype)
    knan, vnan = kc.clone(), vc.clone()
    knan[tail], vnan[tail] = float("nan"), float("nan")
    assert torch.equal(decode_attention(q, knan, vnan, ln), decode_attention(q, kc, vc, ln))


@pytest.mark.gpu
def test_slot_decode_kernel_gives_zeros_for_length_zero(dev):
    q = torch.ones(2, 4, 16, device=dev)
    kc = torch.full((2, 8, 2, 16), float("nan"), device=dev)
    out = decode_attention(q, kc, kc, torch.tensor([0, 0], dtype=torch.int32, device=dev))
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq", [1, 97, 512])
@pytest.mark.parametrize("H,K,hd,hd_v", SLOT_WIDTHS)
def test_flash_kernel_matches_plain(dev, H, K, hd, hd_v, Sq, causal, dtype):
    """chip_smoke's flash shapes: B = 1, Sq = Sk = 1, 97 and 512."""
    rng = np.random.default_rng(35)
    q = _randn(rng, (1, Sq, H, hd), dtype, dev)
    k, v = _randn(rng, (1, Sq, K, hd), dtype, dev), _randn(rng, (1, Sq, K, hd_v), dtype, dev)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    assert got.shape == (1, Sq, H, hd_v)
    _close(got, R.attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.gpu
def test_flash_kernel_reads_strided_inputs(dev):
    """q, k and v given as transposed views give the contiguous result."""
    g = torch.Generator(device=dev).manual_seed(36)
    B, S, H, K, hd = 2, 70, 6, 2, 64
    q = torch.randn(B, H, S, hd, generator=g, device=dev).transpose(1, 2)
    k = torch.randn(B, K, S, hd, generator=g, device=dev).transpose(1, 2)
    v = torch.randn(B, K, S, hd, generator=g, device=dev).transpose(1, 2)
    assert not q.is_contiguous()
    assert torch.equal(flash_attention(q, k, v),
                       flash_attention(q.contiguous(), k.contiguous(), v.contiguous()))


@pytest.mark.gpu
def test_slot_kernel_routes_raise(dev):
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q[:, 0], q, q, torch.ones(1, dtype=torch.int32), impl="cuda")
    qd = q.to(dev)
    with pytest.raises(NotImplementedError, match="kv_len"):
        ops.attention(qd, qd, qd, kv_len=torch.ones(1, dtype=torch.int32, device=dev))
    with pytest.raises(NotImplementedError, match="q_offset"):
        ops.attention(qd, qd, qd, causal=True, q_offset=2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm_1_6b", "internlm2_20b"])
def test_slot_engine_on_card_matches_cpu_tokens(dev, arch):
    """float32 smoke model: the slot engine on the card (flash and decode
    kernels) and on the CPU give the same greedy tokens."""
    cfg = get_smoke_config(arch).with_(dtype="float32")
    params = init_params(cfg, seed=3, device="cpu")
    prompts = [[1, 2, 3], list(range(4, 30)), [7] * 9, list(range(40, 57)), [5, 6]]
    outs = {}
    ops.reset_launch_counts()
    for d in ("cpu", dev):
        eng = LLMEngine(cfg, max_batch=3, max_len=64, params=params, device=d)
        out, pending = {}, list(enumerate(prompts))
        while pending or eng.batch_size:
            while pending and eng.can_admit():
                i, p = pending.pop(0)
                assert eng.admit(Request(
                    rid=i, prompt=p, max_new_tokens=6 + i,
                    on_finish=lambda r, out=out: out.__setitem__(r.rid, list(r.out_tokens))))
            eng.step()
        outs[str(d)] = out
    torch.cuda.synchronize()
    assert outs["cpu"] == outs[str(dev)]
    counts = ops.launch_counts()
    n = cfg.n_layers
    assert counts["flash_attention"] == n * eng.admissions
    assert counts["decode_attention"] == n * eng.decode_steps
    assert counts["rmsnorm"] == (2 * n + 1) * (eng.admissions + eng.decode_steps)


# ---------------------------------------------------------------------------
# int8 pages: the quantized forms of both paged kernels
# ---------------------------------------------------------------------------
# what an unwritten or recycled slot's scale may hold
GARBAGE_SCALES = [float("nan"), float("inf"), 1e30]


def _int8_case(rng, P, ps, K, hd, live, dev):
    """int8 pools and f32 scale pools quantized from normal K/V; every slot
    outside ``live`` holds a +-99 payload with a clean scale of 1."""
    kq, ks = ops.quantize_kv(_randn(rng, (P, ps, K, hd), torch.float32, dev))
    vq, vs = ops.quantize_kv(_randn(rng, (P, ps, K, hd), torch.float32, dev))
    dead = ~live.to(dev)
    kq[dead], vq[dead] = 99, -99
    ks[dead], vs[dead] = 1.0, 1.0
    return kq, vq, ks, vs, dead


def _garbage_scales(ks, vs, dead, value):
    k2, v2 = ks.clone(), vs.clone()
    k2[dead], v2[dead] = value, value
    return k2, v2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,K,hd,ps", WIDTHS)
def test_int8_decode_kernel_matches_plain_and_ignores_garbage_scales(
        dev, H, K, hd, ps, dtype):
    rng = np.random.default_rng(41)
    npp = 8
    lens = np.array([1, ps, ps + 1, npp * ps], np.int32)
    B, P = len(lens), len(lens) * npp + 2
    bt = rng.permutation(np.arange(1, P))[: B * npp].reshape(B, npp).astype(np.int32)
    live = torch.zeros(P, ps, dtype=torch.bool)
    for b in range(B):
        for t in range(int(lens[b])):
            live[bt[b, t // ps], t % ps] = True
    kq, vq, ks, vs, dead = _int8_case(rng, P, ps, K, hd, live, dev)
    q = _randn(rng, (B, H, hd), dtype, dev)
    bt_t, ln = torch.from_numpy(bt).to(dev), torch.from_numpy(lens).to(dev)
    before = paged_decode_attention_int8.launches
    got = paged_decode_attention_int8(q, kq, vq, bt_t, ln, ks, vs)
    assert paged_decode_attention_int8.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, H, hd)
    _close(got, R.paged_decode_attention_ref(q, kq, vq, bt_t, ln, k_scales=ks,
                                             v_scales=vs), dtype)
    for value in GARBAGE_SCALES:
        k2, v2 = _garbage_scales(ks, vs, dead, value)
        assert torch.equal(paged_decode_attention_int8(q, kq, vq, bt_t, ln, k2, v2), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,K,hd,ps", WIDTHS)
@pytest.mark.parametrize("past,C", [(0, 16), (5, 23), (64, 64)])
def test_int8_prefill_kernel_matches_plain_and_ignores_garbage_scales(
        dev, H, K, hd, ps, past, C, dtype):
    rng = np.random.default_rng(42)
    ctx = past + C
    npp = -(-ctx // ps) + 1
    P = npp + 3
    bt = rng.permutation(np.arange(1, P))[:npp].astype(np.int32)
    live = torch.zeros(P, ps, dtype=torch.bool)
    for t in range(ctx):
        live[bt[t // ps], t % ps] = True
    kq, vq, ks, vs, dead = _int8_case(rng, P, ps, K, hd, live, dev)
    q = _randn(rng, (C, H, hd), dtype, dev)
    bt_t = torch.from_numpy(bt).to(dev)
    got = paged_prefill_attention_int8(q, kq, vq, bt_t, past, ks, vs)
    assert got.dtype == dtype and got.shape == (C, H, hd)
    _close(got, R.paged_prefill_attention_ref(q, kq, vq, bt_t, past, k_scales=ks,
                                              v_scales=vs), dtype)
    for value in GARBAGE_SCALES:
        k2, v2 = _garbage_scales(ks, vs, dead, value)
        assert torch.equal(paged_prefill_attention_int8(q, kq, vq, bt_t, past, k2, v2),
                           got)


@pytest.mark.gpu
def test_int8_kernels_read_strided_stacked_pools(dev):
    """Per-layer views of stacked (n_sb, P, ps, K[, hd]) pools go in as they
    are; ops sends int8 pools with scales to the int8 kernels."""
    rng = np.random.default_rng(43)
    kq, ks = ops.quantize_kv(_randn(rng, (3, 9, 8, 2, 32), torch.float32, dev))
    vq, vs = ops.quantize_kv(_randn(rng, (3, 9, 8, 2, 32), torch.float32, dev))
    q = _randn(rng, (2, 4, 32), torch.bfloat16, dev)
    bt = torch.tensor([[3, 5, 1], [2, 7, 8]], dtype=torch.int32, device=dev)
    ln = torch.tensor([17, 9], dtype=torch.int32, device=dev)
    before = ops.launch_counts()
    got = ops.paged_decode_attention(q, kq[1], vq[1], bt, ln, k_scales=ks[1],
                                     v_scales=vs[1])
    want = paged_decode_attention_int8(q, kq[1].contiguous(), vq[1].contiguous(), bt,
                                       ln, ks[1].contiguous(), vs[1].contiguous())
    assert torch.equal(got, want)
    after = ops.launch_counts()
    assert after["paged_decode_attention_int8"] == before["paged_decode_attention_int8"] + 2
    assert after["paged_decode_attention"] == before["paged_decode_attention"]
    out = ops.paged_prefill_attention(q, kq[2], vq[2], bt[0], 10, k_scales=ks[2],
                                      v_scales=vs[2])
    assert out.shape == q.shape and bool(torch.isfinite(out.float()).all())


@pytest.mark.gpu
def test_int8_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros(2, 4, 16, device=dev)
    pool = torch.zeros(5, 8, 4, 16, dtype=torch.int8, device=dev)
    sc = torch.ones(5, 8, 4, device=dev)
    bt = torch.ones(2, 2, dtype=torch.int32, device=dev)
    ln = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int8 pages"):
        paged_decode_attention_int8(q, pool.float(), pool.float(), bt, ln, sc, sc)
    with pytest.raises(ValueError, match="scale pools"):
        paged_decode_attention_int8(q, pool, pool, bt, ln, sc.double(), sc.double())
    with pytest.raises(ValueError, match="scale pools"):
        paged_prefill_attention_int8(q, pool, pool, bt[0], 0, sc[:, :4], sc[:, :4])
    with pytest.raises(ValueError, match="f32/bf16"):
        paged_decode_attention(q, pool, pool, bt, ln)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm_1_6b", "internlm2_20b"])
def test_int8_engines_on_card_match_cpu_tokens(dev, arch):
    """float32 smoke models: the int8 paged engine and the int8 slot engine
    give the same greedy tokens on the card as on the CPU, and the paged
    one launches the int8 kernels once a layer per chunk and step."""
    cfg = get_smoke_config(arch).with_(dtype="float32")
    params = init_params(cfg, seed=3, device="cpu")
    prompts = [[1, 2, 3], list(range(4, 30)), [7] * 9, list(range(40, 57))]

    def drive(eng):
        out = {}
        for i, p in enumerate(prompts):
            assert eng.admit(Request(
                rid=i, prompt=p, max_new_tokens=10,
                on_finish=lambda r, out=out: out.__setitem__(r.rid, list(r.out_tokens))))
        while eng.batch_size or getattr(eng, "waiting", None):  # paged evicts
            eng.step()
        return out

    paged, slot = {}, {}
    for d in ("cpu", dev):
        ops.reset_launch_counts()
        eng = PagedLLMEngine(cfg, max_seqs=4, max_len=64, page_size=8, prefill_chunk=8,
                             params=params, kv_dtype="int8", device=d)
        paged[str(d)] = drive(eng)
        slot[str(d)] = drive(LLMEngine(cfg.with_(kv_cache_dtype="int8"), max_batch=4,
                                       max_len=64, params=params, device=d))
    torch.cuda.synchronize()
    assert paged["cpu"] == paged[str(dev)] and slot["cpu"] == slot[str(dev)]
    counts = ops.launch_counts()
    n = cfg.n_layers
    assert counts["paged_decode_attention_int8"] == n * eng.decode_steps
    assert counts["paged_prefill_attention_int8"] == n * eng.prefill_chunks
    assert counts["paged_decode_attention"] == counts["paged_prefill_attention"] == 0


@pytest.mark.gpu
def test_int8_prefix_cache_copy_on_write_on_card_matches_cpu(dev):
    """Copy-on-write of int8 pages (payload and scale pools) on the card:
    the same tokens, hits and copies as on the CPU."""
    cfg = get_smoke_config("stablelm_1_6b").with_(dtype="float32")
    params = init_params(cfg, seed=4, device="cpu")
    shared = [3 + (7 * i) % 29 for i in range(32)]      # 4 pages at ps 8
    prompts = [shared + [50 + i] for i in range(3)] + [shared, shared]
    runs = {}
    for d in ("cpu", dev):
        eng = PagedLLMEngine(cfg, max_seqs=4, max_len=64, page_size=8, prefill_chunk=8,
                             params=params, prefix_cache=True, kv_dtype="int8",
                             sanitize=True, device=d)
        out, pending, steps = {}, list(enumerate(prompts)), 0
        while pending or eng.batch_size or eng.waiting:
            if pending and steps % 2 == 0 and eng.can_admit():
                i, p = pending[0]
                if eng.admit(Request(rid=i, prompt=p, max_new_tokens=6,
                                     on_finish=lambda r, out=out: out.__setitem__(
                                         r.rid, list(r.out_tokens)))):
                    pending.pop(0)
            eng.step()
            steps += 1
        runs[str(d)] = (out, eng.prefix_index.hits, eng.cow_copies)
    torch.cuda.synchronize()
    assert runs["cpu"] == runs[str(dev)]
    assert runs["cpu"][1] > 0 and runs["cpu"][2] > 0


def _scan_inputs(rng, B, T, D, N, dtype, dev):
    """tests/test_kernels.py's value ranges; A and h0 float32."""
    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)
    return (t(rng.normal(size=(B, T, D)) * 0.5), t(np.abs(rng.normal(size=(B, T, D))) * 0.1),
            t(-(np.abs(rng.normal(size=(D, N))) + 0.1), torch.float32),
            t(rng.normal(size=(B, T, N)) * 0.3), t(rng.normal(size=(B, T, N)) * 0.3),
            t(rng.normal(size=(D,))), t(rng.normal(size=(B, D, N)) * 0.2, torch.float32))


def _ssm_close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), atol=SSM_TOL[dtype],
                               rtol=SSM_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("B,T,D,N", SSM_SHAPES)
def test_ssm_scan_kernel_matches_plain(dev, B, T, D, N, with_h0, dtype):
    rng = np.random.default_rng(60)
    x, dt, A, Bm, Cm, Dk, h0 = _scan_inputs(rng, B, T, D, N, dtype, dev)
    h0 = h0 if with_h0 else None
    before = ssm_scan.launches
    y, h = ssm_scan(x, dt, A, Bm, Cm, Dk, h0=h0)
    assert ssm_scan.launches == before + 1
    assert y.shape == (B, T, D) and y.dtype == dtype
    assert h.shape == (B, D, N) and h.dtype == torch.float32
    yr, hr = R.ssm_scan_ref(x, dt, A, Bm, Cm, Dk, h0=h0)
    _ssm_close(y, yr, dtype)
    _ssm_close(h, hr, torch.float32 if dtype == torch.float32 else dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_scan_kernel_reads_strided_views_and_carries_state(dev, dtype):
    """B and C as column slices of one projection (the Mamba layer's
    layout) give the contiguous result, and two halves with the state
    carried give the whole."""
    rng = np.random.default_rng(61)
    B, T, D, N, r = 2, 70, 300, 16, 24
    x, dt, A, _, _, Dk, _ = _scan_inputs(rng, B, T, D, N, dtype, dev)
    proj = torch.from_numpy(rng.normal(size=(B, T, r + 2 * N)).astype(np.float32) * 0.3)
    proj = proj.to(dev, dtype)
    Bm, Cm = proj[..., r:r + N], proj[..., r + N:]
    xt = x.transpose(0, 1).contiguous().transpose(0, 1)     # strided x as well
    assert not Bm.is_contiguous() and not xt.is_contiguous()
    y, h = ssm_scan(xt, dt, A, Bm, Cm, Dk)
    y2, h2 = ssm_scan(x, dt, A, Bm.contiguous(), Cm.contiguous(), Dk)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    ya, ha = ssm_scan(x[:, :33], dt[:, :33], A, Bm[:, :33], Cm[:, :33], Dk)
    yb, hb = ssm_scan(x[:, 33:], dt[:, 33:], A, Bm[:, 33:], Cm[:, 33:], Dk, h0=ha)
    assert torch.equal(torch.cat([ya, yb], dim=1), y) and torch.equal(hb, h)


@pytest.mark.gpu
def test_ssm_scan_refuses_what_the_kernel_does_not_take(dev):
    x = torch.zeros(1, 4, 8, device=dev)
    Bm, D = torch.zeros(1, 4, 17, device=dev), torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="N <= 16"):
        ssm_scan(x, x, torch.zeros(8, 17, device=dev), Bm, Bm, D)
    with pytest.raises(ValueError, match="float32 A"):
        ssm_scan(x, x, torch.zeros(8, 4, device=dev, dtype=torch.bfloat16),
                 Bm[..., :4], Bm[..., :4], D)
    with pytest.raises(ValueError, match="one dtype"):
        ssm_scan(x, x.bfloat16(), torch.zeros(8, 4, device=dev), Bm[..., :4], Bm[..., :4], D)
    # a launch the kernel refuses (N past its registers; lanes it has no
    # form for, or too few for N) raises, never runs
    y, h = torch.empty_like(x), torch.empty(1, 8, 17, device=dev)
    A = torch.zeros(8, 17, device=dev)
    for N, lanes in ((17, 4), (16, 3), (16, 8), (16, 2), (5, 1), (9, 2)):
        code = _build.library().ssm_scan_f32(
            x.data_ptr(), x.data_ptr(), A.data_ptr(), Bm.data_ptr(), Bm.data_ptr(),
            D.data_ptr(), None, y.data_ptr(), h.data_ptr(), None, 1, 4, 8, N, lanes,
            *x.stride(), *x.stride(), *Bm.stride(), *Bm.stride(),
            torch.cuda.current_stream(dev).cuda_stream)
        with pytest.raises(_build.KernelError, match="ssm_scan_f32"):
            _build.check(code, "ssm_scan_f32")


# (lanes, (B, T, D, N)): every lanes-a-channel form the launcher has, at
# each shape whose N its lanes hold (4 states a lane)
LANE_FORM_CASES = [(lanes, shape) for lanes in _build.SSM_LANES
                   for shape in [(4, 1, 16384, 16), (2, 37, 100, 16), (3, 70, 300, 8),
                                 (2, 13, 128, 4), (2, 19, 100, 3)]
                   if lanes * _build.SSM_STATES_PER_LANE >= shape[3]]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lanes,shape", LANE_FORM_CASES)
def test_ssm_scan_every_lane_form_matches_plain(dev, monkeypatch, lanes, shape, dtype):
    """Each lanes-a-channel form at every shape whose N it holds (more lanes
    than the rule picks, too), h0 given, against the plain version."""
    B, T, D, N = shape
    monkeypatch.setattr(_build, "ssm_scan_lanes", lambda n: lanes)
    x, dt, A, Bm, Cm, Dk, h0 = _scan_inputs(np.random.default_rng(62), B, T, D, N, dtype, dev)
    y, h = ssm_scan(x, dt, A, Bm, Cm, Dk, h0=h0)
    yr, hr = R.ssm_scan_ref(x, dt, A, Bm, Cm, Dk, h0=h0)
    _ssm_close(y, yr, dtype)
    _ssm_close(h, hr, torch.float32 if dtype == torch.float32 else dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("n_layers", [8, 5])
def test_hybrid_engine_on_card_matches_cpu_tokens(dev, n_layers):
    """float32 jamba-smoke (stacked and prefix layouts): the slot engine on
    the card and on the CPU give the same greedy tokens, with mid-stream
    slot re-use, and each Mamba layer launches the scan once per
    admission and decode step."""
    cfg = get_smoke_config("jamba_1_5_large_398b").with_(dtype="float32",
                                                         n_layers=n_layers)
    params = init_params(cfg, seed=3, device="cpu")
    prompts = [[1, 2, 3], list(range(4, 30)), [7] * 9, list(range(40, 57)), [5, 6]]
    outs = {}
    for d in ("cpu", dev):
        ops.reset_launch_counts()
        eng = LLMEngine(cfg, max_batch=2, max_len=64, params=params, device=d)
        out, pending = {}, list(enumerate(prompts))
        while pending or eng.batch_size:
            while pending and eng.can_admit():
                i, p = pending.pop(0)
                assert eng.admit(Request(
                    rid=i, prompt=p, max_new_tokens=6 + i,
                    on_finish=lambda r, out=out: out.__setitem__(r.rid, list(r.out_tokens))))
            eng.step()
        outs[str(d)] = out
    torch.cuda.synchronize()
    assert outs["cpu"] == outs[str(dev)]
    counts = ops.launch_counts()
    n_mamba = sum(1 for i in range(n_layers) if not cfg.is_attn_layer(i))
    assert counts["ssm_scan"] == n_mamba * (eng.admissions + eng.decode_steps)
    assert counts["flash_attention"] == (n_layers - n_mamba) * eng.admissions
    assert counts["decode_attention"] == (n_layers - n_mamba) * eng.decode_steps


# ---------------------------------------------------------------------------
# the tensor-core bodies of flash and paged prefill attention (bf16)
# ---------------------------------------------------------------------------
BF16 = torch.bfloat16
# (H, K): g = 1, 6 and 8; at g = 6 the 64-row blocks end mid-group
FLASH_GROUPS = [(8, 8), (12, 2), (16, 2)]
GARBAGE_VALUES = [float("nan"), float("inf")]


def _flash_inputs(rng, Sq, Sk, H, K, hd, dev, tail=0):
    """bf16 q, k, v; k and v are the first Sk rows of buffers ``tail`` rows
    longer, whose extra rows the kernel must never read."""
    q = _randn(rng, (1, Sq, H, hd), BF16, dev)
    kb, vb = _randn(rng, (1, Sk + tail, K, hd), BF16, dev), _randn(rng, (1, Sk + tail, K, hd),
                                                                 BF16, dev)
    return q, kb, vb


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,K", FLASH_GROUPS)
@pytest.mark.parametrize("Sq", [1, 63, 64, 65, 386, 512])
def test_flash_tensor_core_body_matches_plain_and_ignores_garbage_tails(
        dev, Sq, H, K, hd, causal):
    """bf16 at hd 64 and 128 takes the tensor-core body; rows past Sk in the
    buffers k and v are cut from hold NaN or Inf, which must not change the
    output by a bit."""
    rng = np.random.default_rng(70)
    q, kb, vb = _flash_inputs(rng, Sq, Sq, H, K, hd, dev, tail=37)
    k, v = kb[:, :Sq], vb[:, :Sq]
    before, tc0 = flash_attention.launches, flash_attention.tc_launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    assert flash_attention.tc_launches == tc0 + 1
    _close(got, R.attention_ref(q, k, v, causal=causal), BF16)
    for value in GARBAGE_VALUES:
        kb[:, Sq:], vb[:, Sq:] = value, value
        assert torch.equal(flash_attention(q, kb[:, :Sq], vb[:, :Sq], causal=causal), got)


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk", [(65, 130), (130, 65), (1, 700)])
def test_flash_tensor_core_body_bidirectional_other_lengths(dev, Sq, Sk):
    rng = np.random.default_rng(71)
    q, k, v = _flash_inputs(rng, Sq, Sk, 12, 2, 128, dev)
    tc0 = flash_attention.tc_launches
    _close(flash_attention(q, k, v, causal=False), R.attention_ref(q, k, v, causal=False),
           BF16)
    assert flash_attention.tc_launches == tc0 + 1


# (past, C): past off the page and the 64-token tile, C = 1, 17 and 64,
# contexts ending mid-page and mid-tile, and the timed chunk
PREFILL_TC_CASES = [(0, 1), (0, 17), (0, 64), (5, 1), (37, 17), (100, 64), (130, 17),
                    (448, 64), (1000, 17)]


def _prefill_tc_case(rng, past, C, H, K, hd, ps, dev):
    """q, a block table and the (P, ps) mask of live slots (every slot
    before ctx = past + C); spare pages are never referenced."""
    ctx = past + C
    npp = -(-ctx // ps) + 1
    P = npp + 3
    bt = rng.permutation(np.arange(1, P))[:npp].astype(np.int32)
    live = torch.zeros(P, ps, dtype=torch.bool)
    for t in range(ctx):
        live[bt[t // ps], t % ps] = True
    return _randn(rng, (C, H, hd), BF16, dev), torch.from_numpy(bt).to(dev), live, P


@pytest.mark.gpu
@pytest.mark.parametrize("H,K,hd,ps", WIDTHS)
@pytest.mark.parametrize("past,C", PREFILL_TC_CASES)
def test_prefill_tensor_core_body_matches_plain_and_ignores_nan_garbage(
        dev, H, K, hd, ps, past, C):
    rng = np.random.default_rng(72)
    q, bt, live, P = _prefill_tc_case(rng, past, C, H, K, hd, ps, dev)
    kp, vp = _pools(rng, P, ps, K, hd, BF16, dev)
    before, tc0 = paged_prefill_attention.launches, paged_prefill_attention.tc_launches
    got = paged_prefill_attention(q, kp, vp, bt, past)
    assert paged_prefill_attention.launches == before + 1
    assert paged_prefill_attention.tc_launches == tc0 + 1
    _close(got, R.paged_prefill_attention_ref(q, kp, vp, bt, past), BF16)
    for value in GARBAGE_VALUES:
        k2, v2 = kp.clone(), vp.clone()
        k2[~live.to(dev)], v2[~live.to(dev)] = value, value
        assert torch.equal(paged_prefill_attention(q, k2, v2, bt, past), got)


@pytest.mark.gpu
@pytest.mark.parametrize("H,K,hd,ps", WIDTHS)
@pytest.mark.parametrize("past,C", PREFILL_TC_CASES)
def test_int8_prefill_tensor_core_body_matches_plain_and_ignores_garbage_scales(
        dev, H, K, hd, ps, past, C):
    rng = np.random.default_rng(73)
    q, bt, live, P = _prefill_tc_case(rng, past, C, H, K, hd, ps, dev)
    kq, vq, ks, vs, dead = _int8_case(rng, P, ps, K, hd, live, dev)
    before = paged_prefill_attention_int8.launches
    tc0 = paged_prefill_attention_int8.tc_launches
    got = paged_prefill_attention_int8(q, kq, vq, bt, past, ks, vs)
    assert paged_prefill_attention_int8.launches == before + 1
    assert paged_prefill_attention_int8.tc_launches == tc0 + 1
    _close(got, R.paged_prefill_attention_ref(q, kq, vq, bt, past, k_scales=ks, v_scales=vs),
           BF16)
    for value in GARBAGE_SCALES:
        k2, v2 = _garbage_scales(ks, vs, dead, value)
        assert torch.equal(paged_prefill_attention_int8(q, kq, vq, bt, past, k2, v2), got)


@pytest.mark.gpu
def test_tensor_core_bodies_read_strided_and_stacked_views(dev):
    """Transposed q/k/v views and per-layer views of stacked pools take the
    tensor-core body and give the result of their contiguous copies."""
    g = torch.Generator(device=dev).manual_seed(74)
    B, S, H, K, hd = 2, 150, 12, 2, 64
    q = torch.randn(B, H, S, hd, generator=g, device=dev).to(BF16).transpose(1, 2)
    k = torch.randn(B, K, S, hd, generator=g, device=dev).to(BF16).transpose(1, 2)
    v = torch.randn(B, K, S, hd, generator=g, device=dev).to(BF16).transpose(1, 2)
    tc0 = flash_attention.tc_launches
    assert torch.equal(flash_attention(q, k, v),
                       flash_attention(q.contiguous(), k.contiguous(), v.contiguous()))
    assert flash_attention.tc_launches == tc0 + 2
    rng = np.random.default_rng(75)
    pools = _randn(rng, (3, 2, 12, 16, K, 128), BF16, dev)       # (layers, k/v, P, ps, ...)
    kq, ks = ops.quantize_kv(_randn(rng, (3, 12, 16, K, 128), torch.float32, dev))
    vq, vs = ops.quantize_kv(_randn(rng, (3, 12, 16, K, 128), torch.float32, dev))
    qc = _randn(rng, (40, H, 128), BF16, dev)
    bt = torch.tensor([4, 9, 2, 7, 11], dtype=torch.int32, device=dev)
    counts0, tcs0 = ops.launch_counts(), ops.tc_launch_counts()
    got = ops.paged_prefill_attention(qc, pools[1, 0], pools[1, 1], bt, 27)
    assert torch.equal(got, paged_prefill_attention(qc, pools[1, 0].contiguous(),
                                                    pools[1, 1].contiguous(), bt, 27))
    got = ops.paged_prefill_attention(qc, kq[2], vq[2], bt, 27, k_scales=ks[2],
                                      v_scales=vs[2])
    assert torch.equal(got, paged_prefill_attention_int8(
        qc, kq[2].contiguous(), vq[2].contiguous(), bt, 27, ks[2].contiguous(),
        vs[2].contiguous()))
    counts, tcs = ops.launch_counts(), ops.tc_launch_counts()
    for name in ("paged_prefill_attention", "paged_prefill_attention_int8"):
        assert counts[name] - counts0[name] == tcs[name] - tcs0[name] == 2


@pytest.mark.gpu
def test_only_bf16_at_tensor_core_widths_takes_tensor_cores(dev):
    """bf16 at hd 64 and 128 takes the tensor-core body; f32, MLA's 192/128
    and a misaligned bf16 view take the CUDA-core body, and still match."""
    rng = np.random.default_rng(76)
    for hd in (64, 128):
        for dtype, tc in ((BF16, 1), (torch.float32, 0)):
            q, k, v = (_randn(rng, (1, 70, 4, hd), dtype, dev) for _ in range(3))
            tc0 = flash_attention.tc_launches
            flash_attention(q, k, v)
            assert flash_attention.tc_launches == tc0 + tc
            qc, bt, live, P = _prefill_tc_case(rng, 20, 30, 4, 4, hd, 16, dev)
            kp, vp = _pools(rng, P, 16, 4, hd, dtype, dev)
            qc = qc.to(dtype)
            tc0 = paged_prefill_attention.tc_launches
            paged_prefill_attention(qc, kp, vp, bt, 20)
            assert paged_prefill_attention.tc_launches == tc0 + tc
            kq, vq, ks, vs, _ = _int8_case(rng, P, 16, 4, hd, live, dev)
            tc0 = paged_prefill_attention_int8.tc_launches
            paged_prefill_attention_int8(qc, kq, vq, bt, 20, ks, vs)
            assert paged_prefill_attention_int8.tc_launches == tc0 + tc
    q = _randn(rng, (1, 70, 16, 192), BF16, dev)
    k, v = _randn(rng, (1, 70, 16, 192), BF16, dev), _randn(rng, (1, 70, 16, 128), BF16, dev)
    tc0 = flash_attention.tc_launches
    _close(flash_attention(q, k, v), R.attention_ref(q, k, v), BF16)
    qm = _randn(rng, (1, 70, 4, 65), BF16, dev)[..., 1:]          # rows 2 bytes off
    assert qm.data_ptr() % 16 != 0
    km, vm = _randn(rng, (1, 70, 4, 64), BF16, dev), _randn(rng, (1, 70, 4, 64), BF16, dev)
    _close(flash_attention(qm, km, vm), R.attention_ref(qm, km, vm), BF16)
    assert flash_attention.tc_launches == tc0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm_1_6b", "internlm2_20b", "jamba_1_5_large_398b"])
def test_bf16_engines_take_the_tensor_core_bodies(dev, arch):
    """bf16 smoke models (hd 16): every flash and paged prefill call of the
    slot and paged engines, fp and int8 pages, takes the tensor-core body."""
    cfg = get_smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    params = init_params(cfg, seed=3, device=dev)
    prompts = [[1, 2, 3], list(range(4, 30)), [7] * 9, list(range(40, 57))]
    engines = [LLMEngine(cfg, max_batch=4, max_len=64, params=params, device=dev)]
    if arch != "jamba_1_5_large_398b":
        engines += [PagedLLMEngine(cfg, max_seqs=4, max_len=64, page_size=8, prefill_chunk=8,
                                   params=params, kv_dtype=kv, device=dev)
                    for kv in ("fp32", "int8")]
    for eng in engines:
        ops.reset_launch_counts()
        for i, p in enumerate(prompts):
            assert eng.admit(Request(rid=i, prompt=p, max_new_tokens=4))
        while eng.batch_size or getattr(eng, "waiting", None):
            eng.step()
        counts, tcs = ops.launch_counts(), ops.tc_launch_counts()
        assert sum(tcs.values()) > 0
        assert all(tcs[name] == counts[name] for name in ops.TC_KERNELS), (counts, tcs)


# ---------------------------------------------------------------------------
# the split-context bodies of slot and paged decode attention
# ---------------------------------------------------------------------------
# (H, K, hd): the smoke configs (g 1 and 3), stablelm-1.6b, internlm2-20b,
# Jamba-1.5-Large and a group of 16 (two row groups a kv head)
# (64, 8, 128): Jamba-1.5-Large, Kimi-K2 and Qwen1.5-110B (g = 8);
# (128, 8, 128): Llama-3-405B (g = 16, one full tensor-core row group)
SPLIT_WIDTHS = [(4, 4, 16), (6, 2, 16), (32, 32, 64), (48, 8, 128), (64, 8, 128),
                (32, 2, 64), (128, 8, 128)]
DECODE_KINDS = ["slot", "paged", "int8"]


def _split_lengths(cap, ps):
    """0, 1, ps, ps + 1, a capacity-long row and mixed lengths in one
    batch, so that some splits of some rows hold no live key."""
    return np.minimum([0, 1, ps, ps + 1, cap, 33, cap // 2 + 3, cap - 7], cap).astype(np.int32)


def _decode_split_case(rng, kind, H, K, hd, dtype, dev, ps=16, npp=16):
    """Inputs of one decode call of ``kind`` (slot, paged, int8) at the
    given widths, the garbage mask and a callable ``run(k, v, scales)``.

    Returns (q, lengths, clean tensors, a poisoner, kernel, plain, counter)."""
    cap = npp * ps
    lens = _split_lengths(cap, ps)
    B = len(lens)
    ln = torch.from_numpy(lens).to(dev)
    q = _randn(rng, (B, H, hd), dtype, dev)
    if kind == "slot":
        kc, vc = _randn(rng, (B, cap, K, hd), dtype, dev), _randn(rng, (B, cap, K, hd), dtype,
                                                                  dev)
        dead = torch.from_numpy(np.arange(cap)[None, :] >= lens[:, None]).to(dev)
        return dict(q=q, ln=ln, k=kc, v=vc, dead=dead, counter=decode_attention,
                    kernel=lambda k, v, s=None: decode_attention(q, k, v, ln),
                    plain=lambda k, v, s=None: R.decode_attention_ref(q, k, v, ln))
    P = B * npp + 3
    bt = rng.permutation(np.arange(1, P))[: B * npp].reshape(B, npp).astype(np.int32)
    live = torch.zeros(P, ps, dtype=torch.bool)
    for b in range(B):
        for t in range(int(lens[b])):
            live[bt[b, t // ps], t % ps] = True
    bt_t = torch.from_numpy(bt).to(dev)
    if kind == "paged":
        kp, vp = _pools(rng, P, ps, K, hd, dtype, dev)
        return dict(q=q, ln=ln, k=kp, v=vp, dead=~live.to(dev), counter=paged_decode_attention,
                    kernel=lambda k, v, s=None: paged_decode_attention(q, k, v, bt_t, ln),
                    plain=lambda k, v, s=None: R.paged_decode_attention_ref(q, k, v, bt_t, ln))
    kq, vq, ks, vs, dead = _int8_case(rng, P, ps, K, hd, live, dev)
    return dict(q=q, ln=ln, k=kq, v=vq, scales=(ks, vs), dead=dead,
                counter=paged_decode_attention_int8,
                kernel=lambda k, v, s=(ks, vs): paged_decode_attention_int8(
                    q, k, v, bt_t, ln, *s),
                plain=lambda k, v, s=(ks, vs): R.paged_decode_attention_ref(
                    q, k, v, bt_t, ln, k_scales=s[0], v_scales=s[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,K,hd", SPLIT_WIDTHS)
@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_split_decode_body_matches_plain_and_ignores_garbage(dev, kind, H, K, hd, dtype):
    """The split body at the main path's widths, f32 and bf16: against the
    plain version with +-99 in every dead slot (int8: +-99 payloads of
    scale 1), zeros at length 0, and the output unchanged to the bit when
    the dead slots hold NaN (int8: when their scales are NaN, Inf or 1e30)."""
    rng = np.random.default_rng(90)
    c = _decode_split_case(rng, kind, H, K, hd, dtype, dev)
    k, v, dead, fn = c["k"], c["v"], c["dead"], c["counter"]
    if kind != "int8":
        k, v = k.clone(), v.clone()
        k[dead], v[dead] = 99.0, -99.0
    before, split0 = fn.launches, fn.split_launches
    got = c["kernel"](k, v)
    assert fn.launches == before + 1 and fn.split_launches == split0 + 1
    assert got.dtype == dtype and got.shape == c["q"].shape
    # row 0 has length 0: zeros (the plain version's additive mask is not
    # defined there)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got[1:], c["plain"](k, v)[1:], dtype)
    if kind == "int8":
        ks, vs = c["scales"]
        for value in GARBAGE_SCALES:
            k2, v2 = _garbage_scales(ks, vs, dead, value)
            assert torch.equal(c["kernel"](k, v, (k2, v2)), got)
    else:
        knan, vnan = c["k"].clone(), c["v"].clone()
        knan[dead], vnan[dead] = float("nan"), float("nan")
        assert torch.equal(c["kernel"](knan, vnan), c["kernel"](c["k"], c["v"]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_split_decode_body_at_every_split_count(dev, monkeypatch, kind, splits, dtype):
    """1, 2, 4 and 8 splits a row (8 over a 16-token capacity: most splits
    hold nothing), at group sizes 2 and 6 (bf16: the tensor-core form; f32:
    two row groups on CUDA cores) and 40 (three tensor-core row groups of
    16), give the plain version's output."""
    monkeypatch.setattr(_build, "decode_splits", lambda *a: splits)
    rng = np.random.default_rng(91)
    for npp, H in ((1, 4), (16, 12), (3, 80)):
        c = _decode_split_case(rng, kind, H, 2, 64, dtype, dev, npp=npp)
        k, v, dead = c["k"], c["v"], c["dead"]
        if kind != "int8":
            k, v = k.clone(), v.clone()
            k[dead], v[dead] = 99.0, -99.0
        split0 = c["counter"].split_launches
        got = c["kernel"](k, v)
        assert c["counter"].split_launches == split0 + 1
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        _close(got[1:], c["plain"](k, v)[1:], dtype)


@pytest.mark.gpu
def test_split_decode_bodies_give_zeros_for_length_zero(dev):
    q = torch.ones(2, 4, 16, device=dev)
    ln = torch.zeros(2, dtype=torch.int32, device=dev)
    nan = torch.full((2, 8, 2, 16), float("nan"), device=dev)
    split0 = decode_attention.split_launches
    out = decode_attention(q, nan, nan, ln)
    assert torch.equal(out, torch.zeros_like(out))
    assert decode_attention.split_launches == split0 + 1
    pool = torch.full((5, 8, 2, 16), float("nan"), device=dev)
    bt = torch.ones(2, 2, dtype=torch.int32, device=dev)
    out = paged_decode_attention(q, pool, pool, bt, ln)
    assert torch.equal(out, torch.zeros_like(out))
    q8 = torch.full((5, 8, 2, 16), 99, dtype=torch.int8, device=dev)
    sc = torch.full((5, 8, 2), float("nan"), device=dev)
    out = paged_decode_attention_int8(q.bfloat16(), q8, q8, bt, ln, sc, sc)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_decode_bodies_read_strided_stacked_views(dev, dtype):
    """Layer views of a stacked slot cache, of stacked pools and scale
    pools, and a slot cache of every other kv head take the split body and
    give the result of their contiguous copies."""
    rng = np.random.default_rng(92)
    B, S, K, hd, H = 3, 200, 2, 64, 12
    stack = _randn(rng, (4, 2, B, S, 2 * K, hd), dtype, dev)     # (layers, k/v, B, S, 2K, hd)
    q = _randn(rng, (B, H, hd), dtype, dev)
    ln = torch.tensor([5, 200, 97], dtype=torch.int32, device=dev)
    counts0, splits0 = ops.launch_counts(), ops.split_launch_counts()
    for kc, vc in ((stack[2, 0, :, :, :K], stack[2, 1, :, :, :K]),
                   (stack[1, 0, :, :, ::2], stack[1, 1, :, :, ::2])):
        assert not kc.is_contiguous()
        got = ops.decode_attention(q, kc, vc, ln)
        assert torch.equal(got, decode_attention(q, kc.contiguous(), vc.contiguous(), ln))
        _close(got, R.decode_attention_ref(q, kc, vc, ln), dtype)
    pools = _randn(rng, (3, 2, 12, 16, K, hd), dtype, dev)        # (layers, k/v, P, ps, K, hd)
    kq, ks = ops.quantize_kv(_randn(rng, (3, 12, 16, K, hd), torch.float32, dev))
    vq, vs = ops.quantize_kv(_randn(rng, (3, 12, 16, K, hd), torch.float32, dev))
    bt = torch.tensor([[4, 9, 2, 7], [11, 3, 1, 5], [6, 8, 10, 0]], dtype=torch.int32,
                      device=dev)
    ln = torch.tensor([17, 64, 1], dtype=torch.int32, device=dev)
    got = ops.paged_decode_attention(q, pools[1, 0], pools[1, 1], bt, ln)
    assert torch.equal(got, paged_decode_attention(q, pools[1, 0].contiguous(),
                                                   pools[1, 1].contiguous(), bt, ln))
    got = ops.paged_decode_attention(q, kq[2], vq[2], bt, ln, k_scales=ks[2], v_scales=vs[2])
    assert torch.equal(got, paged_decode_attention_int8(
        q, kq[2].contiguous(), vq[2].contiguous(), bt, ln, ks[2].contiguous(),
        vs[2].contiguous()))
    counts, splits = ops.launch_counts(), ops.split_launch_counts()
    assert {n: counts[n] - counts0[n] for n in ops.SPLIT_KERNELS} == \
        {n: splits[n] - splits0[n] for n in ops.SPLIT_KERNELS} == \
        {"decode_attention": 4, "paged_decode_attention": 2, "paged_decode_attention_int8": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_refused_decode_shapes_take_the_other_body(dev, dtype):
    """MLA decode's hd 192 / hd_v 128, hd 256 pools and misaligned rows go
    to the one-block-a-row bodies (f32 and bf16 entry points), which still
    match the plain versions; split_launches does not move."""
    rng = np.random.default_rng(93)
    splits0 = ops.split_launch_counts()
    q = _randn(rng, (2, 16, 192), dtype, dev)
    kc, vc = _randn(rng, (2, 40, 16, 192), dtype, dev), _randn(rng, (2, 40, 16, 128), dtype, dev)
    ln = torch.tensor([3, 40], dtype=torch.int32, device=dev)
    _close(decode_attention(q, kc, vc, ln), R.decode_attention_ref(q, kc, vc, ln), dtype)
    q = _randn(rng, (2, 4, 64), dtype, dev)
    kb = _randn(rng, (2, 40, 2, 65), dtype, dev)
    km, vm = kb[..., 1:], kb.flip(0)[..., :64]            # rows off 16 bytes, 65 apart
    assert km.data_ptr() % 16 != 0
    _close(decode_attention(q, km, vm, ln), R.decode_attention_ref(q, km, vm, ln), dtype)
    bt = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32, device=dev)
    lp = torch.tensor([20, 9], dtype=torch.int32, device=dev)
    for hd in (256, 64):
        pool = _randn(rng, (6, 8, 2, hd + 1), dtype, dev)
        kp = pool[..., 1:] if hd == 64 else pool[..., :hd].contiguous()
        vp = kp.flip(0)
        qd = _randn(rng, (2, 4, hd), dtype, dev)
        _close(paged_decode_attention(qd, kp, vp, bt, lp),
               R.paged_decode_attention_ref(qd, kp, vp, bt, lp), dtype)
    kq, ks = ops.quantize_kv(_randn(rng, (6, 8, 2, 256), torch.float32, dev))
    qd = _randn(rng, (2, 4, 256), dtype, dev)
    _close(paged_decode_attention_int8(qd, kq, kq, bt, lp, ks, ks),
           R.paged_decode_attention_ref(qd, kq, kq, bt, lp, k_scales=ks, v_scales=ks), dtype)
    kq, ks = ops.quantize_kv(_randn(rng, (6, 8, 2, 65), torch.float32, dev))
    km = kq[..., 1:]                                      # int8 rows off 16 bytes
    qd = _randn(rng, (2, 4, 64), dtype, dev)
    _close(paged_decode_attention_int8(qd, km, km, bt, lp, ks, ks),
           R.paged_decode_attention_ref(qd, km, km, bt, lp, k_scales=ks, v_scales=ks), dtype)
    assert ops.split_launch_counts() == splits0


@pytest.mark.gpu
def test_decode_wrappers_make_no_host_sync(dev):
    """Neither wrapper reads the lengths (or anything else) back: every
    call runs under torch.cuda.set_sync_debug_mode("error")."""
    rng = np.random.default_rng(94)
    cases = [_decode_split_case(rng, kind, 48, 8, 128, torch.bfloat16, dev)
             for kind in DECODE_KINDS]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [c["kernel"](c["k"], c["v"]) for c in cases]
        outs.append(decode_attention(cases[0]["q"], cases[0]["k"][:, :40], cases[0]["v"][:, :40],
                                     cases[0]["ln"].clamp(max=40)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(o.float()).all()) for o in outs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["stablelm_1_6b", "internlm2_20b", "jamba_1_5_large_398b"])
def test_engines_take_the_split_decode_bodies(dev, arch, dtype):
    """Smoke models (hd 16), f32 and bf16: every slot and paged decode call
    (fp and int8 pages, int8 slot cache) takes the split body."""
    cfg = get_smoke_config(arch).with_(dtype=dtype)
    params = init_params(cfg, seed=3, device=dev)
    prompts = [[1, 2, 3], list(range(4, 30)), [7] * 9, list(range(40, 57))]
    engines = [LLMEngine(c, max_batch=4, max_len=64, params=params, device=dev)
               for c in (cfg, cfg.with_(kv_cache_dtype="int8"))]
    if arch != "jamba_1_5_large_398b":
        engines += [PagedLLMEngine(cfg, max_seqs=4, max_len=64, page_size=8, prefill_chunk=8,
                                   params=params, kv_dtype=kv, device=dev)
                    for kv in ("fp32", "int8")]
    for eng in engines:
        ops.reset_launch_counts()
        for i, p in enumerate(prompts):
            assert eng.admit(Request(rid=i, prompt=p, max_new_tokens=4))
        while eng.batch_size or getattr(eng, "waiting", None):
            eng.step()
        counts, splits = ops.launch_counts(), ops.split_launch_counts()
        assert sum(splits.values()) > 0
        assert all(splits[name] == counts[name] for name in ops.SPLIT_KERNELS), (counts, splits)


# ---------------------------------------------------------------------------
# MLA, shared experts and leading dense layers (DeepSeek-V2-Lite, Kimi-K2)
# ---------------------------------------------------------------------------
def _deepseek_smoke_at_mla_head_dims():
    """DeepSeek-smoke with DeepSeek-V2-Lite's MLA head dims: q/k 128 + 64
    = 192 and v 128, so its prefill takes flash at 192 / 128."""
    cfg = get_smoke_config("deepseek_v2_lite_16b").with_(dtype="float32")
    return cfg.with_(mla=dataclasses.replace(cfg.mla, nope_head_dim=128, rope_head_dim=64,
                                             v_head_dim=128))


@pytest.mark.gpu
def test_mla_prefill_runs_flash_at_192_128(dev):
    """A DeepSeek-smoke prefill at MLA's head dims on the card against the
    CPU: logits and the compressed caches to the float32 tolerance, flash
    once a layer through its CUDA-core body, and the absorbed decode step
    after it."""
    from repro_torch.models import decode_step, prefill

    cfg = _deepseek_smoke_at_mla_head_dims()
    params = init_params(cfg, seed=3, device="cpu")
    toks = torch.tensor([list(range(3, 40)), list(range(50, 87))], dtype=torch.int32)
    out = {}
    for d in ("cpu", dev):
        ops.reset_launch_counts()
        lg, cache = prefill(_to(params, d), cfg, toks.to(d), max_len=64)
        counts, tcs = ops.launch_counts(), ops.tc_launch_counts()
        lg2, cache = decode_step(_to(params, d), cfg, cache, toks[:, 0].to(d))
        out[str(d)] = (lg.cpu(), lg2.cpu(), cache["blocks"]["0"]["c_kv"].cpu(),
                       cache["prefix_0"]["k_rope"].cpu())
    torch.cuda.synchronize()
    for got, want in zip(out[str(dev)], out["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert counts["flash_attention"] == cfg.n_layers and tcs["flash_attention"] == 0
    assert counts["rmsnorm"] == 2 * cfg.n_layers + 1


def _to(params, d):
    from repro_torch.bridge import params_to

    return params_to(params, d)


def _card_and_cpu_tokens(make_engine, cfg, prompts, dev, params=None):
    """Greedy tokens of an engine on the CPU and on the card (same float32
    weights, seed 3 unless given), with more requests than slots, and the
    card run's launches."""
    if params is None:
        params = init_params(cfg, seed=3, device="cpu")
    outs = {}
    for d in ("cpu", dev):
        ops.reset_launch_counts()
        eng = make_engine(cfg, params, d)
        out, pending = {}, list(enumerate(prompts))
        while pending or eng.batch_size or getattr(eng, "waiting", None):
            while pending and eng.can_admit():
                i, p = pending.pop(0)
                assert eng.admit(Request(
                    rid=i, prompt=p, max_new_tokens=6 + i,
                    on_finish=lambda r, out=out: out.__setitem__(r.rid, list(r.out_tokens))))
            eng.step()
        outs[str(d)] = out
    torch.cuda.synchronize()
    assert outs["cpu"] == outs[str(dev)] and len(outs["cpu"]) == len(prompts)
    return eng, ops.launch_counts()


PROMPTS = [[1, 2, 3], list(range(4, 30)), [7] * 9, list(range(40, 57)), [5, 6]]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "kimi_k2_1t_a32b"])
def test_mla_and_shared_expert_slot_engines_on_card_match_cpu_tokens(dev, arch):
    """float32 DeepSeek-smoke (MLA, a leading dense layer, shared experts)
    and Kimi-smoke (GQA, shared expert) through ``LLMEngine``: card and CPU
    give equal greedy tokens; MLA decodes with no attention kernel."""
    cfg = get_smoke_config(arch).with_(dtype="float32")
    eng, counts = _card_and_cpu_tokens(
        lambda c, p, d: LLMEngine(c, max_batch=3, max_len=64, params=p, device=d),
        cfg, PROMPTS, dev)
    n = cfg.n_layers
    assert counts["flash_attention"] == n * eng.admissions
    assert counts["decode_attention"] == (0 if cfg.mla else n) * eng.decode_steps
    assert counts["rmsnorm"] == (2 * n + 1) * (eng.admissions + eng.decode_steps)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "llama3_405b", "qwen1_5_110b"])
def test_new_paged_engines_on_card_match_cpu_tokens(dev, arch):
    cfg = get_smoke_config(arch).with_(dtype="float32")
    eng, counts = _card_and_cpu_tokens(
        lambda c, p, d: PagedLLMEngine(c, max_seqs=3, max_len=64, page_size=8,
                                       prefill_chunk=8, params=p, device=d),
        cfg, PROMPTS, dev)
    n = cfg.n_layers
    assert counts["paged_decode_attention"] == n * eng.decode_steps
    assert counts["paged_prefill_attention"] == n * eng.prefill_chunks


# ---------------------------------------------------------------------------
# the xLSTM, VLM and Whisper families: kernels at their shapes, models
# ---------------------------------------------------------------------------
# (B, Sq, Sk, H, K, hd): Whisper's encoder (Sq = Sk = 1500 = 23 * 64 + 28),
# its cross-attention in prefill and decode, the VLM's cross-attention in
# prefill and decode over 1601 = 25 * 64 + 1 patches
CROSS_CASES = [(1, 1500, 1500, 6, 6, 64), (2, 37, 1500, 6, 6, 64), (4, 1, 1500, 6, 6, 64),
               (1, 256, 1601, 64, 8, 128), (4, 1, 1601, 64, 8, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Sk,H,K,hd", CROSS_CASES)
def test_flash_bidirectional_at_encoder_shapes_ignores_nan_past_sk(dev, B, Sq, Sk, H, K,
                                                                   hd, dtype):
    """Non-causal flash with Sq != Sk (Sq = 1 in decode) over ragged Sk:
    against the plain version, bf16 on the tensor-core body; k and v are
    per-superblock views of stacked ``(n_sb, B, S, K, hd)`` buffers whose
    rows past Sk hold NaN, which must not change the output by a bit."""
    rng = np.random.default_rng(73)
    q = _randn(rng, (B, Sq, H, hd), dtype, dev)
    kb, vb = (_randn(rng, (2, B, Sk + 29, K, hd), dtype, dev) for _ in range(2))
    k, v = kb[1, :, :Sk], vb[1, :, :Sk]
    before, tc0 = flash_attention.launches, flash_attention.tc_launches
    got = flash_attention(q, k, v, causal=False)
    assert flash_attention.launches == before + 1
    assert flash_attention.tc_launches == tc0 + (dtype == BF16)
    _close(got, R.attention_ref(q, k, v, causal=False), dtype)
    kb[:, :, Sk:], vb[:, :, Sk:] = float("nan"), float("nan")
    assert torch.equal(flash_attention(q, kb[1, :, :Sk], vb[1, :, :Sk], causal=False), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_slot_decode_kernel_at_whisper_widths(dev, dtype):
    """H = K = 6, hd = 64 (g = 1): B = 4, S_max = 448, lengths 1, 17, 200
    and 448, tails NaN; every call through the split body."""
    rng = np.random.default_rng(74)
    B, S, H, hd = 4, 448, 6, 64
    lens = np.array([1, 17, 200, 448], np.int32)
    q = _randn(rng, (B, H, hd), dtype, dev)
    kc, vc = _randn(rng, (B, S, H, hd), dtype, dev), _randn(rng, (B, S, H, hd), dtype, dev)
    ln = torch.from_numpy(lens).to(dev)
    split0 = decode_attention.split_launches
    got = decode_attention(q, kc, vc, ln)
    assert decode_attention.split_launches == split0 + 1
    _close(got, R.decode_attention_ref(q, kc, vc, ln), dtype)
    tail = torch.from_numpy(np.arange(S)[None, :] >= lens[:, None]).to(dev)
    kc[tail], vc[tail] = float("nan"), float("nan")
    assert torch.equal(decode_attention(q, kc, vc, ln), got)


@pytest.mark.gpu
def test_xlstm_engine_on_card_matches_cpu_tokens(dev):
    """float32 xLSTM-smoke (3 mLSTM + 1 sLSTM, the recurrence non-zero)
    through ``LLMEngine``: card and CPU give equal greedy tokens with
    mid-stream slot re-use; RMSNorm is the only kernel (once a layer plus
    the final norm per admission and step)."""
    cfg = get_smoke_config("xlstm_350m").with_(dtype="float32")
    params = init_params(cfg, seed=3, device="cpu")
    r = params["blocks"]["3"]["cell"]["r_izfo"]
    r.copy_(torch.randn(r.shape, generator=torch.Generator().manual_seed(4)) * 0.5)
    eng, counts = _card_and_cpu_tokens(
        lambda c, p, d: LLMEngine(c, max_batch=2, max_len=64, params=p, device=d),
        cfg, PROMPTS, dev, params=params)
    assert counts["flash_attention"] == counts["decode_attention"] == 0
    assert counts["rmsnorm"] == (cfg.n_layers + 1) * (eng.admissions + eng.decode_steps)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper_tiny", "llama3_2_vision_90b"])
def test_encdec_models_on_card_match_cpu(dev, arch):
    """float32 Whisper-smoke and Vision-smoke with seeded frames / patches:
    prefill, then 6 greedy ``decode_step``s on the card and on the CPU give
    equal tokens and logits within the model tolerance; launches exact."""
    cfg = get_smoke_config(arch).with_(dtype="float32")
    params = init_params(cfg, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(6)
    enc = torch.randn(2, cfg.encoder.n_ctx, cfg.d_model, generator=gen)
    toks = torch.randint(0, cfg.vocab, (2, 11), generator=gen, dtype=torch.int32)
    from repro_torch.bridge import params_to
    from repro_torch.models import decode_step, prefill

    outs, logits = {}, {}
    for d in ("cpu", dev):
        p = params_to(params, d)
        ops.reset_launch_counts()
        lg, cache = prefill(p, cfg, toks.to(d), max_len=32, enc_input=enc.to(d))
        seq, lgs = [lg.argmax(-1)], [lg]
        for _ in range(6):
            lg, cache = decode_step(p, cfg, cache, seq[-1])
            seq.append(lg.argmax(-1))
            lgs.append(lg)
        outs[str(d)] = torch.stack(seq).cpu()
        logits[str(d)] = torch.stack(lgs).float().cpu()
    torch.cuda.synchronize()
    assert torch.equal(outs["cpu"], outs[str(dev)])
    torch.testing.assert_close(logits[str(dev)], logits["cpu"], atol=1e-4, rtol=1e-4)
    counts = ops.launch_counts()
    n = cfg.n_layers
    if arch == "whisper_tiny":
        e = cfg.encoder.n_layers
        assert counts["flash_attention"] == e + 2 * n + 6 * n
        assert counts["decode_attention"] == 6 * n
        assert counts["rmsnorm"] == (2 * e + 1) + 7 * (3 * n + 1)
    else:
        n_cross = n // cfg.cross_attn_period
        assert counts["flash_attention"] == n + 6 * n_cross
        assert counts["decode_attention"] == 6 * (n - n_cross)
        assert counts["rmsnorm"] == 7 * (2 * n + 1)


# ---------------------------------------------------------------------------
# the trainer: backward kernels, their autograd route, the grad raise
# ---------------------------------------------------------------------------
# a backward kernel against its plain backward on the same inputs, scaled by
# the gradient's largest magnitude: float32 summation order over up to
# Sq * g rows (dk, dv) or Sk keys (dq), and over the rows (dgamma); bf16 adds
# one rounding of each output (TOL's 2e-2)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (B, S_q, S_k, H, K, hd, causal): stablelm-1.6b's training shape,
# internlm2-20b's widths (g = 6, hd 128), a ragged 386, bidirectional with
# S_q != S_k, the smoke widths, Jamba-1.5-Large's (g = 8, hd 128), a causal
# S that is no multiple of the 64-key blocks with g = 3, hd 16 with g = 4,
# causal with S_q < S_k (key blocks that no row reaches: dk, dv zero there);
# every bf16 call here takes the tensor-core body
FLASH_BWD_SHAPES = [(4, 1024, 1024, 32, 32, 64, True), (1, 512, 512, 48, 8, 128, True),
                    (1, 386, 386, 32, 32, 64, True), (2, 200, 333, 6, 2, 64, False),
                    (2, 37, 37, 4, 4, 16, True), (1, 512, 512, 64, 8, 128, True),
                    (2, 333, 333, 12, 4, 64, True), (1, 150, 150, 8, 2, 16, True),
                    (1, 200, 333, 6, 2, 64, True)]


def _bwd_close(got, want, dtype):
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), atol=BWD_TOL[dtype] * scale,
                               rtol=BWD_TOL[dtype])


def _flash_bwd_inputs(dev, dtype, B, Sq, Sk, H, K, hd, causal, seed=41, hd_v=None):
    hd_v = hd_v or hd
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Sq, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Sk, K, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Sk, K, hd_v, generator=g, device=dev).to(dtype)
    do = torch.randn(B, Sq, H, hd_v, generator=g, device=dev).to(dtype)
    o = R.attention_ref(q, k, v, causal=causal)
    lse = R.attention_lse_ref(q, k, causal=causal)
    return q, k, v, o, lse, do


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal", FLASH_BWD_SHAPES)
def test_flash_bwd_kernel_matches_plain_backward(dev, B, Sq, Sk, H, K, hd, causal, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q, k, v, o, lse, do = _flash_bwd_inputs(dev, dtype, B, Sq, Sk, H, K, hd, causal)
    before, tc = flash_attention_bwd.launches, flash_attention_bwd.tc_launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert flash_attention_bwd.launches == before + 1
    assert flash_attention_bwd.tc_launches == tc + (dtype == torch.bfloat16)
    want = R.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _bwd_close(a, b, dtype)
    # deterministic: the same bits again
    assert all(torch.equal(a, b) for a, b in zip(got, flash_attention_bwd(
        q, k, v, o, lse, do, causal=causal)))


# (B, S, H, hd, hd_v, causal) at MLA's head dims: DeepSeek's smoke widths
# (24 / 16, hd no multiple of 16), DeepSeek-V2-Lite's (192 / 128), a ragged S
# with GQA, and bidirectional
MLA_BWD_SHAPES = [(2, 37, 4, 24, 16, True), (1, 386, 16, 192, 128, True),
                  (2, 100, 16, 192, 128, True), (1, 70, 4, 24, 16, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,hd,hd_v,causal", MLA_BWD_SHAPES)
def test_flash_bwd_kernel_at_mla_head_dims(dev, B, S, H, hd, hd_v, causal, dtype):
    """MLA's (hd, hd_v) pairs take the CUDA-core body, f32 and bf16, and
    match the plain backward; a rerun gives the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q, k, v, o, lse, do = _flash_bwd_inputs(dev, dtype, B, S, S, H, H, hd, causal, hd_v=hd_v)
    before, tc = flash_attention_bwd.launches, flash_attention_bwd.tc_launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert flash_attention_bwd.launches == before + 1 and flash_attention_bwd.tc_launches == tc
    want = R.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _bwd_close(a, b, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, flash_attention_bwd(
        q, k, v, o, lse, do, causal=causal)))


# (B, T, D, N, h0, dh_T) of the scan's backward: Jamba-1.5-Large's training
# shape, the smoke config's N = 8, ragged T and D, one step, and T past one
# and several 32-step checkpoints; the lane forms of N = 4 and 13; T at a
# checkpoint, 33 chunks with a one-step tail, one step and one past a
# checkpoint in the one- and two-lane forms, each at a D no multiple of 64
SCAN_BWD_SHAPES = [(1, 1024, 16384, 16, False, False), (2, 13, 128, 8, True, True),
                   (3, 37, 100, 16, True, False), (2, 70, 100, 8, False, True),
                   (4, 1, 16384, 16, True, True), (1, 65, 16384, 16, False, True),
                   (2, 19, 100, 4, True, True), (2, 130, 100, 13, False, True),
                   (2, 64, 100, 16, True, False), (1, 1025, 200, 16, True, True),
                   (3, 33, 70, 4, False, False), (2, 1, 130, 8, False, True),
                   (2, 64, 70, 2, True, True)]
SCAN_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


def _scan_bwd_close(got, want, dtype):
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), atol=SSM_TOL[dtype] * scale,
                               rtol=SSM_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,D,N,with_h0,with_dhT", SCAN_BWD_SHAPES)
def test_ssm_scan_bwd_kernel_matches_plain_backward(dev, B, T, D, N, with_h0, with_dhT,
                                                    dtype):
    """The scan's checkpoints equal h_T of the forward cut there, to the bit;
    every gradient of the backward kernel (B and C strided column slices)
    matches ``ssm_scan_bwd_ref`` within SSM_TOL of its largest magnitude;
    a rerun gives the same bits."""
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd

    rng = np.random.default_rng(36)
    x, dt, A, Bm, Cm, Dk, h0 = _scan_inputs(rng, B, T, D, N, dtype, dev)
    # B and C as column slices of one projection, as the Mamba layer has them
    proj = torch.cat([torch.zeros_like(Bm[..., :1]).expand(B, T, 5), Bm, Cm], dim=-1)
    Bm, Cm = proj[..., 5:5 + N], proj[..., 5 + N:]
    assert not Bm.is_contiguous()
    h0 = h0 if with_h0 else None
    g = torch.Generator(device=dev).manual_seed(37)
    dy = torch.randn(B, T, D, generator=g, device=dev).to(dtype)
    dhT = 0.5 * torch.randn(B, D, N, generator=g, device=dev) if with_dhT else None
    y, hT, states = ssm_scan(x, dt, A, Bm, Cm, Dk, h0=h0, return_states=True)
    assert torch.equal(y, ssm_scan(x, dt, A, Bm, Cm, Dk, h0=h0)[0])
    step = _build.SSM_CKPT_STEPS
    assert states.shape == (B, _build.ssm_checkpoints(T), D, N)
    assert torch.equal(states[:, 0], torch.zeros_like(hT) if h0 is None else h0)
    for i, t in enumerate(range(step, T, step), start=1):
        cut = ssm_scan(x[:, :t], dt[:, :t], A, Bm[:, :t], Cm[:, :t], Dk, h0=h0)[1]
        assert torch.equal(states[:, i], cut)
    before = ssm_scan_bwd.launches
    got = ssm_scan_bwd(x, dt, A, Bm, Cm, Dk, states, dy, h0=h0, dhT=dhT)
    assert ssm_scan_bwd.launches == before + 1
    want = R.ssm_scan_bwd_ref(x, dt, A, Bm, Cm, Dk, dy, h0=h0, dhT=dhT)
    for name, a, b in zip(SCAN_GRADS, got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.is_contiguous(), name
        _scan_bwd_close(a, b, dtype)
    again = ssm_scan_bwd(x, dt, A, Bm, Cm, Dk, states, dy, h0=h0, dhT=dhT)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_ssm_scan_bwd_kernel_refuses_what_it_does_not_take(dev):
    x = torch.zeros(1, 70, 64, device=dev)
    A = torch.zeros(64, 16, device=dev)
    BC = torch.zeros(1, 70, 16, device=dev)
    D = torch.zeros(64, device=dev)
    good = torch.zeros(1, _build.ssm_checkpoints(70), 64, 16, device=dev)
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd

    ssm_scan_bwd(x, x, A, BC, BC, D, good, x)
    with pytest.raises(ValueError, match="states"):
        ssm_scan_bwd(x, x, A, BC, BC, D, good[:, :1].contiguous(), x)
    with pytest.raises(ValueError, match="dy"):
        ssm_scan_bwd(x, x, A, BC, BC, D, good, x[:, :69])
    with pytest.raises(ValueError, match="dhT"):
        ssm_scan_bwd(x, x, A, BC, BC, D, good, x, dhT=torch.zeros(1, 64, 8, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lanes,shape", LANE_FORM_CASES)
def test_ssm_scan_bwd_every_lane_form_matches_plain(dev, monkeypatch, lanes, shape, dtype):
    """Each lanes-a-channel form of the backward (the forward's checkpoints
    from the same form) at every shape whose N it holds, h0 and dh_T given,
    against the plain backward; a rerun gives the same bits."""
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd

    B, T, D, N = shape
    monkeypatch.setattr(_build, "ssm_scan_lanes", lambda n: lanes)
    x, dt, A, Bm, Cm, Dk, h0 = _scan_inputs(np.random.default_rng(63), B, T, D, N, dtype, dev)
    g = torch.Generator(device=dev).manual_seed(64)
    dy = torch.randn(B, T, D, generator=g, device=dev).to(dtype)
    dhT = 0.5 * torch.randn(B, D, N, generator=g, device=dev)
    states = ssm_scan(x, dt, A, Bm, Cm, Dk, h0=h0, return_states=True)[2]
    got = ssm_scan_bwd(x, dt, A, Bm, Cm, Dk, states, dy, h0=h0, dhT=dhT)
    want = R.ssm_scan_bwd_ref(x, dt, A, Bm, Cm, Dk, dy, h0=h0, dhT=dhT)
    for name, a, b in zip(SCAN_GRADS, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        _scan_bwd_close(a, b, dtype)
    again = ssm_scan_bwd(x, dt, A, Bm, Cm, Dk, states, dy, h0=h0, dhT=dhT)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("vector", [True, False])
def test_ssm_scan_bwd_form_at_n16_runs_two_ctas_a_sm(dev, dtype, vector):
    """Both forms N = 16 launches (4 lanes a channel; 16-byte rows or any
    strides) spill nothing and hold at most 128 registers a thread and half a
    SM's shared memory, so two CTAs share a SM (Jamba's 256 CTAs: one wave on
    an H100's 132 SMs)."""
    form = _build.ssm_scan_bwd_form(dtype, 16, dev.index or 0, vector)
    assert form["spill_bytes"] == 0 and form["registers"] <= 128, form
    assert form["ctas_per_sm"] >= 2, form


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_lse_matches_plain(dev, dtype, causal):
    for (B, Sq, Sk, H, K, hd) in ((1, 386, 386, 32, 32, 64), (2, 200, 333, 48, 8, 128)):
        if causal and Sq != Sk:
            continue
        q, k, v, _, lse, _ = _flash_bwd_inputs(dev, dtype, B, Sq, Sk, H, K, hd, causal)
        out, got = flash_attention(q, k, v, causal=causal, return_lse=True)
        assert got.dtype == torch.float32 and got.shape == (B, H, Sq)
        torch.testing.assert_close(got, lse, atol=1e-4, rtol=1e-5)
        assert torch.equal(out, flash_attention(q, k, v, causal=causal))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_bwd_kernel_ignores_nan_past_sk_and_takes_strided_inputs(dev, dtype):
    """K/V past Sk (NaN here) are never read; q, k, v and do strided views
    (transposed (B, H, S, hd) storage) give the contiguous inputs' bits."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    B, S, H, K, hd, pad = 1, 386, 6, 2, 64, 62
    q, k, v, o, lse, do = _flash_bwd_inputs(dev, dtype, B, S, S, H, K, hd, True)
    kbuf = torch.full((B, S + pad, K, hd), float("nan"), device=dev, dtype=dtype)
    vbuf = kbuf.clone()
    kbuf[:, :S], vbuf[:, :S] = k, v
    clean = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    poisoned = flash_attention_bwd(q, kbuf[:, :S], vbuf[:, :S], o, lse, do, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(clean, poisoned))
    qs, ks, vs, dos = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v, do))
    strided = flash_attention_bwd(qs, ks, vs, o, lse, dos, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(clean, strided))


@pytest.mark.gpu
@pytest.mark.parametrize("misalign", ["rows", "base"])
def test_flash_bwd_kernel_off_16_bytes_takes_the_cuda_core_body(dev, misalign):
    """bf16 rows that are not 16-byte aligned (q and do sliced from rows of
    65 head dims, or every input one element past a 16-byte base) go to the
    CUDA-core body, and match the plain backward as the aligned call does."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    dt = torch.bfloat16
    B, S, H, K, hd = 1, 200, 6, 2, 64
    q, k, v, o, lse, do = _flash_bwd_inputs(dev, dt, B, S, S, H, K, hd, True)
    if misalign == "rows":
        wide = [torch.zeros(B, S, H, hd + 1, device=dev, dtype=dt) for _ in range(2)]
        wide[0][..., :hd], wide[1][..., :hd] = q, do
        args = (wide[0][..., :hd], k, v, o, lse, wide[1][..., :hd])
    else:
        args = []
        for t in (q, k, v, o, None, do):
            if t is None:
                args.append(lse)
                continue
            buf = torch.zeros(t.numel() + 1, device=dev, dtype=dt)
            buf[1:] = t.flatten()
            args.append(buf[1:].view(t.shape))
    before, tc = flash_attention_bwd.launches, flash_attention_bwd.tc_launches
    got = flash_attention_bwd(*args, causal=True)
    assert flash_attention_bwd.launches == before + 1 and flash_attention_bwd.tc_launches == tc
    want = R.attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    for a, b in zip(got, want):
        _bwd_close(a, b, dt)
    assert all(torch.equal(a, b) for a, b in zip(got, flash_attention_bwd(*args, causal=True)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4096, 2048), (386, 2048), (7, 100), (2, 3, 8192),
                                   (512, 8192), (16, 28672), (1, 2048), (1, 28672)])
def test_rmsnorm_bwd_kernel_matches_plain_backward(dev, shape, dtype):
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd

    g = torch.Generator(device=dev).manual_seed(42)
    x = torch.randn(shape, generator=g, device=dev).mul(3).to(dtype)
    gamma = (1 + 0.2 * torch.randn(shape[-1:], generator=g, device=dev)).to(dtype)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    before = rmsnorm_bwd.launches
    dx, dg = rmsnorm_bwd(x, gamma, dy)
    assert rmsnorm_bwd.launches == before + 1
    wx, wg = R.rmsnorm_bwd_ref(x, gamma, dy)
    assert dx.dtype == dg.dtype == dtype
    _bwd_close(dx, wx, dtype)
    _bwd_close(dg, wg, dtype)
    assert all(torch.equal(a, b) for a, b in zip((dx, dg), rmsnorm_bwd(x, gamma, dy)))


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_inputs_that_require_grad(dev):
    q = torch.randn(1, 16, 4, 64, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="requires grad"):
        rmsnorm(q[0, :, 0], torch.ones(64, device=dev))
    with torch.no_grad():
        flash_attention(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_ops_route_grad_through_the_backward_kernels(dev, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd

    q, k, v, _, _, do = _flash_bwd_inputs(dev, dtype, 2, 96, 96, 6, 2, 64, True)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ops.reset_launch_counts()
    o = ops.attention(q, k, v, causal=True)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(o, (q, k, v), do)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == counts["flash_attention_bwd"] == 1
    ref = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(R.attention_ref(*ref, causal=True), ref, do)
    for a, b in zip(got, want):
        _bwd_close(a, b, dtype)
    x = torch.randn(3, 5, 2048, device=dev).to(dtype).requires_grad_()
    gamma = torch.ones(2048, device=dev, dtype=dtype).requires_grad_()
    y = ops.rmsnorm(x, gamma)
    assert type(y.grad_fn).__name__ == "_RMSNormBackward"
    y.float().square().sum().backward()
    assert ops.launch_counts()["rmsnorm_bwd"] == 1 and x.grad is not None
    assert gamma.grad is not None and gamma.grad.dtype == dtype
    assert flash_attention_bwd.launches == rmsnorm_bwd.launches == 1
    # MLA's head dims: through _FlashAttention and the backward kernel's
    # CUDA-core body
    qm, km, vm, _, _, dom = _flash_bwd_inputs(dev, dtype, 1, 70, 70, 4, 4, 192, True,
                                              hd_v=128)
    qm, km, vm = (t.requires_grad_() for t in (qm, km, vm))
    tc = flash_attention_bwd.tc_launches
    om = ops.attention(qm, km, vm, causal=True)
    assert type(om.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(om, (qm, km, vm), dom)
    assert flash_attention_bwd.launches == 2 and flash_attention_bwd.tc_launches == tc
    ref = [t.detach().requires_grad_() for t in (qm, km, vm)]
    want = torch.autograd.grad(R.attention_ref(*ref, causal=True), ref, dom)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _bwd_close(a, b, dtype)
    # the scan: through _SSMScan and its backward kernel
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd

    x, dt, A, Bm, Cm, Dk, h0 = _scan_inputs(np.random.default_rng(38), 2, 70, 100, 16, dtype,
                                            dev)
    leaves = [t.requires_grad_() for t in (x, dt, A, Dk, h0)]
    proj = torch.cat([Bm, Cm], dim=-1).requires_grad_()
    y, h = ops.ssm_scan(x, dt, A, proj[..., :16], proj[..., 16:], Dk, h0=h0)
    assert type(y.grad_fn).__name__ == "_SSMScanBackward"
    assert ops.launch_counts()["ssm_scan"] == 1
    got = torch.autograd.grad((y.float().square().sum() + h.sum()), leaves + [proj])
    assert ssm_scan_bwd.launches == 1
    ref = [t.detach().requires_grad_() for t in leaves + [proj]]
    yr, hr = R.ssm_scan_ref(ref[0], ref[1], ref[2], ref[5][..., :16], ref[5][..., 16:], ref[3],
                            h0=ref[4])
    want = torch.autograd.grad(yr.float().square().sum() + hr.sum(), ref)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        _scan_bwd_close(a, b, dtype)


def _train_launches(counts, cfg, passes):
    """Every forward kernel call of ``passes`` train passes ran its backward
    once; the scan once a Mamba layer a pass; without an encoder, flash once
    an attention or MLA layer and RMSNorm as a prefill pass takes it; no
    serving kernel."""
    from repro_torch.models import layer_kind

    kinds = [layer_kind(cfg, i).split("+") for i in range(cfg.n_layers)]
    mixers = [m for m, _ in kinds]
    for fwd in ("flash_attention", "rmsnorm", "ssm_scan"):
        assert counts[fwd] == counts[fwd + "_bwd"], (fwd, counts)
    assert counts["ssm_scan_bwd"] == mixers.count("mamba") * passes
    assert counts["rmsnorm_bwd"] > 0
    if cfg.family not in ("vlm", "audio"):
        norms = 1 + sum(2 if f != "none" else 1 for _, f in kinds)
        n_attn = mixers.count("attn") + mixers.count("mla")
        assert counts["flash_attention_bwd"] == n_attn * passes
        assert counts["rmsnorm_bwd"] == norms * passes
    train = ("flash_attention", "rmsnorm", "ssm_scan")
    assert not {k: v for k, v in counts.items() if v and k.replace("_bwd", "") not in train}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_on_the_card_matches_the_cpu(dev, arch):
    """Each smoke config in float32, the same weights: one train step's
    loss, grad norm and per-leaf gradients on the card (kernels forward and
    backward: Jamba's scan through its backward kernel, DeepSeek's MLA
    through the flash backward at 24 / 16) against the CPU (plain
    versions), launches counted."""
    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.distributed.optimizer import OptConfig, init_opt_state
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.zoo import build_train_step, loss_and_grads

    cfg = get_smoke_config(arch).with_(dtype="float32")
    params = params_to_numpy(init_params(cfg, 0, device="cpu"))
    batch = synthetic_batch(np.random.default_rng(0), cfg, 4, 64)
    res = {}
    for d in ("cpu", dev):
        p = params_from_numpy(params, d)     # a copy of its own: the step updates in place
        b = {k: t.to(d) for k, t in batch.items()}
        ops.reset_launch_counts()
        loss, grads = loss_and_grads(p, cfg, b)
        opt = OptConfig(lr=1e-3, warmup_steps=5)
        _, _, m = build_train_step(cfg, opt)(p, init_opt_state(p, opt), b)
        res[str(d)] = (float(loss), float(m["grad_norm"]), grads, ops.launch_counts())
    torch.cuda.synchronize()
    (lc, nc, gc, _), (lg, ng, gg, counts) = res["cpu"], res[str(dev)]
    assert abs(lg - lc) <= 1e-5 * abs(lc) and abs(ng - nc) <= 1e-4 * nc
    from repro_torch.distributed.optimizer import tree_leaves

    for a, b in zip(tree_leaves(gg), tree_leaves(gc)):
        _bwd_close(a.cpu(), b, torch.float32)
    _train_launches(counts, cfg, 2)     # two calls: loss_and_grads, then the train step


@pytest.mark.gpu
def test_card_train_step_reaches_no_plain_version(dev, monkeypatch):
    """The Jamba smoke config's train step on the card with every plain
    version of a ported kernel, forward and backward, made to raise: the
    CUDA tensors under grad go through the kernels and nowhere else."""
    from repro_torch.distributed.optimizer import OptConfig, init_opt_state, tree_leaves
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.zoo import build_train_step

    def refused(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("attention_ref", "rmsnorm_ref", "ssm_scan_ref", "attention_bwd_ref",
                 "rmsnorm_bwd_ref", "ssm_scan_bwd_ref"):
        monkeypatch.setattr(R, name, refused)
    cfg = get_smoke_config("jamba_1_5_large_398b").with_(dtype="float32")
    p = init_params(cfg, 0, device=dev)
    opt = OptConfig(lr=1e-3, warmup_steps=5)
    ops.reset_launch_counts()
    _, _, m = build_train_step(cfg, opt)(p, init_opt_state(p, opt),
                                         synthetic_batch(np.random.default_rng(0), cfg, 2, 70, dev))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(p))
    _train_launches(ops.launch_counts(), cfg, 1)
    assert ops.launch_counts()["ssm_scan_bwd"] > 0


# ---------------------------------------------------------------------------
# the sharded paths at world size 1 over NCCL (chip_smoke.py's ``sharded``)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def card_mesh(tmp_path_factory):
    """A (data 1, model 1) mesh on the card over a one-rank NCCL group."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the NCCL group and the CUDA kernels")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def _sharded(tree, mesh, specs):
    from repro_torch.distributed import sharding as shd

    return shd.device_put_tree(tree, shd.tree_shardings(specs, tree, mesh))


@pytest.mark.gpu
@pytest.mark.parametrize("dispatch", ["bfloat16", "int8"])
def test_sharded_moe_ep_on_the_card_matches_moe_block(dev, card_mesh, dispatch):
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models.layers import mlp

    base = get_smoke_config("deepseek_v2_lite_16b").with_(dtype="float32")
    cfg = base.with_(moe=dataclasses.replace(base.moe, impl="ep", dispatch_dtype=dispatch))
    p = M.init_moe(L.Init(0, torch.float32, dev), cfg)
    x = torch.randn(4, 16, cfg.d_model, generator=torch.Generator(dev).manual_seed(1),
                    device=dev)
    if dispatch == "int8":  # the experts see each row through the int8 round trip
        w, ids = M._routing(p, cfg, x.reshape(-1, cfg.d_model))
        q8, scl = M._q8_rows(x.reshape(-1, cfg.d_model))
        want = M._routed_sum((q8.float() * scl[:, None]), w, ids, p["w_gate"], p["w_up"],
                             p["w_down"]) + mlp(p["shared"], x.reshape(-1, cfg.d_model))
        want = want.reshape(x.shape)
    else:
        want = M.moe_block(p, cfg, x)
    with shd.use_mesh(card_mesh):
        M.reset_ep_calls()
        got = M.moe_block(_sharded(p, card_mesh, M.init_moe(L.SpecInit(), cfg)), cfg, x)
        assert M.EP_CALLS["ep_body"] == 1 and M.EP_CALLS["fallback"] == 0
    torch.testing.assert_close(got.full_tensor(), want, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_sharded_mlp_ws_decode_on_the_card_matches_mlp(dev, card_mesh):
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L

    cfg = get_smoke_config("stablelm_1_6b").with_(dtype="float32")
    p = L.init_mlp(L.Init(0, torch.float32, dev), cfg.d_model, cfg.d_ff)
    x = torch.randn(4, 1, cfg.d_model, generator=torch.Generator(dev).manual_seed(1),
                    device=dev)
    with shd.use_mesh(card_mesh):
        got = L.mlp_ws_decode(
            _sharded(p, card_mesh, L.init_mlp(L.SpecInit(), cfg.d_model, cfg.d_ff)), cfg, x)
    torch.testing.assert_close(got.full_tensor(), L.mlp(p, x), atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("decode_mlp", ["auto", "ws"])
@pytest.mark.parametrize("arch", ["stablelm_1_6b", "internlm2_20b"])
def test_sharded_decode_on_the_card_matches_unsharded(dev, card_mesh, arch, decode_mlp):
    """float32 greedy tokens equal, and the slot kernels launch under the
    mesh; with ``decode_mlp="ws"`` the weight-stationary MLP runs at every
    decode step (without a mesh it is ``mlp``)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import decode_step, prefill
    from repro_torch.models import layers as L
    from repro_torch.models.zoo import param_specs

    cfg = get_smoke_config(arch).with_(dtype="float32", decode_mlp=decode_mlp)
    params = init_params(cfg, 0, dev)
    toks = torch.randint(0, cfg.vocab, (4, 12), generator=torch.Generator(dev).manual_seed(2),
                         device=dev)

    def greedy(ps):
        lg, cache = prefill(ps, cfg, toks, max_len=32)
        out = []
        for _ in range(5):
            lg = lg.full_tensor() if shd.is_dtensor(lg) else lg
            out.append(lg.argmax(-1))
            lg, cache = decode_step(ps, cfg, cache, out[-1])
        return torch.stack(out, 1)

    want = greedy(params)
    with shd.use_mesh(card_mesh):
        ps = _sharded(params, card_mesh, param_specs(cfg))
        ops.reset_launch_counts()
        L.reset_ws_calls()
        got = greedy(ps)
        counts = ops.launch_counts()
    assert torch.equal(got, want)
    for name in ("flash_attention", "decode_attention", "rmsnorm"):
        assert counts[name] > 0, name
    ws_steps = 5 * cfg.n_layers if decode_mlp == "ws" else 0
    assert L.WS_CALLS == {"ws_body": ws_steps, "fallback": 0}


@pytest.mark.gpu
def test_compressed_psum_on_the_card_equals_compress_decompress(dev, card_mesh):
    from repro_torch.distributed import compression as comp

    x = torch.randn(64, 96, generator=torch.Generator(dev).manual_seed(3), device=dev)
    assert torch.equal(comp.compressed_psum(x, card_mesh.get_group("data")),
                       comp.compress_decompress(x)[0])


@pytest.mark.gpu
def test_restore_onto_the_card_mesh_is_bit_equal(dev, card_mesh, tmp_path):
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.zoo import param_specs

    cfg = get_smoke_config("internlm2_20b")
    params = init_params(cfg, 0, dev)
    sh = shd.tree_shardings(param_specs(cfg), params, card_mesh)
    ckpt.save_checkpoint(str(tmp_path), 2, shd.device_put_tree(params, sh))
    restored, step = ckpt.restore_checkpoint(str(tmp_path), like=params, shardings=sh)
    assert step == 2
    for name in ("embedding", "lm_head", "final_norm"):
        assert shd.is_dtensor(restored[name])
        assert torch.equal(restored[name].to_local(), params[name])
    for k, v in restored["blocks"]["0"]["attn"].items():
        assert torch.equal(v.to_local(), params["blocks"]["0"]["attn"][k])
