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

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models import init_params
from repro_torch.serving import LLMEngine, PagedLLMEngine, Request

# tolerances of tests/test_paged_kernels.py
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]
# (H, K, hd, ps): the two smoke configs, stablelm-1.6b and internlm2-20b widths
WIDTHS = [(4, 4, 16, 8), (6, 2, 16, 8), (32, 32, 64, 16), (48, 8, 128, 16)]
# (H, K, hd, hd_v) of the slot kernels: stablelm-1.6b, internlm2-20b, MLA
SLOT_WIDTHS = [(32, 32, 64, 64), (48, 8, 128, 128), (16, 16, 192, 128)]


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
