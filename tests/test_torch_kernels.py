"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's entry points run the plain PyTorch versions, so
these hold :mod:`repro_torch.kernels.ref` against the Pallas kernels in
interpret mode (the same calls as ``tests/test_paged_kernels.py``, with
its tolerances and its finite garbage-page poisoning) on the same numpy
inputs.  The hand-written CUDA kernels run only on a GPU; they are held
against the plain versions in ``tests/test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels import ref as JR
from repro.kernels.paged_attention import (
    paged_decode_attention as pallas_decode,
    paged_prefill_attention as pallas_prefill,
)
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels.paged_attention import (
    paged_decode_attention as cuda_decode,
    paged_prefill_attention as cuda_prefill,
)
from repro_torch.kernels.rmsnorm import rmsnorm as cuda_rmsnorm

# tolerances of tests/test_paged_kernels.py: f32 summation order only;
# bf16 one rounding of the output
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same numpy values as a JAX array and a CPU tensor of ``dtype``."""
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _poison_decode(rng, B, H, K, hd, ps, npp, lens):
    """Pools whose unreferenced pages and per-row tails hold ±99 / ±77."""
    P = B * npp + 3
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    vp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[: B * npp].reshape(B, npp).astype(np.int32)
    referenced = set(bt.reshape(-1).tolist())
    for p in range(P):
        if p not in referenced:
            kp[p], vp[p] = 99.0, -99.0
    for b in range(B):
        for j in range(npp):
            lo = max(0, int(lens[b]) - j * ps)
            if lo < ps:
                kp[bt[b, j], lo:], vp[bt[b, j], lo:] = 77.0, -77.0
    return q, kp, vp, bt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "H,K,hd,ps,npp",
    [
        (4, 4, 16, 8, 4),       # stablelm-smoke: MHA, hd 16
        (6, 2, 16, 8, 4),       # internlm2-smoke: GQA g=3, hd 16
        (8, 8, 64, 16, 3),      # MHA, hd 64
        (12, 2, 64, 16, 3),     # GQA g=6, hd 64
    ],
)
def test_paged_decode_ref_matches_pallas(H, K, hd, ps, npp, dtype):
    rng = np.random.default_rng(11)
    lens = np.array([1, ps, ps + 1, npp * ps - 3], np.int32)
    q, kp, vp, bt = _poison_decode(rng, len(lens), H, K, hd, ps, npp, lens)
    qj, qt = _pair(q, dtype)
    kj, kt = _pair(kp, dtype)
    vj, vt = _pair(vp, dtype)
    want = pallas_decode(qj, kj, vj, jnp.asarray(bt), jnp.asarray(lens),
                         interpret=True)
    got = ops.paged_decode_attention(qt, kt, vt, torch.from_numpy(bt),
                                     torch.from_numpy(lens))
    assert got.dtype == TDT[dtype] and got.shape == (len(lens), H, hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "H,K,hd,ps,past,C",
    [
        (4, 4, 16, 8, 0, 8),      # stablelm-smoke, first chunk
        (6, 2, 16, 8, 8, 8),      # internlm2-smoke, aligned continuation
        (6, 2, 16, 8, 12, 7),     # non-aligned past and tail
        (8, 8, 64, 16, 17, 23),   # MHA hd 64, multi-page chunk
        (12, 2, 64, 16, 5, 3),    # GQA g=6 hd 64, chunk inside one page
    ],
)
def test_paged_prefill_ref_matches_pallas(H, K, hd, ps, past, C, dtype):
    rng = np.random.default_rng(12)
    ctx = past + C
    npp = -(-ctx // ps) + 2
    P = npp + 4
    q = rng.normal(size=(C, H, hd)).astype(np.float32)
    kp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    vp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[:npp].astype(np.int32)
    for p in range(P):
        if p not in set(bt.tolist()):
            kp[p], vp[p] = 99.0, -99.0
    n_ctx = -(-ctx // ps)
    tail = ctx - (n_ctx - 1) * ps
    kp[bt[n_ctx - 1], tail:], vp[bt[n_ctx - 1], tail:] = 77.0, -77.0
    qj, qt = _pair(q, dtype)
    kj, kt = _pair(kp, dtype)
    vj, vt = _pair(vp, dtype)
    want = pallas_prefill(qj, kj, vj, jnp.asarray(bt), past, interpret=True)
    got = ops.paged_prefill_attention(qt, kt, vt, torch.from_numpy(bt), past)
    assert got.dtype == TDT[dtype] and got.shape == (C, H, hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 96), (7, 2048)])
def test_rmsnorm_ref_matches_pallas(shape, dtype):
    rng = np.random.default_rng(13)
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    gamma = rng.normal(size=shape[-1:]).astype(np.float32)
    xj, xt = _pair(x, dtype)
    gj, gt = _pair(gamma, dtype)
    want = pallas_rmsnorm(xj, gj, eps=1e-5, interpret=True)
    got = ops.rmsnorm(xt, gt, eps=1e-5)
    assert got.dtype == TDT[dtype] and got.shape == shape
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=TOL[dtype])


def test_gather_and_dense_refs_match_jax():
    """The dense oracles under the paged ones agree with JAX's too."""
    rng = np.random.default_rng(14)
    pages = rng.normal(size=(9, 4, 2, 16)).astype(np.float32)
    bt = np.array([[3, 1, 7], [2, 8, 5]], np.int32)
    np.testing.assert_array_equal(
        _np(TR.gather_pages(torch.from_numpy(pages), torch.from_numpy(bt))),
        _np(JR.gather_pages(jnp.asarray(pages), jnp.asarray(bt))),
    )
    q = rng.normal(size=(2, 5, 6, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    kv_len = np.array([9, 6], np.int32)
    got = TR.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), q_offset=4,
                           kv_len=torch.from_numpy(kv_len))
    want = JR.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            q_offset=4, kv_len=jnp.asarray(kv_len))
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["float32"],
                               rtol=TOL["float32"])


def test_ops_dispatch_rules_on_cpu():
    """'auto' takes the plain version for CPU tensors; 'cuda' on a CPU
    tensor raises instead of falling back; unknown impls raise."""
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    g = torch.ones(32)
    torch.testing.assert_close(ops.rmsnorm(x, g), TR.rmsnorm_ref(x, g),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.rmsnorm(x, g, impl="ref"),
                               TR.rmsnorm_ref(x, g), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.rmsnorm(x, g, impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        ops.rmsnorm(x, g, impl="pallas")
    q = torch.zeros(1, 2, 16)
    pool = torch.zeros(3, 4, 2, 16)
    bt = torch.ones(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.paged_decode_attention(q, pool, pool, bt, lens, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.paged_prefill_attention(q, pool, pool, bt[0], 0, impl="cuda")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch or raise: a CPU tensor never reaches a kernel
    and never silently takes the plain path there."""
    before = ops.launch_counts()
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_rmsnorm(x, torch.ones(8))
    q = torch.zeros(1, 2, 16)
    pool = torch.zeros(3, 4, 2, 16)
    bt = torch.ones(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_decode(q, pool, pool, bt, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_prefill(q, pool, pool, bt[0], 0)
    assert ops.launch_counts() == before
