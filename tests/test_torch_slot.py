"""The port's slot path against the JAX package's: kernels, model, engine.

On the CPU the port's entry points run the plain PyTorch versions of the
kernels, so these hold

- :func:`repro_torch.kernels.ref.attention_ref` and
  :func:`~repro_torch.kernels.ref.decode_attention_ref` against the Pallas
  ``flash_attention`` and ``decode_attention`` kernels in interpret mode
  (a subset of ``tests/test_kernels.py``'s shapes, its tolerances, and its
  length-poisoning property);
- ``prefill``/``decode_step`` logits and slot caches against the JAX
  model's on bridged float32 weights;
- ``LLMEngine(device="cpu")`` against the JAX ``LLMEngine`` token for
  token.

The CUDA kernels themselves are held against the plain versions on the
card in ``tests/test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention as cuda_decode
from repro_torch.kernels.flash_attention import flash_attention as cuda_flash
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.serving import LLMEngine, Request

# tolerances of tests/test_kernels.py: f32 summation order only; bf16 one
# rounding of the output
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# logits of the float32 smoke models: summation order only
MODEL_TOL = 1e-4


def _pair(a: np.ndarray, dtype: str):
    """The same numpy values as a JAX array and a CPU tensor of ``dtype``."""
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# kernels: plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,K,hd,hd_v,causal",
    [
        (1, 128, 4, 4, 64, 64, True),      # MHA
        (2, 64, 8, 2, 64, 64, True),       # GQA g=4
        (2, 128, 4, 1, 128, 128, True),    # MQA
        (1, 96, 4, 2, 64, 64, True),       # ragged Sq = 96
        (1, 96, 6, 6, 32, 32, False),      # bidirectional, ragged
        (1, 64, 4, 4, 192, 128, True),     # MLA: hd_v != hd
    ],
)
def test_attention_ref_matches_pallas_flash(B, S, H, K, hd, hd_v, causal, dtype):
    rng = np.random.default_rng(41)
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd_v))]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrays)
    want = pallas_flash(jq, jk, jv, causal=causal, interpret=True,
                        block_q=64, block_k=64)
    got = ops.attention(tq, tk, tv, causal=causal)
    assert got.shape == (B, S, H, hd_v) and got.dtype == TDT[dtype]
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,K,hd,hd_v,block_k",
    [
        (2, 512, 8, 2, 64, 64, 128),     # GQA g=4
        (3, 320, 4, 1, 64, 64, 128),     # MQA, ragged length vs block
        (2, 256, 4, 4, 192, 128, 128),   # MLA head dims
    ],
)
def test_decode_attention_ref_matches_pallas(B, S, H, K, hd, hd_v, block_k, dtype):
    rng = np.random.default_rng(42)
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((B, H, hd), (B, S, K, hd), (B, S, K, hd_v))]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrays)
    lens = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    want = pallas_decode(jq, jk, jv, jnp.asarray(lens), interpret=True,
                         block_k=block_k)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.shape == (B, H, hd_v) and got.dtype == TDT[dtype]
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("lens", [[1, 256], [17, 64, 200], [255, 3, 128, 1]])
def test_decode_attention_ignores_poisoned_tails(lens):
    """Cache rows at or past each length must not change the output."""
    rng = np.random.default_rng(43)
    B, S, H, K, hd = len(lens), 256, 4, 2, 64
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kc = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    vc = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    kc2, vc2 = kc.copy(), vc.copy()
    for b, n in enumerate(lens):
        kc2[b, n:], vc2[b, n:] = 99.0, -99.0
    lens_np = np.asarray(lens, np.int32)
    outs = [ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(lens_np))
            for k, v in ((kc, vc), (kc2, vc2))]
    _close(outs[0], outs[1], 1e-5)
    want = pallas_decode(jnp.asarray(q), jnp.asarray(kc2), jnp.asarray(vc2),
                         jnp.asarray(lens_np), interpret=True, block_k=64)
    _close(outs[1], want, TOL["float32"])


def test_kernel_routes_refuse_what_the_tpu_kernels_refuse():
    q = torch.zeros(1, 8, 2, 16)
    kv_len = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="kv_len"):
        cuda_flash(q, q, q, kv_len=kv_len)
    with pytest.raises(NotImplementedError, match="q_offset"):
        cuda_flash(q, q, q, causal=True, q_offset=3)
    # a CPU tensor never reaches a kernel: impl="cuda" and the wrappers raise
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_decode(q[:, 0], q, q, torch.tensor([3], dtype=torch.int32))
    # the plain version keeps both options
    out = ops.attention(q, q, q, causal=True, q_offset=3, kv_len=kv_len)
    assert out.shape == q.shape


# ---------------------------------------------------------------------------
# model: prefill / decode_step and the slot caches vs JAX
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["stablelm_1_6b", "internlm2_20b"])
def pair(request):
    """(jax cfg, port cfg, jax params, port params) on bridged f32 weights."""
    jcfg = jax_smoke_config(request.param).with_(dtype="float32")
    tcfg = get_smoke_config(request.param).with_(dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))[0]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def test_prefill_and_decode_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(44)
    toks = rng.integers(0, jcfg.vocab, size=(2, 13)).astype(np.int32)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks), max_len=32)
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(toks), max_len=32)
    _close(tl, jl, MODEL_TOL)

    def caches_close():
        assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()
        for j, blk in jc["blocks"].items():
            for name in ("k", "v"):
                assert tc["blocks"][j][name].shape == blk[name].shape
                _close(tc["blocks"][j][name], blk[name], MODEL_TOL)

    caches_close()
    for _ in range(4):
        nxt = rng.integers(0, jcfg.vocab, size=(2,)).astype(np.int32)
        jl, jc = jax_decode_step(jparams, jcfg, jc, jnp.asarray(nxt))
        tl, tc = decode_step(tparams, tcfg, tc, torch.from_numpy(nxt))
        _close(tl, jl, MODEL_TOL)
        caches_close()


def test_decode_past_the_slot_writes_nothing(pair):
    """A row whose length reached max_len writes nowhere (JAX's one-hot of
    an out-of-range index is all zeros), and its logits stay finite."""
    jcfg, tcfg, jparams, tparams = pair
    toks = np.arange(1, 9, dtype=np.int32)[None].repeat(2, 0)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks), max_len=8)
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(toks), max_len=8)
    before = tc["blocks"]["0"]["k"].clone()
    nxt = np.array([3, 4], np.int32)
    jl, jc = jax_decode_step(jparams, jcfg, jc, jnp.asarray(nxt))
    tl, tc = decode_step(tparams, tcfg, tc, torch.from_numpy(nxt))
    assert torch.equal(tc["blocks"]["0"]["k"], before)
    _close(tl, jl, MODEL_TOL)


def test_int8_slot_cache_matches_jax_layout():
    """The int8 slot cache: int8 zero K/V beside float32 scales of zeros
    (not the paged pools' ones), the JAX package's leaves and shapes."""
    from repro.models import init_cache as jax_init_cache

    jcfg = jax_smoke_config("stablelm_1_6b").with_(kv_cache_dtype="int8")
    tcfg = get_smoke_config("stablelm_1_6b").with_(kv_cache_dtype="int8")
    jc = jax_init_cache(jcfg, 2, 16)
    tc = init_cache(tcfg, 2, 16, device="cpu")
    for j, blk in jc["blocks"].items():
        assert set(tc["blocks"][j]) == set(blk) == {"k", "v", "k_s", "v_s"}
        for name, arr in blk.items():
            got = tc["blocks"][j][name]
            assert str(got.dtype).split(".")[-1] == str(arr.dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(arr))


# ---------------------------------------------------------------------------
# engine: LLMEngine vs the JAX LLMEngine, token for token
# ---------------------------------------------------------------------------
# (arrival step, prompt, new tokens): requests join when a slot is free
SCENARIOS = {
    # four requests batched at once
    "batching": (dict(max_batch=4, max_len=64),
                 [(0, [1, 2, 3], 6), (0, list(range(4, 20)), 4),
                  (0, [7] * 9, 8), (0, list(range(40, 51)), 5)]),
    # requests join mid-stream and reuse the slots of finished ones
    "midstream_reuse": (dict(max_batch=2, max_len=64),
                        [(0, [5, 6], 7), (1, list(range(10, 23)), 3),
                         (2, [9, 9, 9, 9], 6), (3, list(range(30, 37)), 4),
                         (3, [2], 5)]),
    # the max_len - 2 limit ends a request before its budget
    "max_len_limit": (dict(max_batch=2, max_len=20),
                      [(0, list(range(1, 13)), 40), (0, [4, 5, 6], 40)]),
}


def _drive(eng, req_cls, arrivals, max_steps=200):
    out, pending, step = {}, list(enumerate(arrivals)), 0
    while (pending or eng.batch_size) and step < max_steps:
        while pending and pending[0][1][0] <= step and eng.can_admit():
            rid, (_, prompt, n) = pending.pop(0)
            assert eng.admit(req_cls(
                rid=rid, prompt=list(prompt), max_new_tokens=n,
                on_finish=lambda r: out.__setitem__(r.rid, list(r.out_tokens))))
        eng.step()
        step += 1
    assert not pending and not eng.batch_size
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_tokens_match_jax(pair, scenario):
    jcfg, tcfg, jparams, tparams = pair
    kw, arrivals = SCENARIOS[scenario]
    je = JaxEngine(jcfg, params=jparams, **kw)
    te = LLMEngine(tcfg, params=tparams, device="cpu", **kw)
    want = _drive(je, JaxRequest, arrivals)
    got = _drive(te, Request, arrivals)
    assert got == want and len(got) == len(arrivals)
    assert te.admissions == len(arrivals)
    assert te.decode_steps == sum(len(v) for v in te._lat_samples.values())
    if scenario == "max_len_limit":
        # both stop when the slot holds max_len - 2 tokens
        assert sorted(map(len, got.values())) == [7, 16]
    assert te.latency_profile() is not None
