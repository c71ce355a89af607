"""The port's int8 KV caches against the JAX package's, on the CPU.

- ``ops.quantize_kv`` is bit-equal to JAX's ``quantize_kv_ref`` (ties,
  zeros, bfloat16 inputs, magnitudes over 17 decades);
- the plain paged-attention versions over int8 pools and their scale
  pools agree with the Pallas kernels' ``quantized=True`` form in
  interpret mode (``Q_TOL``), with finite garbage (payload and scale) in
  every slot no live row may read;
- the int8 paged model's logits agree with JAX's within 1e-4 (float32),
  and its int8 pools with JAX's;
- ``PagedLLMEngine(kv_dtype="int8")`` gives the JAX int8 engine's greedy
  tokens in each scenario of ``tests/test_int8_pages.py`` (decode, prefix
  cache with copy-on-write, migration, a JAX ticket finished by the port),
  refuses a ticket of the other page dtype, runs clean under the
  sanitizer, and sizes byte budgets as JAX does;
- the int8 slot cache (``kv_cache_dtype="int8"``) does the same through
  ``prefill``/``decode_step`` and ``LLMEngine``;
- the launcher serves a workload over int8 paged replicas.

The K/V that the two frameworks' float32 matmuls produce differ in the
last bits, so the quantization scales of the models' caches may differ
by an ulp; payloads are compared exactly where a test says so, scales
within float32 rounding.  The int8 CUDA kernels are held against the
plain versions on the card in ``tests/test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ref as JR
from repro.kernels.paged_attention import (
    paged_decode_attention as pallas_decode,
    paged_prefill_attention as pallas_prefill,
)
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import paged as JP
from repro.models import prefill as jax_prefill
from repro.serving import LLMEngine as JaxSlotEngine
from repro.serving import PagedLLMEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.analysis.kvsan import KVSanError, KVSanitizer
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels.paged_attention import (
    paged_decode_attention_int8 as cuda_decode_int8,
    paged_prefill_attention_int8 as cuda_prefill_int8,
)
from repro_torch.launch import serve
from repro_torch.models import decode_step, prefill
from repro_torch.models import paged as TP
from repro_torch.serving import LLMEngine, PagedLLMEngine, Request, migrate_request

# tests/test_paged_kernels.py's tolerance for the quantized kernels (f32
# summation order over dequantized pages); bf16 q adds one output rounding
Q_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# logits of the float32 smoke models: summation order only
MODEL_TOL = 1e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# quantize_kv: bit-equal to JAX's
# ---------------------------------------------------------------------------
def _ties(rng):
    """Rows whose x / scale lands exactly on k + 0.5 (scale a power of two:
    the row's amax is 127 * scale), so round-half-to-even decides."""
    s = np.float32(0.25)
    x = np.zeros((512, 2, 16), np.float32)
    x[..., :15] = (rng.integers(-126, 126, size=(512, 2, 15)) + 0.5) * s
    x[..., 15] = 127 * s
    return x


QUANT_INPUTS = {
    "normal": lambda rng: (rng.normal(size=(16, 8, 4, 64)) * 3).astype(np.float32),
    "ties": _ties,
    "zeros": lambda rng: np.zeros((3, 4, 2, 16), np.float32),
    "magnitudes": lambda rng: (
        rng.normal(size=(256, 4, 32))
        * np.exp(rng.uniform(-20, 20, size=(256, 4, 1)))).astype(np.float32),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(QUANT_INPUTS))
def test_quantize_kv_is_bit_equal_to_jax(case, dtype):
    x = QUANT_INPUTS[case](np.random.default_rng(41))
    jq, js = JR.quantize_kv_ref(jnp.asarray(x, JDT[dtype]))
    tq, ts = ops.quantize_kv(torch.from_numpy(x).to(TDT[dtype]))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if case == "ties" and dtype == "float32":
        assert (tq.numpy()[..., :15] % 2 == 0).all()      # half to even
    if case == "zeros":
        assert (tq.numpy() == 0).all() and (ts.numpy() > 0).all()


def test_bridge_moves_int8_pages_and_scales_bit_for_bit():
    from repro_torch.bridge import tensor_from_numpy, tensor_to_numpy

    rng = np.random.default_rng(40)
    q = rng.integers(-127, 128, size=(2, 3, 4, 2, 8)).astype(np.int8)
    s = rng.uniform(1e-3, 2.0, size=(2, 3, 4, 2)).astype(np.float32)
    for arr in (q, np.asarray(jnp.asarray(q)), s):
        t = tensor_from_numpy(arr, "cpu")
        back = tensor_to_numpy(t)
        assert back.dtype == arr.dtype and t.dtype in (torch.int8, torch.float32)
        np.testing.assert_array_equal(back, arr)


def test_dequantize_pages_matches_jax():
    rng = np.random.default_rng(42)
    q = rng.integers(-127, 128, size=(5, 4, 2, 16)).astype(np.int8)
    s = rng.uniform(1e-3, 2.0, size=(5, 4, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        TR.dequantize_pages_ref(torch.from_numpy(q), torch.from_numpy(s)).numpy(),
        np.asarray(JR.dequantize_pages_ref(jnp.asarray(q), jnp.asarray(s))),
    )


# ---------------------------------------------------------------------------
# plain int8 paged attention vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
def _int8_pools(rng, P, ps, K, hd, live):
    """int8 pools and scale pools from normal K/V; every slot outside the
    ``(P, ps)`` mask ``live`` holds +-99 with a large finite scale (7.5)."""
    kq, ks = JR.quantize_kv_ref(jnp.asarray(rng.normal(size=(P, ps, K, hd)), jnp.float32))
    vq, vs = JR.quantize_kv_ref(jnp.asarray(rng.normal(size=(P, ps, K, hd)), jnp.float32))
    kq, ks, vq, vs = (np.array(a) for a in (kq, ks, vq, vs))
    dead = ~live
    kq[dead], vq[dead] = 99, -99
    ks[dead], vs[dead] = 7.5, 7.5
    return kq, vq, ks, vs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "H,K,hd,ps,npp",
    [
        (4, 4, 16, 8, 4),       # stablelm-smoke: MHA, hd 16
        (6, 2, 16, 8, 4),       # internlm2-smoke: GQA g=3, hd 16
        (8, 2, 64, 16, 3),      # GQA g=4, hd 64
        (4, 1, 128, 32, 3),     # g=4, hd 128
    ],
)
def test_paged_decode_int8_ref_matches_pallas(H, K, hd, ps, npp, dtype):
    rng = np.random.default_rng(43)
    lens = np.array([1, ps, ps + 1, npp * ps - 3], np.int32)
    B = len(lens)
    P = B * npp + 3
    bt = rng.permutation(np.arange(1, P))[: B * npp].reshape(B, npp).astype(np.int32)
    live = np.zeros((P, ps), bool)
    for b in range(B):
        for t in range(int(lens[b])):
            live[bt[b, t // ps], t % ps] = True
    kq, vq, ks, vs = _int8_pools(rng, P, ps, K, hd, live)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    want = pallas_decode(
        jnp.asarray(q, JDT[dtype]), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(bt), jnp.asarray(lens), interpret=True,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    got = ops.paged_decode_attention(
        torch.from_numpy(q).to(TDT[dtype]), torch.from_numpy(kq),
        torch.from_numpy(vq), torch.from_numpy(bt), torch.from_numpy(lens),
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    assert got.dtype == TDT[dtype] and got.shape == (B, H, hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=Q_TOL[dtype], rtol=Q_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "H,K,hd,ps,past,C",
    [
        (4, 4, 16, 8, 0, 8),      # stablelm-smoke, first chunk
        (6, 2, 16, 8, 12, 7),     # internlm2-smoke, non-aligned past and tail
        (4, 2, 64, 8, 17, 23),    # GQA hd 64, multi-page chunk
    ],
)
def test_paged_prefill_int8_ref_matches_pallas(H, K, hd, ps, past, C, dtype):
    rng = np.random.default_rng(44)
    ctx = past + C
    npp = -(-ctx // ps) + 2
    P = npp + 4
    bt = rng.permutation(np.arange(1, P))[:npp].astype(np.int32)
    live = np.zeros((P, ps), bool)
    for t in range(ctx):
        live[bt[t // ps], t % ps] = True
    kq, vq, ks, vs = _int8_pools(rng, P, ps, K, hd, live)
    q = rng.normal(size=(C, H, hd)).astype(np.float32)
    want = pallas_prefill(
        jnp.asarray(q, JDT[dtype]), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(bt), past, interpret=True,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    got = ops.paged_prefill_attention(
        torch.from_numpy(q).to(TDT[dtype]), torch.from_numpy(kq),
        torch.from_numpy(vq), torch.from_numpy(bt), past,
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    assert got.dtype == TDT[dtype] and got.shape == (C, H, hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=Q_TOL[dtype], rtol=Q_TOL[dtype])


def test_int8_wrappers_and_dispatch_refuse_cpu_tensors():
    """int8 pools on the CPU go to the plain version under 'auto'; the
    int8 wrappers and impl='cuda' raise, and count nothing."""
    before = ops.launch_counts()
    q = torch.zeros(1, 2, 16)
    pool = torch.zeros(3, 4, 2, 16, dtype=torch.int8)
    sc = torch.ones(3, 4, 2)
    bt = torch.ones(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_decode_int8(q, pool, pool, bt, lens, sc, sc)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_prefill_int8(q, pool, pool, bt[0], 0, sc, sc)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.paged_decode_attention(q, pool, pool, bt, lens, k_scales=sc,
                                   v_scales=sc, impl="cuda")
    out = ops.paged_decode_attention(q, pool, pool, bt, lens, k_scales=sc, v_scales=sc)
    assert out.shape == (1, 2, 16) and bool(torch.isfinite(out).all())
    assert ops.launch_counts() == before
    assert {"paged_decode_attention_int8", "paged_prefill_attention_int8"} <= set(before)


# ---------------------------------------------------------------------------
# the int8 paged model path
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["stablelm_1_6b", "internlm2_20b"])
def pair(request):
    """(jax cfg, port cfg, jax params, port params) on bridged f32 weights."""
    jcfg = jax_smoke_config(request.param).with_(dtype="float32")
    tcfg = get_smoke_config(request.param).with_(dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))[0]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _assert_int8_pools_match(jpools, tpools, only=None):
    """Payloads equal, except where the frameworks' float32 K/V straddle a
    rounding boundary (then one step apart); scales within f32 rounding.
    ``only=(j, s)`` compares superblock ``s`` of pattern position ``j`` alone."""
    steps = 0
    for j, pool in jpools["blocks"].items():
        if only is not None and j != only[0]:
            continue
        for name, arr in pool.items():
            got, want = tpools["blocks"][j][name].numpy(), np.asarray(arr)
            if only is not None:
                got, want = got[only[1]], want[only[1]]
            assert got.dtype == want.dtype
            if name in ("k", "v"):
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1, f"pool {j}/{name}: {diff.max()} steps"
                steps += int((diff > 0).sum())
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"{j}/{name}")
    assert steps <= 2, f"{steps} int8 entries one step apart"


def _load_from_jax(ttree, jtree):
    """Overwrite the port's pools or slot cache with JAX's, in place (bridged)."""
    for j, blk in jtree["blocks"].items():
        for name, arr in blk.items():
            ttree["blocks"][j][name].copy_(tensor_from_numpy(arr, "cpu"))
    if "lengths" in jtree:
        ttree["lengths"].copy_(tensor_from_numpy(jtree["lengths"], "cpu"))


def _jax_writes(jtree, rows):
    """The int8 K/V and scales JAX's call wrote, in the order the port's call
    quantizes them (layer by layer, K then V).  ``rows(arr)`` picks the
    written entries of one layer's ``(..., K[, hd])`` array."""
    blocks = [{n: np.asarray(a) for n, a in blk.items()}
              for _, blk in sorted(jtree["blocks"].items(), key=lambda kv: int(kv[0]))]
    n_sb = blocks[0]["k"].shape[0]
    return [(tensor_from_numpy(rows(blk[n][s]), "cpu"),
             tensor_from_numpy(rows(blk[n + "_s"][s]), "cpu"))
            for s in range(n_sb) for blk in blocks for n in ("k", "v")]


def _held_on_jax_inputs(monkeypatch, port_call, jax_before, jax_after, tstate, rows):
    """Run one int8 model call of the port from JAX's state before it.

    The frameworks' float32 K/V differ in the last bits, so at a rounding
    boundary one int8 entry quantizes a step apart; that step moves the
    layers above it and the logits by up to ~1e-3.  So the call runs once
    for each layer, writing JAX's quantized K/V in the layers below it and
    its own from it up, and that layer's own write is held against JAX's
    (one step at most, scales within f32 rounding) on identical inputs.
    A last run writes JAX's K/V in every layer; its logits, returned, can
    be held against JAX's at ``MODEL_TOL``.
    """
    writes = _jax_writes(jax_after, rows)
    pat = len(jax_after["blocks"])
    quantize = ops.quantize_kv
    for layer in range(len(writes) // 2 + 1):
        _load_from_jax(tstate, jax_before)
        feed, own = iter(writes[:2 * layer]), []

        def fake(x, feed=feed, own=own):
            w = next(feed, None)
            if w is None:
                own.append(x)
                return quantize(x)
            return w

        with monkeypatch.context() as m:
            m.setattr(ops, "quantize_kv", fake)
            logits, tstate = port_call(tstate)
        assert len(own) == len(writes) - 2 * layer
        if layer < len(writes) // 2:
            sb, j = divmod(layer, pat)
            _assert_int8_pools_match(jax_after, tstate, only=(str(j), sb))
    return logits, tstate


def test_int8_paged_model_matches_jax(pair, monkeypatch):
    """Each chunk and decode step held on JAX's pools (see
    ``_held_on_jax_inputs``); the last pools within one int8 step."""
    jcfg, tcfg, jparams, tparams = pair
    ps, P, npp = 8, 16, 6
    rng = np.random.default_rng(45)
    jpools = JP.init_paged_pools(jcfg, P, ps, kv_dtype="int8")
    tpools = TP.init_paged_pools(tcfg, P, ps, kv_dtype="int8", device="cpu")
    prompt = rng.integers(0, tcfg.vocab, size=21).astype(np.int32)
    bt0 = np.array([3, 9, 4, 12, 0, 0], np.int32)

    def slots(flat):
        return lambda arr: arr.reshape((P * ps,) + arr.shape[2:])[flat]

    for past, C in [(0, 8), (8, 8), (16, 5)]:
        toks = prompt[None, past:past + C]
        jl, jnext = JP.paged_prefill_chunk(
            jparams, jcfg, jpools, jnp.asarray(toks), jnp.asarray(bt0), past)
        pos = np.arange(past, past + C)
        tl, tpools = _held_on_jax_inputs(
            monkeypatch, lambda pools: TP.paged_prefill_chunk(
                tparams, tcfg, pools, torch.from_numpy(toks), torch.from_numpy(bt0), past),
            jpools, jnext, tpools, slots(bt0[pos // ps] * ps + pos % ps))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL)
        jpools = jnext
    bt = np.array([bt0, [7, 0, 0, 0, 0, 0], [0] * npp, [0] * npp], np.int32)
    lens = np.array([21, 3, 0, 0], np.int32)
    for _ in range(3):
        toks = rng.integers(0, tcfg.vocab, size=4).astype(np.int32)
        jl, jnext = JP.paged_decode_step(
            jparams, jcfg, jpools, jnp.asarray(toks), jnp.asarray(bt), jnp.asarray(lens))
        flat = bt[np.arange(4), lens // ps] * ps + lens % ps
        tl, tpools = _held_on_jax_inputs(
            monkeypatch, lambda pools: TP.paged_decode_step(
                tparams, tcfg, pools, torch.from_numpy(toks), torch.from_numpy(bt),
                torch.from_numpy(lens)),
            jpools, jnext, tpools, slots(flat))
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], atol=MODEL_TOL)
        jpools = jnext
        lens[:2] += 1
    _assert_int8_pools_match(jpools, tpools)


# ---------------------------------------------------------------------------
# the int8 PagedLLMEngine vs the JAX int8 engine (tests/test_int8_pages.py)
# ---------------------------------------------------------------------------
ENGINE_KW = dict(max_seqs=4, max_len=64, page_size=8, num_pages=49)
PROMPTS = [[1, 2, 3, 4], [1, 2, 3, 9], [5, 6], [7, 8, 9, 10, 11]]
SHARED = [3, 1, 4, 1, 5, 9, 2, 6] * 2          # two full 8-token pages


def _engines(pair, **kw):
    jcfg, tcfg, jparams, tparams = pair
    kw = {**ENGINE_KW, **kw}
    return (JaxEngine(jcfg, params=jparams, kv_dtype="int8", **kw),
            PagedLLMEngine(tcfg, params=tparams, kv_dtype="int8", device="cpu", **kw))


def _drain(eng, req_cls, prompts, max_new=10, stagger=1):
    """Admit one prompt per ``stagger`` steps; drain; return outputs."""
    out, pending, steps = {}, list(enumerate(prompts)), 0
    while (pending or eng.batch_size or eng.waiting) and steps < 600:
        if pending and steps % stagger == 0 and eng.can_admit():
            i, p = pending[0]
            if eng.admit(req_cls(rid=i, prompt=list(p), max_new_tokens=max_new,
                                 on_finish=lambda r: out.__setitem__(
                                     r.rid, list(r.out_tokens)))):
                pending.pop(0)
        eng.step()
        steps += 1
    assert not pending and not eng.batch_size and not eng.waiting
    eng.allocator.check_no_leaks(allow_indexed=True)
    return out


def test_int8_engine_decode_matches_jax(pair):
    je, te = _engines(pair)
    want = _drain(je, JaxRequest, PROMPTS)
    got = _drain(te, Request, PROMPTS)
    assert got == want and len(got) == len(PROMPTS)
    assert te.pools["blocks"]["0"]["k"].dtype == torch.int8
    assert te.decode_steps > 0 and te.prefill_chunks >= len(PROMPTS)


def test_int8_prefix_cache_with_copy_on_write_matches_jax(pair):
    prompts = [SHARED + [20 + i] for i in range(3)] + [SHARED, SHARED]
    je, te = _engines(pair, prefix_cache=True, prefill_chunk=8)
    want = _drain(je, JaxRequest, prompts, max_new=6, stagger=2)
    got = _drain(te, Request, prompts, max_new=6, stagger=2)
    assert got == want
    assert te.prefix_index.hits > 0 and te.cow_copies > 0
    assert (te.prefix_index.hits, te.cow_copies, te.prefill_skipped_tokens) == (
        je.prefix_index.hits, je.cow_copies, je.prefill_skipped_tokens)


def test_int8_forced_eviction_matches_jax(pair):
    je, te = _engines(pair, max_seqs=3, num_pages=14)
    prompts = [[1 + i] * 4 for i in range(3)]
    want = _drain(je, JaxRequest, prompts, max_new=40)
    got = _drain(te, Request, prompts, max_new=40)
    assert got == want and te.preemptions > 0 and te.preemptions == je.preemptions


def test_int8_port_migration_matches_unmigrated_jax(pair):
    """A request migrated between two int8 port engines (ticket with int8
    payload and scale pools) finishes with the JAX unmigrated tokens."""
    je, a = _engines(pair)
    _, b = _engines(pair)
    want = _drain(je, JaxRequest, [PROMPTS[0]], max_new=12)
    out = {}
    a.admit(Request(rid=0, prompt=list(PROMPTS[0]), max_new_tokens=12,
                    on_finish=lambda r: out.__setitem__(r.rid, list(r.out_tokens))))
    for _ in range(4):
        a.step()
    ticket_pages = len(a.seq_pages[a.youngest_active_row()])
    assert migrate_request(a, b, a.youngest_active_row())
    while b.batch_size:
        b.step()
    assert out == want and ticket_pages >= 1
    a.allocator.check_no_leaks()
    b.allocator.check_no_leaks()


def test_int8_jax_ticket_resumes_on_port(pair):
    """A JAX int8 ticket (int8 payload, float32 scale pools) imported into
    the port finishes as the unmigrated JAX run."""
    je, te = _engines(pair, page_size=4)
    jcfg, _, jparams, _ = pair
    want = _drain(JaxEngine(jcfg, params=jparams, kv_dtype="int8",
                            **{**ENGINE_KW, "page_size": 4}),
                  JaxRequest, [list(range(1, 11))], max_new=20)
    out = {}
    je.admit(JaxRequest(rid=0, prompt=list(range(1, 11)), max_new_tokens=20,
                        on_finish=lambda r: out.__setitem__(r.rid, list(r.out_tokens))))
    for _ in range(8):
        je.step()
    ticket = je.export_request(je.youngest_active_row())
    assert ticket.kv_dtype == "int8" and ticket.n_pages >= 3
    assert ticket.kv["0"]["k"].dtype == np.int8 and ticket.kv["0"]["k_s"].dtype == np.float32
    assert te.import_request(ticket)
    while te.batch_size:
        te.step()
    te.allocator.check_no_leaks()
    assert out == want


def test_int8_ticket_carries_scales_and_dtype_mismatch_is_refused(pair):
    jcfg, tcfg, jparams, tparams = pair
    _, a = _engines(pair)
    fp = PagedLLMEngine(tcfg, params=tparams, kv_dtype="fp32", device="cpu", **ENGINE_KW)
    jfp = JaxEngine(jcfg, params=jparams, kv_dtype="fp32", **ENGINE_KW)
    a.admit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=8))
    for _ in range(2):
        a.step()
    ticket = a.export_request(a.youngest_active_row())
    assert ticket.kv_dtype == "int8"
    for layer_kv in ticket.kv.values():
        assert set(layer_kv) == {"k", "v", "k_s", "v_s"}
        assert layer_kv["k"].dtype == np.int8 and layer_kv["k_s"].dtype == np.float32
    with pytest.raises(ValueError, match="kv_dtype mismatch"):
        fp.import_request(ticket)
    with pytest.raises(ValueError, match="kv_dtype mismatch"):
        jfp.import_request(ticket)
    assert a.import_request(ticket)             # roll back, no leak
    while a.batch_size or a.waiting:
        a.step()
    a.allocator.check_no_leaks()


def test_int8_sanitized_run_is_clean_and_matches_jax(pair):
    """Under the sanitizer every write is marked quantized, CoW copies carry
    scale coverage, decode spot-checks layer 0's scale pools, and exports
    validate it; the tokens stay the JAX engine's."""
    prompts = [SHARED + [30 + i] for i in range(3)] + [SHARED]
    je, te = _engines(pair, sanitize=True, prefix_cache=True)
    want = _drain(je, JaxRequest, prompts, max_new=8)
    got = _drain(te, Request, prompts, max_new=8)
    assert got == want and len(got) == len(prompts)
    # a decoding request exported from a sanitized int8 engine validates
    te.admit(Request(rid=9, prompt=SHARED + [1], max_new_tokens=8))
    for _ in range(3):
        te.step()
    _, b = _engines(pair, sanitize=True)
    assert migrate_request(te, b, te.youngest_active_row())


def test_int8_sanitizer_catches_a_bad_scale_and_an_unscaled_export(pair):
    _, te = _engines(pair, sanitize=True)
    te.admit(Request(rid=0, prompt=[1, 2, 3, 4, 5], max_new_tokens=6))
    te.step()
    row = te.youngest_active_row()
    page = te.seq_pages[row][0]
    te.pools["blocks"]["0"]["k_s"][0, page, 1, 0] = float("nan")
    with pytest.raises(ValueError, match="k_scales"):
        te.step()
    # kvsan's shadow scale coverage, as tests/test_int8_pages.py holds JAX's
    san = KVSanitizer(num_pages=8, page_size=4)
    san.on_alloc([1, 2], 0)
    san.note_table(0, [1, 2])
    san.note_write(0, 1, quantized=True)
    san.validate_scale_export([1])
    with pytest.raises(KVSanError, match="scale-pool mismatch"):
        san.validate_scale_export([1, 2])      # page 2 never scale-written
    san.on_alloc([3], 0)
    san.note_scale_copy(1, 3)                  # CoW copies inherit coverage
    san.validate_scale_export([3])


def test_int8_byte_accounting_matches_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    for budget in (1 << 16, 1 << 18, 3 << 20):
        for dt in ("fp32", "int8"):
            assert PagedLLMEngine.pages_for_byte_budget(tcfg, 8, budget, dt) == \
                JaxEngine.pages_for_byte_budget(jcfg, 8, budget, dt)
    kw = dict(max_seqs=2, max_len=64, page_size=8, num_pages=17)
    for dt in ("fp32", "int8"):
        t = PagedLLMEngine(tcfg, params=tparams, kv_dtype=dt, device="cpu", **kw)
        j = JaxEngine(jcfg, params=jparams, kv_dtype=dt, **kw)
        assert t.page_bytes == j.page_bytes
        assert PagedLLMEngine.pages_for_byte_budget(tcfg, 8, 1 << 18, dt) \
            * t.page_bytes <= 1 << 18


def test_full_width_int8_budget_ratio():
    """stablelm-1.6b at full width in bf16: 196,608 bytes a token in bf16
    pages against 104,448 in int8 pages (1.88x), as the docstrings say."""
    from repro_torch.configs import get_config

    cfg = get_config("stablelm_1_6b")
    for dt, per_token in (("fp32", 196608), ("int8", 104448)):
        assert PagedLLMEngine.pages_for_byte_budget(cfg, 1, per_token, dt) == 1
        assert PagedLLMEngine.pages_for_byte_budget(cfg, 1, per_token - 1, dt) == 0
    assert PagedLLMEngine.pages_for_byte_budget(cfg, 16, 193 * 16 * 196608, "int8") == 363


# ---------------------------------------------------------------------------
# the int8 slot cache vs JAX's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["stablelm_1_6b", "internlm2_20b"])
def q8pair(request):
    jcfg = jax_smoke_config(request.param).with_(dtype="float32", kv_cache_dtype="int8")
    tcfg = get_smoke_config(request.param).with_(dtype="float32", kv_cache_dtype="int8")
    jparams = jax_init_params(jcfg, jax.random.key(0))[0]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def test_int8_slot_prefill_and_decode_match_jax(q8pair, monkeypatch):
    """Each decode step held on JAX's cache (see ``_held_on_jax_inputs``)."""
    jcfg, tcfg, jparams, tparams = q8pair
    toks = np.arange(1, 10, dtype=np.int32)[None].repeat(2, 0)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks), max_len=16)
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(toks), max_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL)
    assert tc["blocks"]["0"]["k"].dtype == torch.int8
    _assert_int8_pools_match(jc, tc)
    nxt = np.array([3, 4], np.int32)
    for _ in range(3):
        at = np.asarray(jc["lengths"])
        jl, jc_next = jax_decode_step(jparams, jcfg, jc, jnp.asarray(nxt))
        tl, tc = _held_on_jax_inputs(
            monkeypatch, lambda cache: decode_step(tparams, tcfg, cache,
                                                   torch.from_numpy(nxt)),
            jc, jc_next, tc, lambda arr: arr[np.arange(len(at)), at])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL)
        np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc_next["lengths"]))
        jc = jc_next


def test_int8_slot_row_at_max_len_writes_nothing(q8pair):
    jcfg, tcfg, jparams, tparams = q8pair
    toks = np.arange(1, 9, dtype=np.int32)[None].repeat(2, 0)
    _, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks), max_len=8)
    _, tc = prefill(tparams, tcfg, torch.from_numpy(toks), max_len=8)
    _assert_int8_pools_match(jc, tc)
    _load_from_jax(tc, jc)
    before = {n: t.clone() for n, t in tc["blocks"]["0"].items()}
    nxt = np.array([3, 4], np.int32)
    jl, _ = jax_decode_step(jparams, jcfg, jc, jnp.asarray(nxt))
    tl, tc = decode_step(tparams, tcfg, tc, torch.from_numpy(nxt))
    for n, t in before.items():
        assert torch.equal(tc["blocks"]["0"][n], t)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL)


SLOT_SCENARIOS = {
    "batching": (dict(max_batch=4, max_len=64),
                 [(0, [1, 2, 3], 6), (0, list(range(4, 20)), 4),
                  (0, [7] * 9, 8), (0, list(range(40, 51)), 5)]),
    "midstream_reuse": (dict(max_batch=2, max_len=64),
                        [(0, [5, 6], 7), (1, list(range(10, 23)), 3),
                         (2, [9, 9, 9, 9], 6), (3, list(range(30, 37)), 4),
                         (3, [2], 5)]),
    "max_len_limit": (dict(max_batch=2, max_len=20),
                      [(0, list(range(1, 13)), 40), (0, [4, 5, 6], 40)]),
}


def _drive_slot(eng, req_cls, arrivals, max_steps=200):
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


@pytest.mark.parametrize("scenario", sorted(SLOT_SCENARIOS))
def test_int8_slot_engine_tokens_match_jax(q8pair, scenario):
    jcfg, tcfg, jparams, tparams = q8pair
    kw, arrivals = SLOT_SCENARIOS[scenario]
    want = _drive_slot(JaxSlotEngine(jcfg, params=jparams, **kw), JaxRequest, arrivals)
    te = LLMEngine(tcfg, params=tparams, device="cpu", **kw)
    got = _drive_slot(te, Request, arrivals)
    assert got == want and len(got) == len(arrivals)
    assert te.cache["blocks"]["0"]["k"].dtype == torch.int8


# ---------------------------------------------------------------------------
# the launcher over int8 paged replicas
# ---------------------------------------------------------------------------
def test_launcher_int8_fleet_finishes_every_job(capsys):
    argv = ["--engine", "paged", "--kv-dtype", "int8", "--replicas", "2",
            "--kv-pages", "13,49", "--migrate", "--prefix-cache",
            "--shared-prompt", "8", "--jobs", "3", "--token-scale", "40",
            "--device", "cpu"]
    assert serve.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[serve] scheduler=llmsched ") and " jobs=3 " in line


def test_launcher_int8_without_a_card_raises(monkeypatch):
    """Without --device the engines go to the card; with none they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--engine", "paged", "--kv-dtype", "int8", "--jobs", "3"])
