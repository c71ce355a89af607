"""The port's cross-attention and Whisper encoder against JAX's.

Whisper-tiny's smoke config (a 2-layer encoder over 32 frames, 2 decoder
layers of self-attention, cross-attention under ``norm_x`` and an MLP)
and Llama-3.2-Vision-90B's (5 layers, a cross layer at 4, GQA 4/2, 17
patches) in float32, on weights built by the JAX package and bridged into
the port, with seeded random ``enc_input`` (so encoder positions matter).
On the CPU the port's entry points run the plain versions of the kernels
(flash attention non-causal with Sq != Sk, slot decode, RMSNorm), so
these hold

- the published trees (on ``meta`` against ``jax.eval_shape``) and the
  superblock layouts, the card's 10-layer Vision cut included, and the
  bridge carrying Whisper's encoder and xLSTM's cells bit for bit;
- ``cross_kv``, ``cross_attention``, ``encode`` and ``forward`` logits;
- ``prefill`` with its slot caches and ``__cross`` K/V, then 4
  ``decode_step``s; ``init_cache``'s placeholder cross K/V without
  ``params`` and its real ones with them;
- the Vision model over an int8 slot cache (each decode step held on
  JAX's cache, as ``tests/test_torch_int8.py`` holds the dense ones);
- the refusals: the engines take no encoder input (JAX's fail on these
  families), ``forward`` needs ``enc_input`` (JAX's cannot run without
  it), and an int8 cache for Whisper raises ``NotImplementedError``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import prefill as jax_prefill
from repro.models import transformer as JT
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import (decode_step, encode, forward, init_cache, init_params,
                                layer_kind, prefill)
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serving import LLMEngine, PagedLLMEngine
from test_torch_hybrid import _close, _leaves
from test_torch_int8 import _assert_int8_pools_match, _held_on_jax_inputs

ARCHS = ["whisper_tiny", "llama3_2_vision_90b"]
# logits, outputs and caches of the float32 smoke models: summation order only
MODEL_TOL = 1e-4


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _enc_input(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, port cfg, jax params, port params) on bridged f32 weights."""
    jcfg = jax_smoke_config(request.param).with_(dtype="float32")
    tcfg = get_smoke_config(request.param).with_(dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))[0]
    return jcfg, tcfg, jparams, _bridge(jparams)


def _cross_close(tcross, jcross):
    assert sorted(tcross) == sorted(jcross)
    for j, (jk, jv) in jcross.items():
        tk, tv = tcross[j]
        for got, want in ((tk, jk), (tv, jv)):
            assert tuple(got.shape) == want.shape, j
            _close(got, want, MODEL_TOL)


def _caches_close(tc, jc):
    """Slot caches and ``__cross`` K/V (tuples, which ``_leaves`` skips)."""
    assert set(tc) == set(jc)
    assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()
    _cross_close(tc["__cross"], jc["__cross"])
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jc["blocks"])[0],
                                 _leaves(tc["blocks"], jc["blocks"])):
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
        _close(got, want, MODEL_TOL)


# ---------------------------------------------------------------------------
# trees and layouts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_published_tree_matches_jax(arch):
    """The port's tree (on ``meta``) has JAX's leaves, shapes and dtypes:
    Whisper's ``encoder`` stack and ``enc_norm``, the cross layers'
    projections with no bias."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if arch == "llama3_2_vision_90b":      # the tree of 100 layers is 20 of these
        jcfg, cfg = jcfg.with_(n_layers=10), cfg.with_(n_layers=10)
    want = jax.eval_shape(lambda k: jax_init_params(jcfg, k)[0], jax.random.key(0))
    got = init_params(cfg, seed=0, device="meta")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = _leaves(got, want)
    assert len(flat) == len(leaves) == len(jax.tree.leaves(got))
    for (path, w), g in zip(flat, leaves):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path


@pytest.mark.parametrize("arch,subtree", [("whisper_tiny", "encoder"),
                                          ("whisper_tiny", "enc_norm"),
                                          ("xlstm_350m", "blocks")])
def test_bridge_carries_the_new_trees_bit_for_bit(arch, subtree):
    """JAX's Whisper encoder and ``enc_norm`` and xLSTM's stacked cells
    (bf16, as the smoke configs draw them) cross the bridge unchanged: the
    same leaves, dtypes and bits."""
    jparams = jax_init_params(jax_smoke_config(arch), jax.random.key(3))[0][subtree]
    got = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    leaves = _leaves(got, jparams)
    assert len(flat) == len(leaves) == len(jax.tree.leaves(got))
    for (path, want), t in zip(flat, leaves):
        assert str(t.dtype).split(".")[-1] == str(want.dtype), path
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16)), path


def test_whisper_layout():
    cfg = get_config("whisper-tiny")
    assert TT._scan_layout(cfg) == (0, 1, 4)
    params = init_params(cfg, seed=0, device="meta")
    assert sorted(params["blocks"]["0"]) == ["attn", "mlp", "norm1", "norm2", "norm_x",
                                            "xattn"]
    assert params["encoder"]["attn"]["wq"].shape == (4, 384, 384)
    assert params["enc_norm"]["g"].shape == (384,)
    cache = init_cache(cfg, 2, 64, device="meta")
    assert cache["blocks"]["0"]["k"].shape == (4, 2, 64, 6, 64)
    assert cache["__cross"]["0"][0].shape == (4, 2, 1500, 6, 64)


def test_vision_ten_layer_cut():
    """The card's cut: 10 layers are 2 superblocks of 4 ``attn+mlp`` and a
    ``cross+mlp``, 21.3 GB of bf16 weights with the untied head."""
    cfg = get_config("llama-3.2-vision-90b").with_(n_layers=10)
    assert TT._scan_layout(cfg) == (0, 5, 2)
    assert [i for i in range(10) if layer_kind(cfg, i) == "cross+mlp"] == [4, 9]
    params = init_params(cfg, seed=0, device="meta")
    assert "bq" not in params["blocks"]["4"]["attn"]
    nbytes = sum(t.numel() * t.element_size() for t in jax.tree.leaves(params))
    assert nbytes == 21_315_796_992
    cache = init_cache(cfg, 4, 1024, device="meta")
    assert cache["blocks"]["4"] == {}
    assert cache["__cross"]["4"][1].shape == (2, 4, 1601, 8, 128)
    assert sorted(cache["__cross"]) == ["4"]


# ---------------------------------------------------------------------------
# cross-attention, encoder, forward
# ---------------------------------------------------------------------------
def _cross_layer(cfg, params):
    """The first cross layer's weights (superblock 0)."""
    if cfg.family == "audio":
        return jax.tree.map(lambda a: a[0], params["blocks"]["0"]["xattn"])
    return jax.tree.map(lambda a: a[0], params["blocks"]["4"]["attn"])


@pytest.mark.parametrize("Sq", [1, 7])
def test_cross_kv_and_cross_attention_match_jax(pair, Sq):
    jcfg, tcfg, jparams, _ = pair
    jp = _cross_layer(jcfg, jparams)
    tp = _bridge(jp)
    assert "bq" not in tp
    enc = _enc_input(jcfg, 2, 70)
    jk, jv = JL.cross_kv(jp, jcfg, jnp.asarray(enc))
    tk, tv = TL.cross_kv(tp, tcfg, torch.from_numpy(enc))
    _close(tk, jk, MODEL_TOL)
    _close(tv, jv, MODEL_TOL)
    x = np.random.default_rng(71).normal(size=(2, Sq, jcfg.d_model)).astype(np.float32)
    want = JL.cross_attention(jp, jcfg, jnp.asarray(x), (jk, jv))
    got = TL.cross_attention(tp, tcfg, torch.from_numpy(x), (tk, tv))
    _close(got, want, MODEL_TOL)


def test_encode_matches_jax():
    jcfg = jax_smoke_config("whisper_tiny").with_(dtype="float32")
    tcfg = get_smoke_config("whisper_tiny").with_(dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(1))[0]
    enc = _enc_input(jcfg, 2, 72)
    want = JT.encode(jparams, jcfg, jnp.asarray(enc))
    got = encode(_bridge(jparams), tcfg, torch.from_numpy(enc))
    _close(got, want, MODEL_TOL)
    # positions matter: a permutation of the frames changes the output
    perm = encode(_bridge(jparams), tcfg, torch.from_numpy(enc[:, ::-1].copy()))
    assert not torch.allclose(perm.flip(1), got, atol=1e-3)


def test_forward_matches_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    toks = np.random.default_rng(73).integers(0, jcfg.vocab, size=(2, 19)).astype(np.int32)
    enc = _enc_input(jcfg, 2, 74)
    jl, _ = jax_forward(jparams, jcfg, jnp.asarray(toks), enc_input=jnp.asarray(enc))
    tl, _ = forward(tparams, tcfg, torch.from_numpy(toks), enc_input=torch.from_numpy(enc))
    _close(tl, jl, MODEL_TOL)


# ---------------------------------------------------------------------------
# caches: prefill, decode_step, init_cache
# ---------------------------------------------------------------------------
def test_prefill_and_decode_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(75)
    toks = rng.integers(0, jcfg.vocab, size=(2, 13)).astype(np.int32)
    enc = _enc_input(jcfg, 2, 76)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks), max_len=32,
                         enc_input=jnp.asarray(enc))
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(toks), max_len=32,
                     enc_input=torch.from_numpy(enc))
    _close(tl, jl, MODEL_TOL)
    _caches_close(tc, jc)
    for _ in range(4):
        nxt = rng.integers(0, jcfg.vocab, size=(2,)).astype(np.int32)
        jl, jc = jax_decode_step(jparams, jcfg, jc, jnp.asarray(nxt))
        tl, tc = decode_step(tparams, tcfg, tc, torch.from_numpy(nxt))
        _close(tl, jl, MODEL_TOL)
        _caches_close(tc, jc)


def test_init_cache_matches_jax(pair):
    """Without ``params`` the cross K/V are zeros of ``encoder.n_ctx``
    tokens; with ``params`` and ``enc_input`` JAX's K/V of the input."""
    jcfg, tcfg, jparams, tparams = pair
    stub = init_cache(tcfg, 3, 16, device="cpu")
    jstub = jax_init_cache(jcfg, 3, 16)
    assert sorted(stub["__cross"]) == sorted(jstub["__cross"])
    for j, (jk, _) in jstub["__cross"].items():
        for t in stub["__cross"][j]:
            assert tuple(t.shape) == jk.shape and t.dtype == torch.float32
            assert not t.any()
    enc = _enc_input(jcfg, 3, 77)
    got = init_cache(tcfg, 3, 16, device="cpu", enc_input=torch.from_numpy(enc),
                     params=tparams)
    want = jax_init_cache(jcfg, 3, 16, enc_input=jnp.asarray(enc), params=jparams)
    _caches_close(got, want)


def test_vision_int8_slot_cache_matches_jax(monkeypatch):
    """The VLM over an int8 slot cache (JAX's ``attention_decode_q8`` on the
    self-attention layers, nothing cached at the cross layer): prefill
    within one int8 step, each decode step held on JAX's cache."""
    arch = "llama3_2_vision_90b"
    jcfg = jax_smoke_config(arch).with_(dtype="float32", kv_cache_dtype="int8")
    tcfg = get_smoke_config(arch).with_(dtype="float32", kv_cache_dtype="int8")
    jparams = jax_init_params(jcfg, jax.random.key(0))[0]
    tparams = _bridge(jparams)
    toks = np.arange(1, 10, dtype=np.int32)[None].repeat(2, 0)
    enc = jnp.asarray(_enc_input(jcfg, 2, 78))
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks), max_len=16, enc_input=enc)
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(toks), max_len=16,
                     enc_input=torch.from_numpy(np.array(enc)))
    _close(tl, jl, MODEL_TOL)
    assert tc["blocks"]["0"]["k"].dtype == torch.int8 and tc["blocks"]["4"] == {}
    _assert_int8_pools_match(jc, tc)
    _cross_close(tc["__cross"], jc["__cross"])
    nxt = np.array([3, 4], np.int32)
    for _ in range(3):
        at = np.asarray(jc["lengths"])
        jl, jc_next = jax_decode_step(jparams, jcfg, jc, jnp.asarray(nxt))
        # the written layers only (the cross layer caches nothing)
        written = dict(jc_next, blocks={j: b for j, b in jc_next["blocks"].items() if b})
        tl, tc = _held_on_jax_inputs(
            monkeypatch, lambda cache: decode_step(tparams, tcfg, cache,
                                                   torch.from_numpy(nxt)),
            jc, written, tc, lambda arr: arr[np.arange(len(at)), at])
        _close(tl, jl, MODEL_TOL)
        jc = jc_next


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_engines_refuse_encoder_families(arch):
    """The JAX engine admits no request of these families (its prefill
    passes no ``enc_input``); the port's engines refuse them at once."""
    jcfg = jax_smoke_config(arch).with_(dtype="float32")
    tcfg = get_smoke_config(arch).with_(dtype="float32")
    je = JaxEngine(jcfg, max_batch=2, max_len=32)
    with pytest.raises((AttributeError, TypeError)):
        je.admit(JaxRequest(rid=0, prompt=[1, 2, 3], max_new_tokens=2))
    with pytest.raises(ValueError, match="needs encoder input"):
        LLMEngine(tcfg, max_batch=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="needs encoder input"):
        PagedLLMEngine(tcfg, max_seqs=2, max_len=32, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_needs_enc_input(arch):
    jcfg = jax_smoke_config(arch).with_(dtype="float32")
    tcfg = get_smoke_config(arch).with_(dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(2))[0]
    toks = np.ones((1, 4), np.int32)
    with pytest.raises((AttributeError, TypeError)):
        jax_forward(jparams, jcfg, jnp.asarray(toks))
    tparams = _bridge(jparams)
    for call in (lambda: forward(tparams, tcfg, torch.from_numpy(toks)),
                 lambda: prefill(tparams, tcfg, torch.from_numpy(toks), max_len=8)):
        with pytest.raises(ValueError, match="needs enc_input"):
            call()


def test_whisper_int8_cache_is_refused():
    cfg = get_smoke_config("whisper_tiny").with_(dtype="float32", kv_cache_dtype="int8")
    params = init_params(cfg, seed=0, device="cpu")
    enc = torch.zeros(1, cfg.encoder.n_ctx, cfg.d_model)
    toks = torch.ones(1, 4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="int8"):
        init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        prefill(params, cfg, toks, max_len=8, enc_input=enc)
    fp = get_smoke_config("whisper_tiny").with_(dtype="float32")
    _, cache = prefill(params, fp, toks, max_len=8, enc_input=enc)
    with pytest.raises(NotImplementedError, match="int8"):
        decode_step(params, cfg, cache, toks[:, 0])
