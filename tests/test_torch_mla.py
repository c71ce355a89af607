"""The port's MLA, shared experts and leading dense layer against JAX's.

DeepSeek-V2-Lite's smoke config (3 layers: an unstacked ``prefix_0`` of
kind ``mla+dense_mlp`` and two stacked ``mla+moe`` superblocks with one
shared expert) in float32, on weights built by the JAX package and
bridged into the port.  On the CPU the port's entry points run the plain
versions of the kernels, so these hold

- the ``init_mla`` and ``init_moe`` trees (names, shapes, dtypes) at the
  smoke config and at the published one (the port's on the ``meta``
  device, JAX's through ``jax.eval_shape``);
- ``_mla_qkv``, ``mla_full``, ``mla_decode`` and the engine's absorbed
  decode, with a row at length 0 and one at ``S_max`` (which writes
  nothing);
- the MoE FFN with shared experts (``moe_dense`` and the routed
  ``moe_block``) against JAX's ``moe_dense`` at DeepSeek-smoke and
  Kimi-smoke widths;
- ``forward``, ``prefill`` and ``decode_step`` logits and the compressed
  ``c_kv``/``k_rope`` caches;
- ``LLMEngine(device="cpu")`` against the JAX ``LLMEngine`` token for
  token in the hybrid suite's slot scenarios;
- the launcher over DeepSeek slot replicas, and its refusal of paged ones.

The kernels MLA reaches (flash attention at 192 / 128, slot decode at
192 / 128, RMSNorm) are held on the card in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import serve as jax_serve
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import prefill as jax_prefill
from repro.models import transformer as JT
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import decode_step, forward, init_params, layer_kind, prefill
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serving import LLMEngine, Request
from test_torch_hybrid import SLOT_SCENARIOS, _caches_close, _close, _drive, _leaves

ARCH = "deepseek_v2_lite_16b"
# logits and caches of the float32 smoke models: summation order only
MODEL_TOL = 1e-4


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, port cfg, jax params, port params) on bridged f32 weights."""
    jcfg = jax_smoke_config(ARCH).with_(dtype="float32")
    tcfg = get_smoke_config(ARCH).with_(dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))[0]
    return jcfg, tcfg, jparams, _bridge(jparams)


# ---------------------------------------------------------------------------
# weight trees
# ---------------------------------------------------------------------------
def _jax_tree(init_fn, cfg):
    """Shapes and dtypes of a JAX ``init_*`` tree, without drawing it."""
    def build(key):
        mk = JL.Maker(key, cfg.jdtype)
        init_fn(mk, cfg)
        return mk.params

    return jax.eval_shape(build, jax.random.key(0))


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "published"])
@pytest.mark.parametrize("arch,module", [(ARCH, "mla"), (ARCH, "moe"),
                                        ("kimi_k2_1t_a32b", "moe")])
def test_init_trees_match_jax(arch, module, full):
    jcfg = jax_get_config(arch) if full else jax_smoke_config(arch)
    tcfg = get_config(arch) if full else get_smoke_config(arch)
    j_init, t_init = {"mla": (JL.init_mla, TL.init_mla),
                      "moe": (JM.init_moe, TM.init_moe)}[module]
    want = _jax_tree(j_init, jcfg)
    got = t_init(TL.Init(0, tcfg.tdtype, "meta"), tcfg)
    if module == "moe":
        assert "shared" in got
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = _leaves(got, want)
    assert len(flat) == len(leaves) == sum(1 for _ in _all_leaves(got))
    for (path, w), g in zip(flat, leaves):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path


def _all_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _all_leaves(v)
        else:
            yield v


def test_published_deepseek_is_whole_on_one_card():
    """All 27 layers at published widths: a ``mla+dense_mlp`` prefix layer
    and 26 stacked ``mla+moe`` superblocks, 15.71 B parameters (31.4 GB of
    bf16: ``param_count`` plus the RMSNorm gains), built on ``meta``."""
    cfg = get_config("deepseek-v2-lite-16b")
    assert TT._scan_layout(cfg) == (1, 1, 26)
    assert [layer_kind(cfg, i) for i in (0, 1, 26)] == ["mla+dense_mlp", "mla+moe",
                                                      "mla+moe"]
    params = init_params(cfg, seed=0, device="meta")
    leaves = list(_all_leaves(params))
    n = sum(t.numel() for t in leaves)
    assert n == cfg.param_count()[0] + (2 * cfg.n_layers + 1) * cfg.d_model
    assert sum(t.numel() * t.element_size() for t in leaves) == 2 * n == 31_412_940_800
    assert params["prefix_0"]["mlp"]["w_gate"].shape == (2048, 10944)
    assert params["blocks"]["0"]["moe"]["shared"]["w_down"].shape == (26, 2 * 1408, 2048)
    cache = TT.init_cache(cfg.with_(kv_cache_dtype="int8"), 4, 1024, device="meta")
    assert cache["blocks"]["0"]["c_kv"].shape == (26, 4, 1024, 512)
    assert cache["prefix_0"]["k_rope"].shape == (4, 1024, 64)
    assert cache["prefix_0"]["c_kv"].dtype == torch.bfloat16   # int8 or not


# ---------------------------------------------------------------------------
# the MLA mixer
# ---------------------------------------------------------------------------
def _mla_layer(jparams):
    jp = jparams["prefix_0"]["attn"]
    return jp, _bridge(jp)


def test_mla_qkv_and_full_match_jax(pair):
    jcfg, tcfg, jparams, _ = pair
    jp, tp = _mla_layer(jparams)
    rng = np.random.default_rng(60)
    x = rng.normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11)[None] + np.array([[0], [5]]), (2, 11)).astype(np.int32)
    for want, got in zip(JL._mla_qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos)),
                         TL._mla_qkv(tp, tcfg, torch.from_numpy(x),
                                     torch.from_numpy(pos.copy()))):
        assert tuple(got.shape) == want.shape
        _close(got, want, MODEL_TOL)
    pos = np.broadcast_to(np.arange(11)[None], (2, 11)).astype(np.int32)
    jo, jc = JL.mla_full(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    to, tc = TL.mla_full(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos.copy()))
    _close(to, jo, MODEL_TOL)
    assert set(tc) == set(jc) == {"c_kv", "k_rope"}
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name], MODEL_TOL)


def _decode_inputs(jcfg, seed):
    """Three rows over an 8-slot cache: lengths 0, 5 and S_max, each row
    zero from its length on, as the engine's caches are (JAX adds the new
    latent to that zero; the port writes it)."""
    m = jcfg.mla
    rng = np.random.default_rng(seed)
    lens = np.array([0, 5, 8], np.int32)
    x = rng.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
    filled = (np.arange(8)[None, :] < lens[:, None])[..., None]
    c = rng.normal(size=(3, 8, m.kv_lora_rank)).astype(np.float32) * filled
    r = rng.normal(size=(3, 8, m.rope_head_dim)).astype(np.float32) * filled
    return x, c, r, lens


def test_mla_decode_matches_jax(pair):
    jcfg, tcfg, jparams, _ = pair
    jp, tp = _mla_layer(jparams)
    x, c, r, lens = _decode_inputs(jcfg, 61)
    jo, jc, jr = JL.mla_decode(jp, jcfg, jnp.asarray(x), jnp.asarray(c), jnp.asarray(r),
                               jnp.asarray(lens))
    tc, tr = torch.from_numpy(c.copy()), torch.from_numpy(r.copy())
    to, tc2, tr2 = TL.mla_decode(tp, tcfg, torch.from_numpy(x), tc, tr,
                                 torch.from_numpy(lens))
    assert tc2 is tc and tr2 is tr                    # written in place
    _close(to, jo, MODEL_TOL)
    _close(tc, jc, MODEL_TOL)
    _close(tr, jr, MODEL_TOL)
    assert torch.equal(tc[2], torch.from_numpy(c[2]))  # the row at S_max wrote nothing
    assert not torch.equal(tc[0, 0], torch.from_numpy(c[0, 0]))


def test_absorbed_decode_matches_jax_and_the_expanded_form(pair):
    jcfg, tcfg, jparams, _ = pair
    jp, tp = _mla_layer(jparams)
    x, c, r, lens = _decode_inputs(jcfg, 62)
    jo, jc, jr = JT._mla_decode_absorbed(
        jp, jcfg, jnp.asarray(x), {"c_kv": jnp.asarray(c), "k_rope": jnp.asarray(r)},
        jnp.asarray(lens))
    cache = {"c_kv": torch.from_numpy(c.copy()), "k_rope": torch.from_numpy(r.copy())}
    to = TT._mla_decode_absorbed(tp, tcfg, torch.from_numpy(x), cache,
                                 torch.from_numpy(lens))
    _close(to, jo, MODEL_TOL)
    _close(cache["c_kv"], jc, MODEL_TOL)
    _close(cache["k_rope"], jr, MODEL_TOL)
    assert torch.equal(cache["c_kv"][2], torch.from_numpy(c[2]))
    # the absorbed form computes the expanded form's function
    expanded, _, _ = TL.mla_decode(tp, tcfg, torch.from_numpy(x), torch.from_numpy(c.copy()),
                                   torch.from_numpy(r.copy()), torch.from_numpy(lens))
    _close(to, expanded, MODEL_TOL)


# ---------------------------------------------------------------------------
# shared experts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_tokens", [1, 4, 23])
@pytest.mark.parametrize("arch", [ARCH, "kimi_k2_1t_a32b"])
def test_moe_with_shared_experts_matches_jax(arch, n_tokens):
    jcfg = jax_smoke_config(arch).with_(dtype="float32")
    tcfg = get_smoke_config(arch).with_(dtype="float32")
    assert tcfg.moe.n_shared == 1

    def build(key):
        mk = JL.Maker(key, jcfg.jdtype)
        JM.init_moe(mk, jcfg)
        return mk.params

    jp = build(jax.random.key(3))
    tp = _bridge(jp)
    x = np.random.default_rng(63).normal(size=(1, n_tokens, jcfg.d_model)).astype(np.float32)
    want = JM.moe_dense(jp, jcfg, jnp.asarray(x))
    _close(TM.moe_dense(tp, tcfg, torch.from_numpy(x)), want, MODEL_TOL)
    _close(TM.moe_block(tp, tcfg, torch.from_numpy(x)), want, MODEL_TOL)
    # the shared MLP is not a routed expert: without it the output moves
    no_shared = {k: v for k, v in tp.items() if k != "shared"}
    routed = TM.moe_block(no_shared, tcfg.with_(moe=_no_shared(tcfg.moe)), torch.from_numpy(x))
    shared = TL.mlp(tp["shared"], torch.from_numpy(x))
    _close(routed + shared, want, MODEL_TOL)


def _no_shared(moe):
    import dataclasses

    return dataclasses.replace(moe, n_shared=0)


def test_shared_experts_are_added_after_the_cast_in_bf16():
    """JAX's order in bf16: the routed sum cast to bf16, then the shared
    MLP added in bf16 (bit for bit against that order)."""
    cfg = get_smoke_config("kimi_k2_1t_a32b")
    assert cfg.dtype == "bfloat16"
    p = TM.init_moe(TL.Init(4, cfg.tdtype, "cpu"), cfg)
    x = torch.randn(1, 5, cfg.d_model, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    no = cfg.with_(moe=_no_shared(cfg.moe))
    routed = TM.moe_dense({k: v for k, v in p.items() if k != "shared"}, no, x)
    assert routed.dtype == torch.bfloat16
    want = routed + TL.mlp(p["shared"], x.reshape(-1, cfg.d_model)).reshape(x.shape)
    assert torch.equal(TM.moe_dense(p, cfg, x), want)
    assert torch.equal(TM.moe_block(p, cfg, x),
                       TM.moe_block({k: v for k, v in p.items() if k != "shared"}, no, x)
                       + TL.mlp(p["shared"], x.reshape(-1, cfg.d_model)).reshape(x.shape))


# ---------------------------------------------------------------------------
# model and engine
# ---------------------------------------------------------------------------
def test_layout_and_tree_match_jax(pair):
    jcfg, tcfg, jparams, _ = pair
    assert TT._scan_layout(tcfg) == (1, 1, 2)
    assert [layer_kind(tcfg, i) for i in range(3)] == ["mla+dense_mlp", "mla+moe", "mla+moe"]
    tparams = init_params(tcfg, seed=0, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    leaves = _leaves(tparams, jparams)
    assert len(flat) == len(leaves) == sum(1 for _ in _all_leaves(tparams))
    for (path, want), got in zip(flat, leaves):
        assert tuple(got.shape) == want.shape, path


def test_forward_matches_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    toks = np.random.default_rng(64).integers(0, jcfg.vocab, size=(2, 19)).astype(np.int32)
    jl, jc = jax_forward(jparams, jcfg, jnp.asarray(toks), collect_cache=True)
    tl, tc = forward(tparams, tcfg, torch.from_numpy(toks), collect_cache=True)
    _close(tl, jl, MODEL_TOL)
    assert tc["blocks"]["0"]["c_kv"].shape == (2, 2, 19, tcfg.mla.kv_lora_rank)
    for key in ("prefix_0", "blocks"):
        for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jc[key])[0],
                                     _leaves(tc[key], jc[key])):
            assert tuple(got.shape) == want.shape, (key, path)
            _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("max_len", [32, 16])
def test_prefill_and_decode_match_jax(pair, max_len):
    """Caches of 32, and of 16: the 13-token prompt's rows reach S_max on
    the fourth decode step, which writes nothing."""
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(65)
    toks = rng.integers(0, jcfg.vocab, size=(2, 13)).astype(np.int32)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks), max_len=max_len)
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(toks), max_len=max_len)
    _close(tl, jl, MODEL_TOL)
    _caches_close(tc, jc)
    for _ in range(4):
        nxt = rng.integers(0, jcfg.vocab, size=(2,)).astype(np.int32)
        jl, jc = jax_decode_step(jparams, jcfg, jc, jnp.asarray(nxt))
        tl, tc = decode_step(tparams, tcfg, tc, torch.from_numpy(nxt))
        _close(tl, jl, MODEL_TOL)
        _caches_close(tc, jc)


@pytest.mark.parametrize("scenario", sorted(SLOT_SCENARIOS))
def test_engine_tokens_match_jax(pair, scenario):
    """Also checks ``_merge_slot`` on ``prefix_0`` (slot axis 0) and the
    stacked blocks (slot axis 1)."""
    jcfg, tcfg, jparams, tparams = pair
    kw, arrivals = SLOT_SCENARIOS[scenario]
    je = JaxEngine(jcfg, params=jparams, **kw)
    te = LLMEngine(tcfg, params=tparams, device="cpu", **kw)
    want = _drive(je, JaxRequest, arrivals)
    got = _drive(te, Request, arrivals)
    assert got == want and len(got) == len(arrivals)
    if scenario == "max_len_limit":
        assert sorted(map(len, got.values())) == [7, 16]
    _caches_close(te.cache, je.cache)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------
LAUNCH = ["--arch", "deepseek-v2-lite-16b", "--jobs", "3", "--token-scale", "40"]


def test_launcher_serves_deepseek_slot_replicas(capsys):
    assert serve.main(LAUNCH + ["--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[serve] scheduler=llmsched ") and " jobs=3 " in line


def test_launcher_refuses_paged_mla_replicas_as_jax_does():
    argv = LAUNCH + ["--engine", "paged"]
    with pytest.raises(SystemExit, match="not paged-KV compatible") as want:
        jax_serve.main(argv)
    with pytest.raises(SystemExit, match="not paged-KV compatible") as got:
        serve.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
