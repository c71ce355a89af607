"""The port's xLSTM family against JAX's.

xLSTM-350M's smoke config (4 layers: 3 mLSTM cells and an sLSTM cell in
one stacked superblock, no FFN) in float32, on weights built by the JAX
package and bridged into the port.  On the CPU the port's entry points run
the plain versions of the kernels (only RMSNorm: the cells have no
kernel, in either package), so these hold

- the ``init_mlstm`` / ``init_slstm`` trees at the smoke and published
  widths, and the layer kinds and superblock layout of the published
  config (7 mLSTM + 1 sLSTM a superblock, 3 superblocks);
- ``mlstm_full`` and ``slstm_full``, fresh and from a carried state, with
  the gate pre-activations pushed to +-30 (the stabiliser ``m`` carries
  everything there), and the sLSTM's recurrence ``r_izfo`` overwritten
  with seeded non-zero values in **both** trees (JAX draws it as zeros,
  so bridged weights alone never exercise it);
- ``forward``, ``prefill`` and ``decode_step`` logits and recurrent
  states, and prefill plus decode against ``forward``;
- ``LLMEngine(device="cpu")`` against the JAX ``LLMEngine`` token for
  token in the hybrid suite's slot scenarios (a freed slot re-used
  mid-stream included), with the states the engines hold afterwards;
- the launcher's ``--arch xlstm-350m``.
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
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import prefill as jax_prefill
from repro.models import ssm as JS
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import decode_step, forward, init_params, layer_kind, prefill
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.serving import LLMEngine, Request
from test_torch_hybrid import SLOT_SCENARIOS, _caches_close, _close, _drive, _leaves

ARCH = "xlstm_350m"
# logits, outputs and states of the float32 smoke models: summation order only
MODEL_TOL = 1e-4


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _with_recurrence(jparams, seed):
    """JAX's tree with every sLSTM ``r_izfo`` replaced by seeded values of
    spread 0.5 (JAX draws zeros)."""
    rng = np.random.default_rng(seed)

    def put(path, leaf):
        if path[-1].key == "r_izfo":
            return jnp.asarray(rng.normal(scale=0.5, size=leaf.shape).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(put, jparams)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, port cfg, jax params, port params) on bridged f32 weights,
    the sLSTM recurrence non-zero in both."""
    jcfg = jax_smoke_config(ARCH).with_(dtype="float32")
    tcfg = get_smoke_config(ARCH).with_(dtype="float32")
    jparams = _with_recurrence(jax_init_params(jcfg, jax.random.key(0))[0], 60)
    return jcfg, tcfg, jparams, _bridge(jparams)


def _cell(jparams, j):
    """The cell weights of pattern position j, superblock 0."""
    return jax.tree.map(lambda a: a[0], jparams["blocks"][str(j)]["cell"])


# ---------------------------------------------------------------------------
# weight trees and layout
# ---------------------------------------------------------------------------
def _jax_tree(init_fn, cfg):
    def build(key):
        mk = JL.Maker(key, cfg.jdtype)
        init_fn(mk, cfg)
        return mk.params

    return jax.eval_shape(build, jax.random.key(0))


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "published"])
@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_init_trees_match_jax(cell, full):
    jcfg = jax_get_config(ARCH) if full else jax_smoke_config(ARCH)
    tcfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    j_init, t_init = {"mlstm": (JS.init_mlstm, TS.init_mlstm),
                      "slstm": (JS.init_slstm, TS.init_slstm)}[cell]
    want = _jax_tree(j_init, jcfg)
    got = t_init(TL.Init(0, tcfg.tdtype, "meta"), tcfg, (3,))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == (3,) + w.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(w.dtype), name


def test_published_layout_and_tree_match_jax():
    """xLSTM-350M whole: 3 superblocks of 7 mLSTM + 1 sLSTM, no FFN; the
    port's tree (on ``meta``) has JAX's leaves, shapes and dtypes."""
    cfg = get_config("xlstm-350m")
    assert TT._scan_layout(cfg) == (0, 8, 3)
    kinds = [layer_kind(cfg, i) for i in range(cfg.n_layers)]
    assert kinds == (["mlstm+none"] * 7 + ["slstm+none"]) * 3
    jcfg = jax_get_config(ARCH)
    want = jax.eval_shape(lambda k: jax_init_params(jcfg, k)[0], jax.random.key(0))
    got = init_params(cfg, seed=0, device="meta")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = _leaves(got, want)
    assert len(flat) == len(leaves)
    for (path, w), g in zip(flat, leaves):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    assert "norm2" not in got["blocks"]["0"]
    n = sum(g.numel() for g in leaves)
    assert 2 * n == 1_207_150_592          # bytes of bf16 weights
    cache = TT.init_cache(cfg, 4, 64, device="meta")
    assert cache["blocks"]["0"]["C"].shape == (3, 4, 4, 512, 512)
    assert cache["blocks"]["7"]["h"].shape == (3, 4, 1024)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------
def _scaled(p, names, col_slice, scale):
    """A copy of a cell's weights with columns ``col_slice`` of each named
    matrix scaled (gate pre-activations of a chosen size)."""
    out = dict(p)
    for name in names:
        w = np.array(p[name])
        w[..., col_slice] *= scale
        out[name] = jnp.asarray(w)
    return out


def _gate_scale(u, w, target):
    """The factor that makes ``u @ w``'s largest magnitude ``target``."""
    return target / float(np.abs(np.asarray(u) @ np.asarray(w)).max())


# gates: ("plain", no scaling) and pre-activations pushed to +-30
GATES = ["plain", "i30", "f30", "both30"]


def _mlstm_params(jcfg, jp, x, gates):
    if gates == "plain":
        return jp
    di = int(jcfg.d_model * jcfg.xlstm.proj_factor)
    u = (jnp.asarray(x) @ jp["up_proj"])[..., :di].reshape(-1, di)
    names = {"i30": ["w_i"], "f30": ["w_f"], "both30": ["w_i", "w_f"]}[gates]
    out = dict(jp)
    for name in names:
        out = _scaled(out, [name], slice(None), _gate_scale(u, jp[name], 30.0))
    return out


@pytest.mark.parametrize("gates", GATES)
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_mlstm_full_matches_jax(pair, carried, gates):
    jcfg, tcfg, jparams, _ = pair
    rng = np.random.default_rng(61)
    x = rng.normal(size=(2, 13, jcfg.d_model)).astype(np.float32)
    jp = _mlstm_params(jcfg, _cell(jparams, 0), x, gates)
    tp = _bridge(jp)
    jst = tst = None
    if carried:
        x0 = rng.normal(size=(2, 6, jcfg.d_model)).astype(np.float32)
        _, jst = JS.mlstm_full(jp, jcfg, jnp.asarray(x0))
        _, tst = TS.mlstm_full(tp, tcfg, torch.from_numpy(x0))
    jo, jst2 = JS.mlstm_full(jp, jcfg, jnp.asarray(x), state=jst)
    to, tst2 = TS.mlstm_full(tp, tcfg, torch.from_numpy(x), state=tst)
    _close(to, jo, MODEL_TOL)
    assert sorted(tst2) == ["C", "m", "n"]
    for name in ("C", "n", "m"):
        assert tst2[name].dtype == torch.float32
        assert tuple(tst2[name].shape) == jst2[name].shape
        _close(tst2[name], jst2[name], MODEL_TOL)
    di = int(jcfg.d_model * jcfg.xlstm.proj_factor)
    u = x.reshape(-1, jcfg.d_model) @ np.asarray(jp["up_proj"])[:, :di]
    for name, on in (("w_i", gates in ("i30", "both30")), ("w_f", gates in ("f30", "both30"))):
        top = float(np.abs(u @ np.asarray(jp[name])).max())
        assert (abs(top - 30.0) < 1e-3) == on, (name, top)


def _slstm_params(jcfg, jp, x, gates):
    if gates == "plain":
        return jp
    d = jcfg.d_model
    blocks = {"i30": [0], "f30": [2], "both30": [0, 2]}[gates]
    out = dict(jp)
    for blk in blocks:
        cols = slice(blk * d, (blk + 1) * d)
        s = _gate_scale(x.reshape(-1, d), np.asarray(jp["w_izfo"])[:, cols], 30.0)
        out = _scaled(out, ["w_izfo"], cols, s)
    return out


@pytest.mark.parametrize("gates", GATES)
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_slstm_full_matches_jax(pair, carried, gates):
    jcfg, tcfg, jparams, _ = pair
    rng = np.random.default_rng(62)
    x = rng.normal(size=(2, 13, jcfg.d_model)).astype(np.float32)
    jp = _slstm_params(jcfg, _cell(jparams, 3), x, gates)
    assert float(np.abs(np.asarray(jp["r_izfo"])).min()) > 0.0   # recurrence live
    tp = _bridge(jp)
    jst = tst = None
    if carried:
        x0 = rng.normal(size=(2, 6, jcfg.d_model)).astype(np.float32)
        _, jst = JS.slstm_full(jp, jcfg, jnp.asarray(x0))
        _, tst = TS.slstm_full(tp, tcfg, torch.from_numpy(x0))
    jo, jst2 = JS.slstm_full(jp, jcfg, jnp.asarray(x), state=jst)
    to, tst2 = TS.slstm_full(tp, tcfg, torch.from_numpy(x), state=tst)
    _close(to, jo, MODEL_TOL)
    assert sorted(tst2) == ["c", "h", "m", "n"]
    for name in ("c", "n", "h", "m"):
        assert tst2[name].dtype == torch.float32
        _close(tst2[name], jst2[name], MODEL_TOL)


# ---------------------------------------------------------------------------
# model: forward, prefill / decode_step and the states vs JAX
# ---------------------------------------------------------------------------
def test_forward_matches_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    toks = np.random.default_rng(63).integers(0, jcfg.vocab, size=(2, 19)).astype(np.int32)
    jl, _ = jax_forward(jparams, jcfg, jnp.asarray(toks))
    tl, _ = forward(tparams, tcfg, torch.from_numpy(toks))
    _close(tl, jl, MODEL_TOL)


def test_prefill_and_decode_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(64)
    toks = rng.integers(0, jcfg.vocab, size=(2, 13)).astype(np.int32)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks), max_len=32)
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(toks), max_len=32)
    _close(tl, jl, MODEL_TOL)
    _caches_close(tc, jc)
    state = tc["blocks"]["0"]["C"]
    for _ in range(4):
        nxt = rng.integers(0, jcfg.vocab, size=(2,)).astype(np.int32)
        jl, jc = jax_decode_step(jparams, jcfg, jc, jnp.asarray(nxt))
        tl, tc = decode_step(tparams, tcfg, tc, torch.from_numpy(nxt))
        _close(tl, jl, MODEL_TOL)
        _caches_close(tc, jc)
    assert tc["blocks"]["0"]["C"] is state      # written in place


def test_prefill_then_decode_matches_forward(pair):
    """prefill(t[:n]) then decode steps on the true next tokens give
    ``forward(t)``'s logits (tests/test_models_smoke.py's parity, at the
    model tolerance)."""
    _, tcfg, _, tparams = pair
    toks = torch.arange(12, dtype=torch.int32)[None] % tcfg.vocab
    full, _ = forward(tparams, tcfg, toks)
    last, cache = prefill(tparams, tcfg, toks[:, :8], max_len=32)
    _close(last, full[:, 7], MODEL_TOL)
    for i in range(8, 12):
        lg, cache = decode_step(tparams, tcfg, cache, toks[:, i])
        _close(lg, full[:, i], MODEL_TOL)
    assert cache["lengths"].tolist() == [12]


# ---------------------------------------------------------------------------
# engine and launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scenario", sorted(SLOT_SCENARIOS))
def test_engine_tokens_match_jax(pair, scenario):
    jcfg, tcfg, jparams, tparams = pair
    kw, arrivals = SLOT_SCENARIOS[scenario]
    je = JaxEngine(jcfg, params=jparams, **kw)
    te = LLMEngine(tcfg, params=tparams, device="cpu", **kw)
    want = _drive(je, JaxRequest, arrivals)
    got = _drive(te, Request, arrivals)
    assert got == want and len(got) == len(arrivals)
    assert te.admissions == len(arrivals)
    # the slots' recurrent states agree after the run (a re-used slot's
    # whole state replaced at admission)
    _caches_close(te.cache, je.cache)


@pytest.mark.parametrize("scheduler", ["llmsched", "fcfs"])
def test_launcher_serves_xlstm_slot_replicas(capsys, scheduler):
    argv = ["--arch", "xlstm-350m", "--jobs", "3", "--token-scale", "40",
            "--scheduler", scheduler, "--device", "cpu"]
    assert serve.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[serve] scheduler={scheduler} ") and " jobs=3 " in line
