"""The port's hybrid (Jamba) family against the JAX package's, on the CPU.

On the CPU the port's entry points run the plain PyTorch versions of the
kernels, so these hold

- :func:`repro_torch.kernels.ref.ssm_scan_ref` against the Pallas
  ``ssm_scan`` kernel in interpret mode and JAX's ``ssm_scan_ref``
  (``tests/test_kernels.py``'s shapes, ragged T and D, T = 1, bf16 inputs
  and a state carried across two halves);
- the Mamba mixer (``mamba_full``/``mamba_decode``) and the MoE FFN
  (the oracle ``moe_dense`` and the routed ``moe_block``) against JAX's at
  ``jamba-smoke`` widths;
- ``forward``, ``prefill`` and ``decode_step`` logits and caches (K/V and
  Mamba states) against the JAX model's on bridged float32 weights, at 8
  layers (one stacked superblock) and 5 layers (unstacked prefix layers);
- ``LLMEngine(device="cpu")`` against the JAX ``LLMEngine`` token for
  token, in both layouts, with batching, mid-stream slot re-use and the
  ``max_len`` limit;
- the launcher over hybrid slot replicas, and its refusal of paged ones.

The CUDA kernel itself is held against the plain version on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ref as JR
from repro.kernels.ssm_scan import ssm_scan as pallas_ssm_scan
from repro.launch import serve as jax_serve
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import moe as JM
from repro.models import prefill as jax_prefill
from repro.models import ssm as JS
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import ssm_scan as cuda_ssm_scan
from repro_torch.launch import serve
from repro_torch.models import decode_step, forward, init_params, prefill
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.models.transformer import _scan_layout
from repro_torch.serving import LLMEngine, Request

ARCH = "jamba_1_5_large_398b"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# tests/test_kernels.py's ssm tolerance (f32 summation order over T); bf16
# inputs add one rounding of the output
SSM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# logits and caches of the float32 smoke models: summation order only
MODEL_TOL = 1e-4
# layouts: 8 layers tile the pattern (one stacked superblock); 5 do not
# (every layer an unstacked prefix layer)
LAYOUTS = {8: (0, 8, 1), 5: (5, 1, 0)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the selective scan: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------
def _scan_inputs(rng, B, T, D, N):
    """tests/test_kernels.py's value ranges, as numpy float32."""
    return (rng.normal(size=(B, T, D)) * 0.5,
            np.abs(rng.normal(size=(B, T, D))) * 0.1,
            -(np.abs(rng.normal(size=(D, N))) + 0.1),
            rng.normal(size=(B, T, N)) * 0.3,
            rng.normal(size=(B, T, N)) * 0.3,
            rng.normal(size=(D,)))


def _both(arrays, dtype):
    """JAX arrays and CPU tensors of the scan inputs; A stays float32."""
    arrays = [np.asarray(a, np.float32) for a in arrays]
    jx = [jnp.asarray(a, jnp.float32 if i == 2 else JDT[dtype]) for i, a in enumerate(arrays)]
    tx = [torch.from_numpy(a).to(torch.float32 if i == 2 else TDT[dtype])
          for i, a in enumerate(arrays)]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,T,D,N,chunk,d_block",
    [(2, 256, 128, 16, 64, 64), (1, 128, 256, 8, 128, 128), (2, 64, 64, 16, 32, 64),
     (2, 1, 128, 16, 128, 64),       # one decode step
     (1, 37, 100, 16, 16, 64)],      # ragged T and D (JAX sends these to its oracle)
)
def test_ssm_scan_ref_matches_pallas(B, T, D, N, chunk, d_block, dtype):
    rng = np.random.default_rng(50)
    jx, tx = _both(_scan_inputs(rng, B, T, D, N), dtype)
    h0 = rng.normal(size=(B, D, N)).astype(np.float32) * 0.2
    y, h = ops.ssm_scan(*tx, h0=torch.from_numpy(h0))
    assert y.shape == (B, T, D) and y.dtype == TDT[dtype]
    assert h.shape == (B, D, N) and h.dtype == torch.float32
    yp, hp = pallas_ssm_scan(*jx, h0=jnp.asarray(h0), chunk=chunk, d_block=d_block,
                             interpret=True)
    yr, hr = JR.ssm_scan_ref(*jx, h0=jnp.asarray(h0))
    for want_y, want_h in ((yp, hp), (yr, hr)):
        _close(y, want_y, SSM_TOL[dtype])
        _close(h, want_h, SSM_TOL["float32"] if dtype == "float32" else SSM_TOL[dtype])


@pytest.mark.parametrize("split", [1, 64, 127])
def test_ssm_scan_ref_carries_state_across_halves(split):
    """Two halves with the first's final state carried equal the whole."""
    rng = np.random.default_rng(51)
    _, (x, dt, A, Bm, Cm, Dk) = _both(_scan_inputs(rng, 1, 128, 64, 8), "float32")
    y_full, h_full = ops.ssm_scan(x, dt, A, Bm, Cm, Dk)
    y1, h1 = ops.ssm_scan(x[:, :split], dt[:, :split], A, Bm[:, :split], Cm[:, :split], Dk)
    y2, h2 = ops.ssm_scan(x[:, split:], dt[:, split:], A, Bm[:, split:], Cm[:, split:], Dk,
                          h0=h1)
    _close(torch.cat([y1, y2], dim=1), y_full, SSM_TOL["float32"])
    _close(h2, h_full, SSM_TOL["float32"])


def test_ssm_scan_kernel_takes_cuda_tensors_only():
    """A CPU tensor never reaches the kernel: impl="cuda" and the wrapper raise."""
    x = torch.zeros(1, 4, 8)
    A, Bm, D = torch.zeros(8, 4), torch.zeros(1, 4, 4), torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssm_scan(x, x, A, Bm, Bm, D, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ssm_scan(x, x, A, Bm, Bm, D)
    y, h = ops.ssm_scan(x, x, A, Bm, Bm, D, impl="ref")
    assert y.shape == (1, 4, 8) and h.shape == (1, 8, 4)


# ---------------------------------------------------------------------------
# Mamba mixer and MoE FFN at jamba-smoke widths
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[8, 5], ids=["stacked8", "prefix5"])
def pair(request):
    """(jax cfg, port cfg, jax params, port params) on bridged f32 weights."""
    n = request.param
    jcfg = jax_smoke_config(ARCH).with_(dtype="float32", n_layers=n)
    tcfg = get_smoke_config(ARCH).with_(dtype="float32", n_layers=n)
    jparams = jax_init_params(jcfg, jax.random.key(0))[0]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _layer(params, i):
    """Layer i of an 8-layer (stacked) tree: superblock 0, position i."""
    return jax.tree.map(lambda a: a[0], params["blocks"][str(i)])


@pytest.fixture(scope="module")
def stacked_pair():
    jcfg = jax_smoke_config(ARCH).with_(dtype="float32")
    tcfg = get_smoke_config(ARCH).with_(dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(1))[0]
    return jcfg, tcfg, jparams


def test_mamba_full_and_decode_match_jax(stacked_pair):
    jcfg, tcfg, jparams = stacked_pair
    jp = _layer(jparams, 0)["mamba"]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["A_log"].dtype == torch.float32
    rng = np.random.default_rng(52)
    x = rng.normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    jo, jst = JS.mamba_full(jp, jcfg, jnp.asarray(x))
    to, tst = TS.mamba_full(tp, tcfg, torch.from_numpy(x))
    _close(to, jo, MODEL_TOL)
    for name in ("conv", "ssm"):
        assert tuple(tst[name].shape) == jst[name].shape
        _close(tst[name], jst[name], MODEL_TOL)
    for _ in range(3):
        x1 = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jo, jst = JS.mamba_decode(jp, jcfg, jnp.asarray(x1), jst)
        to, tst = TS.mamba_decode(tp, tcfg, torch.from_numpy(x1), tst)
        _close(to, jo, MODEL_TOL)
        for name in ("conv", "ssm"):
            _close(tst[name], jst[name], MODEL_TOL)


@pytest.mark.parametrize("n_tokens", [1, 4, 23])
def test_moe_dense_and_routed_match_jax(stacked_pair, n_tokens):
    jcfg, tcfg, jparams = stacked_pair
    jp = _layer(jparams, 0)["moe"]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(53)
    x = rng.normal(size=(1, n_tokens, jcfg.d_model)).astype(np.float32)
    want = JM.moe_dense(jp, jcfg, jnp.asarray(x))
    dense = TM.moe_dense(tp, tcfg, torch.from_numpy(x))
    routed = TM.moe_block(tp, tcfg, torch.from_numpy(x))
    _close(dense, want, MODEL_TOL)
    _close(routed, want, MODEL_TOL)
    # the two forms differ in summation order only (the experts' products
    # run over other row sets, the weighted sum adds two terms, not E)
    _close(routed, dense, MODEL_TOL)


def test_routed_moe_reads_only_the_chosen_experts(stacked_pair):
    """NaN in every expert no token chose leaves the routed output as it was."""
    jcfg, tcfg, jparams = stacked_pair
    tp = params_from_numpy(jax.tree.map(np.asarray, _layer(jparams, 2)["moe"]), "cpu")
    x = torch.from_numpy(np.random.default_rng(54).normal(
        size=(1, 1, jcfg.d_model)).astype(np.float32))
    _, ids = TM._routing(tp, tcfg, x.reshape(1, -1))
    unused = sorted(set(range(tcfg.moe.n_experts)) - set(ids.flatten().tolist()))
    assert unused
    poisoned = dict(tp)
    for name in ("w_gate", "w_up", "w_down"):
        poisoned[name] = tp[name].clone()
        poisoned[name][unused] = float("nan")
    assert torch.equal(TM.moe_block(poisoned, tcfg, x), TM.moe_block(tp, tcfg, x))


# ---------------------------------------------------------------------------
# model: forward, prefill / decode_step and the caches vs JAX
# ---------------------------------------------------------------------------
def _caches_close(tc, jc):
    assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()
    assert set(tc) == set(jc)
    for key in jc:
        if key == "lengths":
            continue
        for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jc[key])[0],
                                     _leaves(tc[key], jc[key])):
            assert tuple(got.shape) == want.shape, (key, path)
            _close(got, want, MODEL_TOL)


def _leaves(ttree, jtree):
    """The port's leaves in the order JAX flattens ``jtree`` (sorted keys)."""
    if isinstance(jtree, dict):
        return [leaf for k in sorted(jtree) for leaf in _leaves(ttree[k], jtree[k])]
    return [ttree]


def test_layout_and_kinds(pair):
    jcfg, tcfg, jparams, tparams = pair
    assert _scan_layout(tcfg) == LAYOUTS[tcfg.n_layers]
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_t = _leaves(tparams, jparams)
    assert len(flat_j) == len(flat_t)
    for (path, want), got in zip(flat_j, flat_t):
        assert tuple(got.shape) == want.shape, path
        assert got.dtype == torch.float32


def test_forward_matches_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    toks = np.random.default_rng(55).integers(0, jcfg.vocab, size=(2, 19)).astype(np.int32)
    jl, _ = jax_forward(jparams, jcfg, jnp.asarray(toks))
    tl, _ = forward(tparams, tcfg, torch.from_numpy(toks))
    _close(tl, jl, MODEL_TOL)


def test_prefill_and_decode_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(56)
    toks = rng.integers(0, jcfg.vocab, size=(2, 13)).astype(np.int32)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks), max_len=32)
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(toks), max_len=32)
    _close(tl, jl, MODEL_TOL)
    _caches_close(tc, jc)
    for _ in range(4):
        nxt = rng.integers(0, jcfg.vocab, size=(2,)).astype(np.int32)
        jl, jc = jax_decode_step(jparams, jcfg, jc, jnp.asarray(nxt))
        tl, tc = decode_step(tparams, tcfg, tc, torch.from_numpy(nxt))
        _close(tl, jl, MODEL_TOL)
        _caches_close(tc, jc)


# ---------------------------------------------------------------------------
# engine: LLMEngine vs the JAX LLMEngine, token for token
# ---------------------------------------------------------------------------
# (arrival step, prompt, new tokens): requests join when a slot is free
SLOT_SCENARIOS = {
    # four requests batched at once
    "batching": (dict(max_batch=4, max_len=64),
                 [(0, [1, 2, 3], 6), (0, list(range(4, 20)), 4),
                  (0, [7] * 9, 8), (0, list(range(40, 51)), 5)]),
    # requests join mid-stream into slots whose Mamba state a finished
    # request (and the decode steps over the free slot) left behind
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
    if scenario == "max_len_limit":
        assert sorted(map(len, got.values())) == [7, 16]
    # the engines' caches agree after the run (the Mamba states included)
    _caches_close(te.cache, je.cache)


# ---------------------------------------------------------------------------
# weights, config, launcher
# ---------------------------------------------------------------------------
def test_full_config_carries_published_numbers():
    """tests/test_models_smoke.py's numbers, and the Mamba/MoE widths."""
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab) == (72, 8192, 64, 8, 24576, 65536)
    assert (cfg.mamba.d_state, cfg.mamba.d_conv, cfg.mamba.expand) == (16, 4, 2)
    assert TS._dt_rank(cfg) == 512
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
            cfg.moe.layer_period) == (16, 2, 24576, 2)
    assert get_config("jamba-1.5-large-398b") == cfg


def test_five_full_width_layers_hold_every_layer_kind():
    """The card's cut: 5 layers (prefix layout) hold every kind of the
    period, 66.2 GB of bf16 weights (built on the meta device)."""
    from repro_torch.models import layer_kind

    cfg = get_config(ARCH).with_(n_layers=5)
    assert _scan_layout(cfg) == (5, 1, 0)
    assert [layer_kind(cfg, i) for i in range(5)] == [
        "mamba+moe", "mamba+mlp", "mamba+moe", "mamba+mlp", "attn+moe"]
    params = init_params(cfg, seed=0, device="meta")

    def nbytes(t):
        return (sum(nbytes(v) for v in t.values()) if isinstance(t, dict)
                else t.numel() * t.element_size())

    assert nbytes(params) == 66_213_167_104
    assert params["prefix_0"]["mamba"]["A_log"].dtype == torch.float32
    assert params["prefix_0"]["moe"]["w_gate"].dtype == torch.bfloat16


def test_large_draws_come_in_slabs(monkeypatch):
    """A tensor over the whole-draw limit is drawn slab by slab along its
    first axis, with the same shape, dtype and spread."""
    monkeypatch.setattr(TL, "WHOLE_DRAW", 1000)
    init = TL.Init(0, torch.bfloat16, "cpu")
    w = init.dense((6, 40, 50), fan_in=16)
    assert w.shape == (6, 40, 50) and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) - 0.25) < 0.02
    assert not torch.equal(w[0], w[1])


def test_bridge_keeps_a_log_float32_in_a_bf16_tree():
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, seed=2, device="cpu")
    back = params_from_numpy(params_to_numpy(params), "cpu", dtype=torch.bfloat16)
    a = back["blocks"]["0"]["mamba"]["A_log"]
    assert a.dtype == torch.float32
    assert torch.equal(a, params["blocks"]["0"]["mamba"]["A_log"])
    assert torch.equal(back["blocks"]["0"]["moe"]["w_up"], params["blocks"]["0"]["moe"]["w_up"])


LAUNCH = ["--arch", "jamba-1.5-large-398b", "--jobs", "3", "--token-scale", "40"]


@pytest.mark.parametrize("scheduler", ["llmsched", "fcfs"])
def test_launcher_serves_hybrid_slot_replicas(capsys, scheduler):
    assert serve.main(LAUNCH + ["--scheduler", scheduler, "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[serve] scheduler={scheduler} ") and " jobs=3 " in line


def test_launcher_refuses_paged_hybrid_replicas_as_jax_does():
    argv = LAUNCH + ["--engine", "paged"]
    with pytest.raises(SystemExit, match="not paged-KV compatible") as want:
        jax_serve.main(argv)
    with pytest.raises(SystemExit, match="not paged-KV compatible") as got:
        serve.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
