"""The port's training state against the JAX package's, on the CPU.

- ``repro_torch.distributed.optimizer``: the int8 codec bit for bit, and
  ``adamw_update`` with float32 and int8 state on the same numpy
  parameters, gradients and state as ``repro.distributed.optimizer``;
- ``repro_torch.distributed.checkpoint``: the JAX tests' round trip,
  ``keep_last`` and crash-restart cases, mirrored, and checkpoints read
  across the two packages in both directions with bit-equal leaves
  (bfloat16 parameters and an int8 optimizer state);
- ``repro_torch.bridge``'s optimizer-state converters;
- the plain backward versions ``rmsnorm_bwd_ref``, ``attention_bwd_ref``
  (MLA's head dims too) and ``ssm_scan_bwd_ref`` against ``jax.vjp`` of
  the JAX package's jnp oracles.
"""

import pytest

torch = pytest.importorskip("torch")

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from repro.distributed import checkpoint as jckpt
from repro.distributed import optimizer as jopt
from repro.kernels import ref as jref
from repro_torch.bridge import (
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_from_numpy,
    tensor_from_numpy,
)
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import optimizer as opt
from repro_torch.kernels import ref as R

# float32 AdamW on equal inputs: the same ops in the same order; only a
# libm pow and a summation order (the gradient norm) may differ by an ulp,
# and a moment that cancels (b1 m + (1 - b1) g near 0) carries that ulp of
# its leaf's scale, so moments are held to ADAM_TOL of their leaf's largest
# magnitude
ADAM_TOL = 1e-6
# backward versions against jax.vjp of the oracles, float32: summation
# order only (tests/test_kernels.py's float32 tolerance)
BWD_TOL = 3e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tree_np(rng):
    """A parameter tree in the models' shape: nested dicts, a stacked leaf,
    a vector and a float32 matrix."""
    return {
        "blocks": {"0": {"w": rng.normal(size=(3, 8, 16)).astype(np.float32),
                         "g": (1 + 0.1 * rng.normal(size=(3, 16))).astype(np.float32)}},
        "embedding": rng.normal(size=(32, 16)).astype(np.float32),
        "final_norm": np.ones(16, np.float32),
    }


def _grads_np(rng, tree):
    out = {}
    for k, v in tree.items():
        out[k] = _grads_np(rng, v) if isinstance(v, dict) else \
            (rng.normal(size=v.shape) * rng.choice([1e-3, 1.0, 30.0], size=v.shape)
             ).astype(np.float32)
    return out


def _leaves(tree):
    return jax.tree.leaves(tree)


# ---------------------------------------------------------------------------
# int8 codec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(), (7,), (5, 33), (2, 3, 128)])
def test_q8_is_bit_equal(shape):
    rng = np.random.default_rng(1)
    x = np.asarray(rng.normal(size=shape) * rng.choice([1e-9, 1e-3, 1.0, 1e4], size=shape)
         ).astype(np.float32)
    if len(shape) == 2:
        x[1] = 0.0                       # an all-zero row: the 1e-12 floor
        x[2, :5] = [0.5, -0.5, 1.5, 2.5, -127.0]
    qj, sj = jopt._q8(jnp.asarray(x))
    qt, st = opt._q8(torch.from_numpy(np.asarray(x)))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(opt._dq8(qt, st).numpy(), np.asarray(jopt._dq8(qj, sj)))


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_init_opt_state_matches_jax(state_dtype):
    cfg = opt.OptConfig(state_dtype=state_dtype)
    jcfg = jopt.OptConfig(state_dtype=state_dtype)
    p = _tree_np(np.random.default_rng(2))
    js = jax.tree.map(np.asarray, jopt.init_opt_state(jax.tree.map(jnp.asarray, p), jcfg))
    ts = opt_state_to_numpy(opt.init_opt_state(params_from_numpy(p, "cpu"), cfg))
    jl, tl = _leaves(js), _leaves(ts)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_update_matches_jax(state_dtype):
    """Three steps on equal params, grads and state: params, state and the
    metrics agree to ADAM_TOL (int8 codes exactly)."""
    rng = np.random.default_rng(3)
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0, state_dtype=state_dtype,
              warmup_steps=2)
    cfg, jcfg = opt.OptConfig(**kw), jopt.OptConfig(**kw)
    p = _tree_np(rng)
    jp = jax.tree.map(jnp.asarray, p)
    js = jopt.init_opt_state(jp, jcfg)
    tp = params_from_numpy(p, "cpu")
    ts = opt.init_opt_state(tp, cfg)
    for _ in range(3):
        g = _grads_np(rng, p)
        jp, js, jm = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp, ts, tm = opt.adamw_update(tp, params_from_numpy(g, "cpu"), ts, cfg)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=ADAM_TOL)
        for a, b in zip(_leaves(jp), opt.tree_leaves(tp)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=ADAM_TOL, atol=ADAM_TOL)
        jsn, tsn = jax.tree.map(np.asarray, js), opt_state_to_numpy(ts)
        assert int(tsn["step"]) == int(jsn["step"])
        for a, b in zip(_leaves(jsn["mv"]), _leaves(tsn["mv"])):
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.dtype == np.int8:
                np.testing.assert_array_equal(b, a)
            else:
                np.testing.assert_allclose(b, a, rtol=ADAM_TOL,
                                           atol=ADAM_TOL * np.abs(a).max())


def test_adamw_update_takes_a_bfloat16_parameter():
    """A bfloat16 leaf updates through its float32 copy and is cast once:
    within one bfloat16 ulp of JAX's (equal f32 values round alike; an ulp
    apart in f32 they may round to neighbours)."""
    rng = np.random.default_rng(4)
    cfg, jcfg = opt.OptConfig(lr=1e-2), jopt.OptConfig(lr=1e-2)
    w = rng.normal(size=(6, 32)).astype(np.float32)
    g = rng.normal(size=(6, 32)).astype(np.float32)
    jp = {"w": jnp.asarray(w, jnp.bfloat16)}
    jp, _, _ = jopt.adamw_update(jp, {"w": jnp.asarray(g, jnp.bfloat16)},
                                 jopt.init_opt_state(jp, jcfg), jcfg)
    tp = {"w": torch.from_numpy(w).to(torch.bfloat16)}
    tp, _, _ = opt.adamw_update(tp, {"w": torch.from_numpy(g).to(torch.bfloat16)},
                                opt.init_opt_state(tp, cfg), cfg)
    assert tp["w"].dtype == torch.bfloat16
    want = np.asarray(jp["w"], np.float32)
    np.testing.assert_allclose(_np(tp["w"]), want, rtol=2.0 ** -8, atol=0)


def test_adamw_update_takes_no_gradient_as_zero():
    """A leaf without a gradient (``None``) moves as JAX's zero gradient does."""
    cfg = opt.OptConfig(lr=1e-2)
    p = {"a": torch.ones(4), "b": torch.full((3,), 2.0)}
    q = {k: v.clone() for k, v in p.items()}
    s1, s2 = opt.init_opt_state(p, cfg), opt.init_opt_state(q, cfg)
    g = torch.tensor([0.1, -0.2, 0.3, 0.0])
    opt.adamw_update(p, {"a": g, "b": None}, s1, cfg)
    opt.adamw_update(q, {"a": g, "b": torch.zeros(3)}, s2, cfg)
    assert all(torch.equal(p[k], q[k]) for k in p)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_reduces_loss(state_dtype):
    """tests/test_distributed.py's descent check, on the port."""
    cfg = opt.OptConfig(lr=0.05, weight_decay=0.0, state_dtype=state_dtype,
                        warmup_steps=1)
    w = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32))}
    state = opt.init_opt_state(w, cfg)
    l0 = float(torch.mean(w["w"] ** 2))
    for _ in range(30):
        g = {"w": 2 * w["w"] / w["w"].numel()}
        w, state, _ = opt.adamw_update(w, g, state, cfg)
    assert float(torch.mean(w["w"] ** 2)) < 0.2 * l0


def test_int8_state_memory_is_quarter():
    st = opt.init_opt_state({"w": torch.zeros(128, 256)}, opt.OptConfig(state_dtype="int8"))
    q = st["mv"]["w"]["m"].q
    assert q.dtype == torch.int8 and q.shape == (128, 256)


# ---------------------------------------------------------------------------
# checkpoint (tests/test_distributed.py's cases, mirrored)
# ---------------------------------------------------------------------------
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 16, generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32)}}


def test_checkpoint_roundtrip():
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 10, t)
        ckpt.save_checkpoint(d, 20, {"w": t["w"] + 1, "nested": {"b": t["nested"]["b"] + 1}})
        assert ckpt.latest_step(d) == 20
        restored, step = ckpt.restore_checkpoint(d, like=t)
        assert step == 20
        np.testing.assert_allclose(restored["w"].numpy(), t["w"].numpy() + 1)
        assert restored["nested"]["b"].dtype == torch.int32
        restored10, _ = ckpt.restore_checkpoint(d, like=t, step=10)
        np.testing.assert_allclose(restored10["w"].numpy(), t["w"].numpy())


def test_checkpoint_gc_keeps_last():
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            ckpt.save_checkpoint(d, s, t, keep_last=2)
        steps = sorted(p for p in os.listdir(d) if p.startswith("step_"))
        assert len(steps) == 2 and steps[-1].endswith("5".zfill(8))


def test_checkpoint_crash_restart_resumes():
    """Fault-tolerance: training resumes from the latest atomic step."""
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 100, t)
        os.makedirs(os.path.join(d, ".tmp_crashed"), exist_ok=True)
        _, step = ckpt.restore_checkpoint(d, like=t)
        assert step == 100
        assert ckpt.latest_step(os.path.join(d, "absent")) is None
        with pytest.raises(FileNotFoundError):
            ckpt.restore_checkpoint(os.path.join(d, "absent"), like=t)


def test_checkpoint_sharded_restore_is_not_ported():
    """A sharding tree whose leaf count differs from the target's is
    ignored, as in JAX (``repro/distributed/checkpoint.py:122-125``): the
    restore is the plain one.  The resharding restore itself is held on
    gloo ranks in ``tests/test_torch_multirank.py``.  (The name dates from
    when the port refused ``shardings=``; it is kept so that the test's
    record runs on under one name.)"""
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 1, t)
        restored, step = ckpt.restore_checkpoint(d, like=t, shardings={"w": None})
        assert step == 1
        assert torch.equal(restored["w"], t["w"])
        assert torch.equal(restored["nested"]["b"], t["nested"]["b"])


def _bits(x) -> np.ndarray:
    """A leaf's stored bits: bfloat16 as uint16, anything else as it is."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _jax_training_state():
    """JAX bf16 params and the int8 AdamW state after one step (non-zero codes)."""
    rng = np.random.default_rng(5)
    p = _tree_np(rng)
    jcfg = jopt.OptConfig(lr=1e-2, state_dtype="int8")
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    js = jopt.init_opt_state(jp, jcfg)
    g = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), _grads_np(rng, p))
    jp, js, _ = jopt.adamw_update(jp, g, js, jcfg)
    return jp, js, p


def test_checkpoint_written_by_jax_restores_in_the_port_bit_for_bit():
    jp, js, p = _jax_training_state()
    like = (params_from_numpy(p, "cpu", torch.bfloat16),
            opt.init_opt_state(params_from_numpy(p, "cpu", torch.bfloat16),
                               opt.OptConfig(state_dtype="int8")))
    with tempfile.TemporaryDirectory() as d:
        jckpt.save_checkpoint(d, 7, (jp, js))
        (tp, ts), step = ckpt.restore_checkpoint(d, like=like)
    assert step == 7
    assert tp["embedding"].dtype == torch.bfloat16
    assert isinstance(ts["mv"]["embedding"]["m"], opt.QTensor)
    want, got = _leaves((jp, js)), ckpt._flatten((tp, ts))
    assert len(want) == len(got) == 4 + 4 * 2 * 2 + 1  # params, (q, s) of m and v, step
    for a, b in zip(want, got):
        assert np.asarray(a).shape == tuple(b.shape)
        np.testing.assert_array_equal(_bits(b), _bits(a))


def test_checkpoint_written_by_the_port_restores_in_jax_bit_for_bit():
    rng = np.random.default_rng(6)
    p = _tree_np(rng)
    cfg = opt.OptConfig(lr=1e-2, state_dtype="int8")
    tp = params_from_numpy(p, "cpu", torch.bfloat16)
    ts = opt.init_opt_state(tp, cfg)
    tp, ts, _ = opt.adamw_update(tp, params_from_numpy(_grads_np(rng, p), "cpu",
                                                       torch.bfloat16), ts, cfg)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    like = (jp, jopt.init_opt_state(jp, jopt.OptConfig(state_dtype="int8")))
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 9, (tp, ts))
        (rp, rs), step = jckpt.restore_checkpoint(d, like=like)
    assert step == 9
    assert np.asarray(rp["embedding"]).dtype.name == "bfloat16"
    got, want = _leaves((rp, rs)), ckpt._flatten((tp, ts))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_opt_state_bridge_round_trips_jax_state():
    _, js, _ = _jax_training_state()
    jsn = jax.tree.map(np.asarray, js)
    ts = opt_state_from_numpy(jsn, "cpu")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 1
    q = ts["mv"]["blocks"]["0"]["w"]["m"]
    assert isinstance(q, opt.QTensor) and q.q.dtype == torch.int8 and q.s.dtype == torch.float32
    back = opt_state_to_numpy(ts)
    for a, b in zip(_leaves(jsn), _leaves(back)):
        np.testing.assert_array_equal(b, a)


def test_tensor_from_numpy_reads_jax_bfloat16_bits():
    x = jnp.asarray(np.linspace(-3, 3, 11), jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(t), _bits(x))


# ---------------------------------------------------------------------------
# plain backward versions against jax.vjp of the oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,d", [(1, 64), (7, 48), (33, 100)])
def test_rmsnorm_bwd_ref_matches_jax_vjp(rows, d):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    g = (1 + 0.3 * rng.normal(size=d)).astype(np.float32)
    dy = rng.normal(size=(rows, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm_ref(a, b, 1e-5), jnp.asarray(x), jnp.asarray(g))
    jdx, jdg = vjp(jnp.asarray(dy))
    dx, dg = R.rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(dy), 1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=BWD_TOL, rtol=BWD_TOL)
    np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), atol=BWD_TOL * rows,
                               rtol=BWD_TOL)


def _bwd_case(B, Sq, Sk, H, K, hd, causal, hd_v=None):
    """A case of the test below; ``hd_v`` (v's head dim) defaults to hd,
    and the hd == hd_v cases keep their ids."""
    ident = f"{B}-{Sq}-{Sk}-{H}-{K}-{hd}-{causal}" + ("" if hd_v is None else f"-hdv{hd_v}")
    return pytest.param(B, Sq, Sk, H, K, hd, causal, hd_v or hd, id=ident)


@pytest.mark.parametrize(
    "B,Sq,Sk,H,K,hd,causal,hd_v",
    [
        _bwd_case(1, 64, 64, 4, 4, 16, True),      # MHA, causal
        _bwd_case(2, 40, 40, 6, 2, 16, True),      # GQA g = 3, ragged
        _bwd_case(1, 24, 37, 4, 4, 16, False),     # bidirectional, Sq != Sk, ragged
        _bwd_case(1, 50, 50, 6, 2, 32, False),     # bidirectional, g = 3
        _bwd_case(2, 37, 37, 4, 4, 24, True, 16),  # MLA, DeepSeek's smoke widths
        _bwd_case(1, 20, 20, 2, 2, 192, True, 128),   # MLA, DeepSeek-V2-Lite's
    ],
)
def test_attention_bwd_ref_matches_jax_vjp(B, Sq, Sk, H, K, hd, causal, hd_v):
    rng = np.random.default_rng(8)
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, K, hd_v)).astype(np.float32)
    do = rng.normal(size=(B, Sq, H, hd_v)).astype(np.float32)
    o, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    lse = R.attention_lse_ref(tq, tk, causal=causal)
    dq, dk, dv = R.attention_bwd_ref(tq, tk, tv, torch.from_numpy(np.array(o)), lse,
                                     torch.from_numpy(do), causal=causal)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BWD_TOL, rtol=BWD_TOL)


def _scan_inputs(rng, B, T, D, N, with_h0, with_dhT):
    """Seeded float32 inputs of the selective scan in the JAX package's test
    ranges, its output gradients, and h0 / dh_T where asked."""
    x = rng.normal(size=(B, T, D)) * 0.5
    dt = np.abs(rng.normal(size=(B, T, D))) * 0.1
    A = -(np.abs(rng.normal(size=(D, N))) + 0.1)
    Bm, Cm = rng.normal(size=(B, T, N)) * 0.3, rng.normal(size=(B, T, N)) * 0.3
    Dk = rng.normal(size=(D,))
    h0 = rng.normal(size=(B, D, N)) * 0.2 if with_h0 else None
    dy = rng.normal(size=(B, T, D))
    dhT = rng.normal(size=(B, D, N)) * 0.5 if with_dhT else None
    f32 = (lambda a: None if a is None else np.asarray(a, np.float32))
    return tuple(map(f32, (x, dt, A, Bm, Cm, Dk, h0, dy, dhT)))


@pytest.mark.parametrize("B,T,D,N,with_h0,with_dhT", [
    (2, 13, 16, 8, False, False),    # the smoke config's N, h0 none
    (1, 37, 20, 16, True, True),     # Jamba's N, ragged D, h0 and dh_T given
    (3, 70, 12, 16, True, False),    # more than one checkpoint
    (2, 9, 7, 8, False, True),
])
def test_ssm_scan_bwd_ref_matches_jax_vjp(B, T, D, N, with_h0, with_dhT):
    """Every cotangent of the scan (x, dt, A, B, C, D and h0) against
    ``jax.vjp`` of the JAX package's oracle, from dy and dh_T (zeros when
    not given)."""
    x, dt, A, Bm, Cm, Dk, h0, dy, dhT = _scan_inputs(np.random.default_rng(9), B, T, D, N,
                                                     with_h0, with_dhT)
    args = [x, dt, A, Bm, Cm, Dk] + ([h0] if with_h0 else [])
    (_, _), vjp = jax.vjp(lambda *a: jref.ssm_scan_ref(*a), *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dy), jnp.zeros((B, D, N), jnp.float32) if dhT is None
                else jnp.asarray(dhT)))
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = R.ssm_scan_bwd_ref(*map(t, (x, dt, A, Bm, Cm, Dk)), t(dy), h0=t(h0), dhT=t(dhT))
    assert (got[-1] is None) is (not with_h0)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD", "dh0"), got, want):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=BWD_TOL * scale, rtol=BWD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ops_ssm_scan_under_grad_gives_jax_gradients(with_h0):
    """On the CPU ``ops.ssm_scan`` with grad needed differentiates the plain
    version (autograd), as JAX differentiates its oracle: every input's
    gradient of a loss on y and h_T against ``jax.grad``."""
    from repro_torch.kernels import ops

    x, dt, A, Bm, Cm, Dk, h0, dy, dhT = _scan_inputs(np.random.default_rng(10), 2, 21, 12, 8,
                                                     with_h0, True)
    args = [x, dt, A, Bm, Cm, Dk] + ([h0] if with_h0 else [])

    def jloss(*a):
        y, h = jref.ssm_scan_ref(*a)
        return jnp.sum(y * dy) + jnp.sum(h * dhT)

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = ops.ssm_scan(*leaves[:6], h0=leaves[6] if with_h0 else None)
    assert type(y.grad_fn).__name__ != "_SSMScanBackward"
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dhT)).sum(),
                              leaves)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=BWD_TOL * max(1.0, float(np.abs(w).max())),
                                   rtol=BWD_TOL)
