"""The port's trainer against the JAX package's, on the CPU.

On the CPU the port's flash attention and RMSNorm calls run their plain
versions, and autograd differentiates them, as ``jax.value_and_grad``
differentiates the JAX package's jnp oracles (its Pallas kernels have no
reverse mode).  On bridged float32 weights and the same numpy batch, for
each of the 10 smoke configs:

- ``lm_loss`` and every parameter leaf's gradient against
  ``jax.value_and_grad(lm_loss)``; a leaf the loss does not use gets no
  gradient in the port exactly where JAX's gradient is all zeros;
- one ``build_train_step`` step: loss, ``grad_norm``, ``lr`` and the new
  parameters;

and the launcher ``repro_torch.launch.train``: JAX's batches for a seed,
a run that exits 0 with a falling loss, and a resume from its checkpoint
that reproduces the uninterrupted losses.  The backward kernels are held
on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.distributed.optimizer import OptConfig as JaxOptConfig
from repro.distributed.optimizer import init_opt_state as jax_init_opt_state
from repro.launch.train import synthetic_batch as jax_synthetic_batch
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.models.zoo import build_train_step as jax_build_train_step
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.optimizer import OptConfig, init_opt_state, tree_leaves
from repro_torch.launch import train as train_mod
from repro_torch.models import init_params, lm_loss
from repro_torch.models.zoo import (
    build_decode_step,
    build_forward,
    build_prefill_step,
    build_train_step,
    loss_and_grads,
)

# the float32 loss of the smoke models: summation order only
LOSS_TOL = 1e-5
# a gradient leaf against JAX's, relative to the leaf's largest magnitude:
# summation order through 2-8 layers (largest seen ~1e-5, xLSTM's cells)
GRAD_TOL = 1e-4
# one AdamW step: at step 1 m/(sqrt(v)+eps) is ~sign(g), so a gradient that
# is ~0 in both frameworks may take opposite signs and move its parameter
# by up to 2 lr_1 apart; every other entry agrees to PARAM_TOL
PARAM_TOL = 1e-5
OPT = dict(lr=1e-3, warmup_steps=5)
B, S = 2, 12


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


_CASES = {}


def _case(arch):
    """Bridged float32 weights, a seeded batch (and ``enc_input``), and JAX's
    loss and gradients: computed once per config for the tests below."""
    if arch in _CASES:
        return _CASES[arch]
    jcfg = jax_smoke_config(arch).with_(dtype="float32")
    cfg = get_smoke_config(arch).with_(dtype="float32")
    # the port's seeded draw, bridged into JAX: the same weights in every
    # process.  JAX's own draw folds in hash(name), so it changed with each
    # process's hash seed, and so did the Kimi step's router check: an
    # expert that no token of the batch chooses has a router column whose
    # gradient is rounding noise around an exact zero in both frameworks,
    # which AdamW's first step turns into moves of up to lr of either sign
    pnp = params_to_numpy(init_params(cfg, 0, "cpu"))
    params = jax.tree.map(jnp.asarray, pnp)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    tgts = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    enc = None
    if jcfg.family in ("vlm", "audio"):
        enc = (0.1 * rng.normal(size=(B, jcfg.encoder.n_ctx, jcfg.d_model))).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    tbatch = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgts)}
    if enc is not None:
        jbatch["enc_input"] = jnp.asarray(enc)
        tbatch["enc_input"] = torch.from_numpy(enc)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, jcfg, jbatch["tokens"], jbatch["targets"],
                              enc_input=jbatch.get("enc_input"))))(params)
    case = dict(jcfg=jcfg, cfg=cfg, params=params, pnp=pnp, jbatch=jbatch, tbatch=tbatch,
                loss=float(loss), grads=dict(_flat(jax.tree.map(np.asarray, grads))))
    _CASES[arch] = case
    return case


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_loss_and_every_leaf_gradient_match_jax(arch):
    c = _case(arch)
    tp = params_from_numpy(c["pnp"], "cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    b = c["tbatch"]
    loss = lm_loss(tp, c["cfg"], b["tokens"], b["targets"], enc_input=b.get("enc_input"))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss.detach()), c["loss"], rtol=LOSS_TOL)
    loss.backward()
    got = dict(_flat(tp))
    assert got.keys() == c["grads"].keys()
    for name, leaf in got.items():
        want = c["grads"][name]
        if leaf.grad is None:   # unused in the port: JAX's gradient must be zeros
            assert not want.any(), f"{arch}{name}: no gradient, JAX's is non-zero"
            continue
        assert leaf.grad.shape == leaf.shape, name
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(_np(leaf.grad) - want).max())
        assert err <= GRAD_TOL * scale, f"{arch}{name}: {err} against {scale}"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_jax(arch):
    c = _case(arch)
    jopt = JaxOptConfig(**OPT)
    jstep = jax.jit(jax_build_train_step(c["jcfg"], jopt))
    jp, _, jm = jstep(c["params"], jax_init_opt_state(c["params"], jopt), c["jbatch"])
    tp = params_from_numpy(c["pnp"], "cpu")
    opt = OptConfig(**OPT)
    tp2, ts, tm = build_train_step(c["cfg"], opt)(tp, init_opt_state(tp, opt), c["tbatch"])
    assert tp2 is tp and int(ts["step"]) == 1     # updated in place, as JAX donates
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    lr1 = float(jm["lr"])
    for (name, want), (_, got) in zip(_flat(jax.tree.map(np.asarray, jp)), _flat(tp)):
        d = np.abs(_np(got) - want)
        assert d.max() <= 2 * lr1 + PARAM_TOL, f"{arch}{name}: {d.max()}"
        assert (d > PARAM_TOL).mean() < 0.01, f"{arch}{name}: {(d > PARAM_TOL).mean()}"


@pytest.mark.parametrize("threads", [2, 3, 8])
@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "jamba_1_5_large_398b"])
def test_moe_gradient_is_bit_equal_at_any_thread_count(arch, threads):
    """The one-device MoE gradient (routing, the routed sum's
    ``index_put_`` and its backward, the shared expert) does not depend on
    the intra-op thread count: every leaf bit-equal to the one-thread run."""
    c = _case(arch)
    before = torch.get_num_threads()
    grads = []
    try:
        for n in (1, threads):
            torch.set_num_threads(n)
            _, g = loss_and_grads(params_from_numpy(c["pnp"], "cpu"), c["cfg"], c["tbatch"])
            grads.append(dict(_flat(g)))
    finally:
        torch.set_num_threads(before)
    for name, g1 in grads[0].items():
        assert torch.equal(g1, grads[1][name]), name


def test_loss_and_grads_leaves_the_callers_tensors_alone():
    c = _case("stablelm_1_6b")
    tp = params_from_numpy(c["pnp"], "cpu")
    before = {k: v.clone() for k, v in _flat(tp)}
    loss, grads = loss_and_grads(tp, c["cfg"], c["tbatch"])
    assert not loss.requires_grad
    for name, leaf in _flat(tp):
        assert not leaf.requires_grad and leaf.grad is None
        assert torch.equal(leaf, before[name])
    assert dict(_flat(grads)).keys() == before.keys()


def test_serving_step_builders_match_the_model_functions():
    c = _case("stablelm_1_6b")
    tp = params_from_numpy(c["pnp"], "cpu")
    toks = c["tbatch"]["tokens"]
    with torch.no_grad():
        logits = build_forward(c["cfg"])(tp, {"tokens": toks})
        last, cache = build_prefill_step(c["cfg"])(tp, {"tokens": toks})
        assert torch.allclose(last, logits[:, -1], atol=1e-5)
        nxt, cache = build_decode_step(c["cfg"])(tp, {"cache": cache,
                                                       "tokens": last.argmax(-1)})
    assert nxt.shape == (B, c["cfg"].vocab) and int(cache["lengths"][0]) == S + 1


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["stablelm_1_6b", "whisper_tiny", "llama3_2_vision_90b"])
def test_synthetic_batch_gives_jax_batches(arch):
    cfg = get_smoke_config(arch)
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        jb = jax_synthetic_batch(jrng, jax_smoke_config(arch), 4, 16)
        tb = train_mod.synthetic_batch(trng, cfg, 4, 16)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert tb[k].dtype == (torch.int32 if k != "enc_input" else cfg.tdtype)
            np.testing.assert_array_equal(_np(tb[k]), np.asarray(jb[k], np.float32))


def _run(argv):
    report = {}
    rc = train_mod.main(argv, report=report)
    return rc, report


def test_launcher_trains_on_the_cpu_and_resumes_as_if_uninterrupted(capsys):
    base = ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu", "--batch", "4",
            "--seq", "32"]
    rc, run = _run(base + ["--steps", "8"])
    assert rc == 0 and len(run["losses"]) == 8 and run["losses"][-1] < run["losses"][0]
    out = capsys.readouterr().out
    assert "[train] step=   1 loss=" in out and "[train] 8 steps in" in out
    base += ["--opt-state", "int8"]
    _, full = _run(base + ["--steps", "8"])
    with tempfile.TemporaryDirectory() as d:
        _run(base + ["--steps", "5", "--ckpt-dir", d, "--ckpt-every", "5"])
        rc, resumed = _run(base + ["--steps", "8", "--ckpt-dir", d, "--ckpt-every", "5"])
        assert "[train] resumed from step 5" in capsys.readouterr().out
    assert resumed["start"] == 5 and len(resumed["losses"]) == 3
    # the same weights, state and batches: the CPU's math is deterministic
    assert resumed["losses"] == full["losses"][5:]


def test_launcher_resumed_at_its_last_step_takes_no_step_and_returns_1(capsys):
    """Resumed at ``--steps`` there is nothing to do: no step, return code 1
    (the JAX launcher raises IndexError there)."""
    base = ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16"]
    with tempfile.TemporaryDirectory() as d:
        ck = ["--steps", "2", "--ckpt-dir", d, "--ckpt-every", "2"]
        assert _run(base + ck)[0] in (0, 1)
        capsys.readouterr()
        rc, run = _run(base + ck)
    out = capsys.readouterr().out
    assert rc == 1 and run["start"] == 2 and run["losses"] == []
    assert "nothing to do: resumed at step 2 of 2" in out and "step=" not in out


def test_launcher_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--smoke", "--steps", "1"])
