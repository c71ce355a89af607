"""The weight bridge between the JAX package and the port, and the port's
parameter tree against JAX's (keys, shapes, dtypes)."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import init_params

ARCHS = ["stablelm_1_6b", "internlm2_20b"]


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bit pattern of a tensor (exact comparison, NaN-proof)."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype]
    return t.view(view).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_jax_to_port_to_numpy_is_bit_exact(arch, dtype):
    cfg = jax_smoke_config(arch).with_(dtype=dtype)
    jp = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.key(3))[0])
    tp = params_from_numpy(jp, "cpu")
    back = params_to_numpy(tp)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    for (name, a), (_, t), (_, b) in zip(_leaves(jp), _leaves(tp), _leaves(back)):
        assert t.dtype == tdt and t.device.type == "cpu", name
        assert tuple(t.shape) == a.shape, name
        np.testing.assert_array_equal(b, a.astype(np.float32), err_msg=name)
    # and JAX reads the returned arrays back to the very same bits
    for (name, a), (_, b) in zip(_leaves(jp), _leaves(back)):
        again = np.asarray(jnp.asarray(b, cfg.jdtype))
        assert again.tobytes() == a.tobytes(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_round_trip_is_bit_exact(dtype):
    cfg = get_smoke_config("internlm2_20b").with_(dtype=dtype)
    tp = init_params(cfg, seed=5, device="cpu")
    again = params_from_numpy(params_to_numpy(tp), "cpu", dtype=cfg.tdtype)
    for (name, a), (_, b) in zip(_leaves(tp), _leaves(again)):
        assert a.dtype == b.dtype == cfg.tdtype, name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax_smoke(arch):
    cfg = jax_smoke_config(arch)
    jp = jax_init_params(cfg, jax.random.key(0))[0]
    tp = init_params(get_smoke_config(arch), seed=0, device="cpu")
    want = [(k, v.shape, str(v.dtype)) for k, v in _leaves(jp)]
    got = [(k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _leaves(tp)]
    assert got == want
    # the same init law: std = 1/sqrt(fan_in) (to a loose statistical bound)
    w = tp["blocks"]["0"]["mlp"]["w_down"].float()
    assert abs(w.std().item() * np.sqrt(cfg.d_ff) - 1.0) < 0.1


def test_init_params_tree_matches_jax_full_width():
    """The full stablelm-1.6b tree: JAX's shapes from ``jax.eval_shape``,
    the port's from the meta device — nothing is allocated on either."""
    jshapes = jax.eval_shape(
        lambda k: jax_init_params(jax_get_config("stablelm_1_6b"), k)[0],
        jax.random.key(0),
    )
    tp = init_params(get_config("stablelm_1_6b"), seed=0, device="meta")
    want = [(k, tuple(v.shape), str(v.dtype)) for k, v in _leaves(jshapes)]
    got = [(k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _leaves(tp)]
    assert got == want
    n_params = sum(int(np.prod(s)) for _, s, _ in got)
    assert 1.6e9 < n_params < 1.7e9


def test_seeded_init_is_reproducible():
    cfg = get_smoke_config("stablelm_1_6b")
    a = init_params(cfg, seed=7, device="cpu")
    b = init_params(cfg, seed=7, device="cpu")
    c = init_params(cfg, seed=8, device="cpu")
    for (name, x), (_, y), (_, z) in zip(_leaves(a), _leaves(b), _leaves(c)):
        assert torch.equal(x, y), name
    assert not torch.equal(a["embedding"], c["embedding"])
