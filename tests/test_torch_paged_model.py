"""The port's paged model path against the JAX package's, on bridged weights.

Both sides run float32 weights built by ``repro.models.init_params`` and
handed to the port through the bridge; inputs are numpy arrays from a
seed.  Logits of every prefill chunk and decode step, and the KV pools
they leave behind, must agree to ``ATOL``: float32 throughout, so the
only differences are the order of summation inside matrix products and
the softmax (the two frameworks' CPU kernels), far below 1e-4.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.models import paged as JP
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import paged as TP

ATOL = 1e-4


@pytest.fixture(scope="module", params=["stablelm_1_6b", "internlm2_20b"])
def setup(request):
    jcfg = jax_smoke_config(request.param).with_(dtype="float32")
    tcfg = get_smoke_config(request.param).with_(dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(1))[0]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _assert_pools_close(jpools, tpools):
    for j, pool in jpools["blocks"].items():
        for name, arr in pool.items():
            np.testing.assert_allclose(
                tpools["blocks"][j][name].numpy(), np.asarray(arr), atol=ATOL,
                err_msg=f"pool {j}/{name}",
            )


def test_prefill_chunks_then_decode_match_jax(setup):
    jcfg, tcfg, jparams, tparams = setup
    ps, P, npp = 8, 16, 6
    rng = np.random.default_rng(21)
    jpools = JP.init_paged_pools(jcfg, P, ps)
    tpools = TP.init_paged_pools(tcfg, P, ps, device="cpu")
    # request 0: a 21-token prompt in chunks of 8, 8, 5 (pages 3, 9, 4, 12)
    prompt = rng.integers(0, tcfg.vocab, size=21).astype(np.int32)
    bt0 = np.array([3, 9, 4, 12, 0, 0], np.int32)
    for past, C in [(0, 8), (8, 8), (16, 5)]:
        toks = prompt[None, past:past + C]
        jl, jpools = JP.paged_prefill_chunk(
            jparams, jcfg, jpools, jnp.asarray(toks), jnp.asarray(bt0), past
        )
        tl, tpools = TP.paged_prefill_chunk(
            tparams, tcfg, tpools, torch.from_numpy(toks),
            torch.from_numpy(bt0), past,
        )
        assert tl.shape == (1, C, tcfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_pools_close(jpools, tpools)

    # a decode bucket of 4: request 0 at length 21, request 1 at length 3
    # (pages 7), and two padding rows on the trash page with length 0
    bt = np.array([bt0, [7, 0, 0, 0, 0, 0], [0] * npp, [0] * npp], np.int32)
    lens = np.array([21, 3, 0, 0], np.int32)
    for _ in range(3):
        toks = rng.integers(0, tcfg.vocab, size=4).astype(np.int32)
        jl, jpools = JP.paged_decode_step(
            jparams, jcfg, jpools, jnp.asarray(toks), jnp.asarray(bt),
            jnp.asarray(lens),
        )
        tl, tpools = TP.paged_decode_step(
            tparams, tcfg, tpools, torch.from_numpy(toks), torch.from_numpy(bt),
            torch.from_numpy(lens),
        )
        assert tl.shape == (4, tcfg.vocab)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], atol=ATOL)
        lens[:2] += 1
    _assert_pools_close(jpools, tpools)


def test_pools_are_updated_in_place(setup):
    _, tcfg, _, tparams = setup
    tpools = TP.init_paged_pools(tcfg, 6, 4, device="cpu")
    k0 = tpools["blocks"]["0"]["k"]
    _, out = TP.paged_prefill_chunk(
        tparams, tcfg, tpools, torch.tensor([[5, 6, 7]], dtype=torch.int32),
        torch.tensor([2, 0], dtype=torch.int32), 0,
    )
    assert out is tpools and out["blocks"]["0"]["k"] is k0
    assert k0[:, 2, :3].abs().sum() > 0           # written where the table says
    assert k0[:, 2, 3:].abs().sum() == 0 and k0[:, :2].abs().sum() == 0


def test_int8_pools_match_jax_layout(setup):
    """int8 pools: int8 zero K/V beside float32 scale pools of ones, the
    JAX package's leaves, shapes and values."""
    jcfg, tcfg, _, _ = setup
    jpools = JP.init_paged_pools(jcfg, 5, 4, kv_dtype="int8")
    tpools = TP.init_paged_pools(tcfg, 5, 4, kv_dtype="int8", device="cpu")
    for j, pool in jpools["blocks"].items():
        assert set(tpools["blocks"][j]) == set(pool) == {"k", "v", "k_s", "v_s"}
        for name, arr in pool.items():
            got = tpools["blocks"][j][name]
            assert str(got.dtype).split(".")[-1] == str(arr.dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(arr))
    assert TP.supports_paged(tcfg)
