"""The port's logical sharding rules and int8 gradient compression against JAX's.

One process, no ranks (the multi-rank paths are in
``tests/test_torch_multirank.py``):

- ``resolve_spec`` equal to JAX's for every parameter leaf of all ten
  configs, published and smoke, with its dim sizes, on (16, 16), (4, 2),
  (2, 2) and (2, 16, 16) with a ``pod`` dim (JAX's ``FakeMesh``: an object
  whose ``shape`` maps dim names to sizes);
- the port's parameter spec tree equal to JAX's ``param_shapes(cfg)[1]``;
- ``input_logical`` and ``cache_logical`` equal to JAX's;
- the placements of a spec, and ``constrain`` a no-op without a mesh or
  on a plain tensor;
- ``quantize_rowwise``, ``dequantize_rowwise`` and ``compress_decompress``
  bit-equal to JAX's on seeded numpy inputs, error feedback telescoping,
  and ``compressed_grad_allreduce`` returning the gradients where JAX's
  does.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jax_configs
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jshd
from repro.models import transformer as JT
from repro.models import zoo as jzoo
from repro.models.config import SHAPES as JAX_SHAPES
from repro_torch import configs
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as T
from repro_torch.models import zoo
from repro_torch.models.config import SHAPES

MESHES = ({"data": 16, "model": 16}, {"data": 4, "model": 2}, {"data": 2, "model": 2},
          {"pod": 2, "data": 16, "model": 16})
CASES = [(arch, smoke) for arch in configs.ARCH_IDS for smoke in (True, False)]


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


class NamedMesh:
    """What ``placements_of`` reads of a DeviceMesh: its dim names."""

    def __init__(self, *names):
        self.mesh_dim_names = names
        self.ndim = len(names)


def _cfgs(arch: str, smoke: bool):
    if smoke:
        return jax_configs.get_smoke_config(arch), configs.get_smoke_config(arch)
    return jax_configs.get_config(arch), configs.get_config(arch)


def _leaves(spec_tree, shape_tree, path=()):
    if isinstance(spec_tree, dict):
        for k in spec_tree:
            yield from _leaves(spec_tree[k], shape_tree[k], path + (k,))
    else:
        yield path, spec_tree, tuple(shape_tree.shape)


@pytest.mark.parametrize("arch,smoke", CASES)
def test_param_spec_tree_equals_jax(arch, smoke):
    jcfg, tcfg = _cfgs(arch, smoke)
    assert zoo.param_specs(tcfg) == jzoo.param_shapes(jcfg)[1]


@pytest.mark.parametrize("arch,smoke", CASES)
def test_resolve_spec_equals_jax_for_every_leaf(arch, smoke):
    jcfg, tcfg = _cfgs(arch, smoke)
    shapes, specs = jzoo.param_shapes(jcfg)
    leaves = list(_leaves(specs, shapes))
    assert len(leaves) > 5
    for mshape in MESHES:
        fake = FakeMesh(mshape)
        for path, logical, dims in leaves:
            want = tuple(jshd.resolve_spec(logical, dims, mesh=fake, rules=jshd.DEFAULT_RULES))
            got = shd.resolve_spec(logical, dims, mesh=fake, rules=shd.DEFAULT_RULES)
            # JAX's P drops trailing Nones in no version the port relies on
            assert got[:len(want)] == want and all(a is None for a in got[len(want):]), \
                (path, mshape)
            # without dim sizes: the first candidate present in the mesh
            want = tuple(jshd.resolve_spec(logical, None, mesh=fake, rules=jshd.DEFAULT_RULES))
            assert shd.resolve_spec(logical, None, mesh=fake)[:len(want)] == want


def test_resolve_spec_rules_and_fallbacks():
    fake = FakeMesh({"data": 16, "model": 16})
    spec = shd.resolve_spec(("batch", "kv_seq", "kv_heads", None), (128, 4096, 8, 128),
                            mesh=fake)
    # kv_seq grabs model; kv_heads (8 % 16 != 0) falls back to replicated
    assert spec == ("data", "model", None, None)
    used = [s for s in shd.resolve_spec(("ff", "ff"), (64, 64), mesh=fake) if s is not None]
    assert len(used) == len(set(used)) <= 1
    assert shd.resolve_spec(("batch",), (64,), mesh=FakeMesh(MESHES[3])) == (("pod", "data"),)
    assert shd.resolve_spec(("batch", None)) == ()
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES


@pytest.mark.parametrize("arch,smoke", CASES)
def test_input_and_cache_logical_equal_jax(arch, smoke):
    jcfg, tcfg = _cfgs(arch, smoke)
    for name, shape in SHAPES.items():
        assert zoo.input_logical(tcfg, shape) == jzoo.input_logical(jcfg, JAX_SHAPES[name])
    dtypes = ("bfloat16",) if tcfg.family == "audio" else ("bfloat16", "int8")
    for kv in dtypes:
        jc, tc = jcfg.with_(kv_cache_dtype=kv), tcfg.with_(kv_cache_dtype=kv)
        jcache = jax.eval_shape(lambda: JT.init_cache(jc, 2, 16))
        tcache = T.init_cache(tc, 2, 16, device="meta")
        for model in (1, 2, 16):
            assert zoo.cache_logical(tc, tcache, model) == jzoo.cache_logical(jc, jcache, model)


def test_placements_and_named_sharding():
    from torch.distributed.tensor import Replicate, Shard

    m = NamedMesh("pod", "data", "model")
    assert shd.placements_of(("data", None, "model"), m) == (Replicate(), Shard(0), Shard(2))
    assert shd.placements_of((("pod", "data"), None), m) == (Shard(0), Shard(0), Replicate())
    assert shd.placements_of((), m) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        shd.placements_of((("data", "pod"),), m)
    assert shd.named_sharding(("batch",), (8,)) is None
    mesh, placements = shd.NamedSharding(m, (Replicate(),) * 3)
    assert mesh is m and len(placements) == 3


def test_constrain_noop_without_mesh_or_on_plain_tensor():
    x = torch.arange(16.0).reshape(4, 4)
    assert shd.constrain(x, ("batch", None)) is x
    with shd.use_mesh(FakeMesh({"data": 2, "model": 2})):
        assert shd.active_mesh() is not None
        assert shd.constrain(x, ("batch", None)) is x
    assert shd.active_mesh() is None
    assert tmesh.make_host_mesh() is None  # below two ranks, as JAX's


def _rows(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(32, 64)).astype(np.float32)
    x[3] = 0.0                      # an all-zero row: the 1e-12 floor
    x[5, :8] = 127.5 * x[5].max()   # large entries, ties at .5 after scaling
    return [x, rng.normal(size=(3, 5, 17)).astype(np.float32),
            rng.normal(size=(7,)).astype(np.float32), np.float32(rng.normal())]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantizer_bit_equal_to_jax(seed):
    for x in _rows(seed):
        jq, js = jcomp.quantize_rowwise(jnp.asarray(x))
        tq, ts = comp.quantize_rowwise(torch.as_tensor(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(comp.dequantize_rowwise(tq, ts).numpy(),
                                      np.asarray(jcomp.dequantize_rowwise(jq, js)))
        resid = np.random.default_rng(seed + 10).normal(size=np.shape(x)).astype(np.float32)
        for r in (None, resid):
            jx, jr = jcomp.compress_decompress(jnp.asarray(x),
                                               None if r is None else jnp.asarray(r))
            tx, tr = comp.compress_decompress(torch.as_tensor(x),
                                              None if r is None else torch.as_tensor(r))
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_error_feedback_telescopes():
    """With error feedback the cumulative transmitted signal converges to
    the cumulative true signal (the bias telescopes away)."""
    rng = np.random.default_rng(2)
    g_true = torch.as_tensor(rng.normal(size=(16, 32)).astype(np.float32)) * 1e-3
    resid = None
    sent_total = torch.zeros_like(g_true)
    for _ in range(50):
        sent, resid = comp.compress_decompress(g_true, resid)
        sent_total = sent_total + sent
    np.testing.assert_allclose((sent_total / 50).numpy(), g_true.numpy(),
                               atol=float(g_true.abs().max()) * 0.05)


def test_compressed_grad_allreduce_passes_through_where_jax_does():
    class Mesh1:
        mesh_dim_names = ("pod", "data")

        def size(self, i):
            return (1, 4)[i]

    g = {"w": torch.ones(4, 4)}
    assert comp.compressed_grad_allreduce(g, None) is g
    assert comp.compressed_grad_allreduce(g, Mesh1(), axis="model") is g
    assert comp.compressed_grad_allreduce(g, Mesh1(), axis="pod") is g


def test_nested_use_mesh_keeps_plain_tensors_replicated():
    """Plain tensors count as replicated for as long as any mesh is active:
    an inner ``use_mesh`` leaving does not end it for the outer one."""
    from torch.distributed.tensor import DTensor

    outer, inner = FakeMesh({"data": 2}), FakeMesh({"data": 1})
    def flag():
        return DTensor._op_dispatcher._allow_implicit_replication

    with shd.use_mesh(outer):
        assert flag()
        with shd.use_mesh(inner):
            assert shd.active_mesh() is inner and flag()
        with shd.use_mesh(None):
            assert shd.active_mesh() is None
            with shd.use_mesh(inner):
                assert shd.active_mesh() is inner and flag()
            assert shd.active_mesh() is None and flag()
        assert shd.active_mesh() is outer and flag()
    assert not flag()
