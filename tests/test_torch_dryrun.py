"""The port's dry run and roofline model against the JAX package's.

- ``analytic_flops`` / ``analytic_bytes`` / ``analytic_terms`` equal to
  ``repro.launch.roofline_model``'s to the bit, for the ten published and
  the ten smoke configs at the four shapes, with the same explicit peaks;
- ``roofline_profile`` equal to JAX's to the bit at explicit arguments,
  its default memory rate the H100's;
- ``input_specs``, ``param_shapes[0]`` and ``opt_state_shapes`` (float32
  and int8 state) with the leaf paths and shapes of JAX's ``eval_shape``
  trees, dtypes through the stated map, every leaf on ``meta``;
- ``analytic_arg_bytes_per_dev`` equal to JAX's ``_tree_bytes_per_dev``
  for every applicable cell on (16, 16) and (2, 16, 16): JAX's side runs
  its own ``lower_cell`` in one subprocess (``repro/launch/dryrun.py``
  sets ``XLA_FLAGS`` at import), with ``jax.jit`` lowering nothing and
  ``NamedSharding`` a record of its spec over a ``FakeMesh``;
- ``--list`` printing JAX's cells and skips;
- the port's cells traced in one subprocess (``tests/torch_dryrun_worker.py``,
  ``OMP_NUM_THREADS=1``): collectives of known sizes, one of them run by
  DTensor inside an op's dispatch, a smoke cell on (1, 1) moving nothing,
  stablelm-1.6b's decode_32k on (2, 2) extrapolated equal to its whole
  24-layer trace (in process and in two worker processes), a layer of its
  decode and prefill adding collectives, xLSTM smoke's sequence probes
  equal to a trace at 48 tokens, llama3-405b's decode_32k on 16 × 16 at
  a resident size far below its weights, and DeepSeek-V2-Lite's and
  xLSTM-350M's cells.
"""

import pytest

torch = pytest.importorskip("torch")

import io
import json
import os
import subprocess
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jax_configs
from repro.core import calibration as jcal
from repro.distributed.optimizer import OptConfig as JOptConfig
from repro.launch import roofline_model as JRM
from repro.models import zoo as jzoo
from repro_torch import configs
from repro_torch.core import calibration as cal
from repro_torch.core import roofline_profile
from repro_torch.distributed.optimizer import OptConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline_model as RM
from repro_torch.models import zoo
from repro_torch.models.config import SHAPES

REPO = Path(__file__).resolve().parents[1]
# explicit peaks, given to both packages alike (no device's figures)
PEAK, BW = 1.0e15, 2.0e12
DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.int8): torch.int8}
MESHES = ((16, 16), (2, 16, 16))


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu")


# ---------------------------------------------------------------------------
# the analytic terms and roofline_profile
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_analytic_terms_equal_jax_bit_for_bit(arch, shape_name):
    for get, jget in ((configs.get_config, jax_configs.get_config),
                      (configs.get_smoke_config, jax_configs.get_smoke_config)):
        cfg, jcfg = get(arch), jget(arch)
        shape, jshape = SHAPES[shape_name], jax_configs.SHAPES[shape_name]
        assert RM.analytic_flops(cfg, shape) == JRM.analytic_flops(jcfg, jshape)
        assert RM.analytic_bytes(cfg, shape) == JRM.analytic_bytes(jcfg, jshape)
        assert (RM.analytic_bytes(cfg, shape, opt_state_bytes_per_param=4.0)
                == JRM.analytic_bytes(jcfg, jshape, opt_state_bytes_per_param=4.0))
        for n in (1, 256, 512):
            assert (RM.analytic_terms(cfg, shape, n, PEAK, BW)
                    == JRM.analytic_terms(jcfg, jshape, n, PEAK, BW))


@pytest.mark.parametrize("args", [(3.2e9, 1.5e6, 2.0e12, 64, 3e-5), (8.1e11, 4.0e8, 1.0e12, 256, 0.0)])
def test_roofline_profile_equals_jax_bit_for_bit(args):
    got, want = roofline_profile(*args), jcal.roofline_profile(*args)
    assert np.array_equal(got.batch_sizes, want.batch_sizes)
    assert np.array_equal(got.latency, want.latency)
    for b in (1, 7, 40, 1000):
        assert got.l(b) == want.l(b)


def test_roofline_profile_defaults_to_the_h100_and_needs_an_overhead():
    assert cal.H100_HBM_BW == 3.35e12 == D.HBM_BW
    got = roofline_profile(3.2e9, 1.5e6, step_overhead_s=1e-4)
    want = jcal.roofline_profile(3.2e9, 1.5e6, 3.35e12, 256, 1e-4)
    assert np.array_equal(got.latency, want.latency)
    with pytest.raises(ValueError, match="step_overhead_s"):
        roofline_profile(3.2e9, 1.5e6)


def test_roofline_terms_use_the_h100_constants():
    t = D.roofline_terms(1e18, 1e15, 9e9, 256)
    assert t == {"compute_s": 1e18 / (256 * 989e12), "memory_s": 1e15 / (256 * 3.35e12),
                 "collective_s": 9e9 / 450e9}


# ---------------------------------------------------------------------------
# the shape trees
# ---------------------------------------------------------------------------
def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", getattr(k, "name", None)))
                    for k in path)
        out[key] = (tuple(leaf.shape), DTYPES[jnp.dtype(leaf.dtype)])
    return out


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (k,))
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _port_leaves(getattr(tree, f), path + (f,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (i,))
    else:
        yield path, tree


def _same_tree(got, want) -> None:
    leaves = dict(_port_leaves(got))
    assert all(t.device.type == "meta" for t in leaves.values())
    assert {k: (tuple(t.shape), t.dtype) for k, t in leaves.items()} == _jax_leaves(want)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_shape_trees_match_jax_eval_shape(arch):
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    p_shapes, p_specs = zoo.param_shapes(cfg)
    jp_shapes, jp_specs = jzoo.param_shapes(jcfg)
    _same_tree(p_shapes, jp_shapes)
    assert p_specs == zoo.param_specs(cfg)
    for state in ("float32", "int8"):
        _same_tree(zoo.opt_state_shapes(cfg, OptConfig(state_dtype=state), p_shapes),
                   jzoo.opt_state_shapes(jcfg, JOptConfig(state_dtype=state), jp_shapes))
    for name in SHAPES:
        _same_tree(zoo.input_specs(cfg, SHAPES[name]),
                   jzoo.input_specs(jcfg, jax_configs.SHAPES[name]))


# ---------------------------------------------------------------------------
# argument bytes and --list against JAX's own code
# ---------------------------------------------------------------------------
JAX_SIDE = """
import io, json, contextlib
import jax
from repro.launch import dryrun as D
from repro.distributed import sharding as S
from repro.configs import ARCH_IDS, SHAPES, get_config, shape_applicable


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class Sharding:
    def __init__(self, mesh, spec):
        self.spec = spec


class Jit:
    def __init__(self, fn, **kw):
        pass

    def lower(self, *args):
        return None


class Jax:
    jit = Jit

    def __getattr__(self, name):
        return getattr(jax, name)


D.jax, D.NamedSharding, S.NamedSharding = Jax(), Sharding, Sharding
out = {}
for ms in MESHES:
    names = ("pod", "data", "model")[-len(ms):]
    mesh = FakeMesh(dict(zip(names, ms)))
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            if shape_applicable(cfg, shape)[0]:
                _, aux = D.lower_cell(cfg, shape, mesh, opt_state_dtype="int8")
                out["|".join((arch, sname, "x".join(map(str, ms))))] = aux["arg_bytes_per_dev"]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    D.main(["--list"])
print(json.dumps({"arg_bytes": out, "list": buf.getvalue()}))
"""


@pytest.fixture(scope="module")
def jax_side():
    proc = subprocess.run([sys.executable, "-c", f"MESHES = {MESHES!r}\n" + JAX_SIDE],
                          env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_arg_bytes_per_dev_equal_jax(jax_side, mesh_shape):
    tag = "x".join(map(str, mesh_shape))
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model")[-len(mesh_shape):],
                                 shape=mesh_shape)
    want = {k: v for k, v in jax_side["arg_bytes"].items() if k.endswith("|" + tag)}
    assert len(want) == 32
    got = {}
    for key in want:
        arch, sname, _ = key.split("|")
        got[key] = D.cell_arg_bytes(configs.get_config(arch), SHAPES[sname], mesh)
    assert got == want


def test_list_prints_jax_cells_and_skips(jax_side):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert D.main(["--list"]) == 0
    assert buf.getvalue() == jax_side["list"]
    assert sum(ok for *_, ok, _ in D.iter_cells()) == 32


def test_scan_at_once_equals_the_plain_scan():
    from repro_torch.kernels.ref import ssm_scan_ref

    rng = np.random.default_rng(0)
    B, T, Dd, N = 2, 9, 5, 3

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale)

    x, dt, A = t(B, T, Dd), t(B, T, Dd).abs() * 0.1, -t(Dd, N).abs()
    Bm, Cm, Dv, h0 = t(B, T, N), t(B, T, N), t(Dd), t(B, Dd, N)
    for h in (None, h0):
        y, hT = D._scan_at_once(x, dt, A, Bm, Cm, Dv, h0=h)
        y_ref, hT_ref = ssm_scan_ref(x, dt, A, Bm, Cm, Dv, h0=h)
        torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(hT, hT_ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the port's traced cells (one subprocess)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cells():
    proc = subprocess.run([sys.executable, str(REPO / "tests" / "torch_dryrun_worker.py")],
                          env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_collectives_of_known_sizes(cells):
    k = cells["known"]
    # (64, 32) float32 on (2, 2), rows and columns sharded: gathering the
    # rows gives each rank (64, 16)
    assert k["gather"]["all-gather"] == 64 * 16 * 4 and k["gather"]["count"] == 1
    assert k["alltoall"]["all-to-all"] > 0
    assert k["inplace"] == {"all-gather": 0, "all-reduce": 8 * 4 * 4, "reduce-scatter": 0,
                            "all-to-all": 0, "collective-permute": 0, "count": 1}


def test_collectives_dtensor_runs_inside_an_op_are_counted(cells):
    """``relu(a @ w + r)`` with ``a``'s columns and ``w``'s rows over
    ``model`` (2): the product is ``Partial``, and DTensor all-reduces
    the (64, 32) float32 sum inside ``relu``'s dispatch."""
    assert cells["known"]["implicit"] == {"all-gather": 0, "all-reduce": 64 * 32 * 4,
                                          "reduce-scatter": 0, "all-to-all": 0,
                                          "collective-permute": 0, "count": 1}


def test_a_sharded_layer_moves_bytes(cells):
    """stablelm-1.6b on (2, 2): one more layer adds collectives in decode
    and in prefill, the row-parallel products' all-reduce among them."""
    for name in ("extrapolated", "prefill"):
        per = cells[name]["per_superblock"]
        assert per["count"] > 0 and per["all-reduce"] > 0, (name, per)


def test_a_process_with_a_group_refuses_a_second(cells):
    assert cells["known"]["second_group_raised"] and not cells["group_left"]


def test_smoke_cell_on_one_rank_moves_nothing(cells):
    r = cells["smoke_1x1"]
    assert r["collective_bytes"] == 0 and r["collectives"]["count"] == 0
    assert r["device"] == "fake" and r["n_chips"] == 1 and r["traced_flops"] > 0


def test_extrapolated_costs_equal_the_whole_trace(cells):
    ext, full = cells["extrapolated"], cells["full"]
    assert ext["extrapolated"] and ext["probes"] == [[2, 32768], [3, 32768]]
    assert ext["coll_by_kind"] == full["coll_by_kind"] and ext["coll"] == full["coll"]
    assert ext["flops"] == full["flops"]
    assert full["coll"] > 0


def test_probes_in_worker_processes_equal_the_probes_in_process(cells):
    assert cells["pooled"] == cells["extrapolated"]


def test_sequence_probes_equal_the_whole_trace(cells):
    """xLSTM's per-token loops: the probes at 16 and 32 tokens,
    extrapolated to 48, against a trace at 48."""
    ext, whole = cells["xlstm_seq"], cells["xlstm_48"]
    assert ext["extrapolated"] and [s for _, s in ext["probes"]] == [16, 32]
    assert ext["coll_by_kind"] == whole["coll_by_kind"] and ext["flops"] == whole["flops"]
    assert whole["coll_by_kind"]["count"] > 0


def test_llama3_405b_decode_traces_far_below_its_weights(cells):
    r = cells["llama3_405b"]
    assert r["mesh"] == "16x16" and r["n_chips"] == 256 and r["collective_bytes"] > 0
    assert r["memory"]["analytic_arg_bytes_per_dev"] > 0
    # 810 GB of bf16 weights; the trace holds shapes only
    assert cells["llama3_405b_rss_gib"] < 8


@pytest.mark.parametrize("name", ["llama3_405b", "deepseek", "xlstm"])
def test_cell_records_carry_the_keys(cells, name):
    r = cells[name]
    keys = {"arch", "shape", "variant", "mesh", "n_chips", "kind", "device", "lower_s",
            "extrapolated", "probes", "memory", "analytic_flops", "analytic_bytes",
            "traced_flops", "collectives", "collectives_per_superblock", "collective_bytes",
            "model_flops", "roofline", "useful_flops_ratio"}
    assert keys <= set(r) and not any(k.startswith("xla") for k in r)
    assert set(r["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert all(v >= 0 for v in r["roofline"].values())
    wire = sum(2 * v if k == "all-reduce" else v
               for k, v in r["collectives"].items() if k != "count")
    assert r["collective_bytes"] == wire


def test_moe_cell_moves_its_experts_rows(cells):
    r = cells["deepseek"]
    assert r["collectives"]["all-to-all"] > 0 and r["extrapolated"]
