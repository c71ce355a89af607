"""The port's sharded and multi-rank paths on CPU ``gloo`` ranks.

One process a rank (``tests/torch_multirank_worker.py``), sharing one
``FileStore`` under ``tmp_path``, each with one thread; a job that hangs
fails the test at its time limit.  Two launches: eight ranks run every
check on (data 4, model 2) and (pod 2, data 2, model 2) meshes and write
a checkpoint of sharded weights, then four ranks restore it onto
(data 2, model 2).  The JAX references run in this process (one device)
and, for JAX's ``moe_ep``, in a subprocess with 8 forced host devices,
as ``tests/test_multidevice.py`` runs it, at the same time as the ranks.

Held in float32:

- ``moe_ep`` (``impl="ep"``) in each variant (plain, dedup dispatch, int8
  dispatch, ``shard_groups``) against JAX's ``moe_ep`` at a capacity that
  drops assignments and at one that drops none, and the plain and dedup
  variants against ``moe_dense`` at ``capacity_factor`` 2.0 (int8
  dispatch and group-limited routing compute another function); a
  decode-sized call takes the fallback on the local expert shards;
- ``mlp_ws_decode`` against ``mlp`` (the port's and JAX's);
- ``compressed_grad_allreduce`` over ``pod`` against numpy's ``sum(q_i) *
  mean(s_i)`` of each pod group's distinct inputs;
- the sharded ``prefill`` + greedy ``decode_step`` of internlm2's smoke
  config on JAX's weights against JAX's single-device logits (the JAX
  test's 2e-3; JAX's own sharded decode fails at its vocab-sharded
  gather), greedy tokens equal;
- the sharded decode of every smoke config against the unsharded port;
- the resharding restore, bit for bit;
- training on a mesh, on (data 4, model 2) in the first launch and on
  (data 2, model 2) in the second: every gradient leaf of
  ``loss_and_grads`` and one ``build_train_step`` step (loss,
  ``grad_norm``, gradients, updated params) of internlm2's, Jamba's and
  Kimi's smoke configs against the same calls without a mesh (internlm2
  also with int8 AdamW state, and its (4, 2) step against JAX's jitted
  step on one device), at ``tests/test_torch_train.py``'s tolerances;
- the gradients of the ``ops`` entry points on DTensors against the
  plain-tensor calls', and of ``moe_ep`` in each variant against
  ``jax.grad`` of JAX's ``moe_ep`` and, at a capacity that drops nothing,
  of ``moe_dense``.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jax_configs
from repro.distributed.compression import quantize_rowwise as jax_quantize_rowwise
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.distributed.optimizer import OptConfig as JaxOptConfig
from repro.distributed.optimizer import init_opt_state as jax_init_opt_state
from repro.launch.train import synthetic_batch as jax_synthetic_batch
from repro.models.layers import mlp as jax_mlp
from repro.models.zoo import build_train_step as jax_build_train_step
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import layers as TL

import torch_multirank_worker as W
from test_torch_train import GRAD_TOL, LOSS_TOL, PARAM_TOL

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(W.__file__).resolve()
LIMIT_S = 300
# float32 over a mesh: summation order only
TOL = 1e-4
# the JAX test's bound for a sharded decode against one device
DECODE_TOL = 2e-3
MOE_TOKENS = (8, 16)


def _launch(job: str, world: int, d: Path, store: Path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(WORKER), "--job", job, "--rank", str(r), "--world", str(world),
         "--dir", str(d), "--store", str(store), "--timeout-s", str(LIMIT_S - 30)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def _wait(procs, what: str) -> None:
    """Wait for every process within the time limit; kill them all and
    fail on a timeout or a nonzero exit."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LIMIT_S))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{what}: a process passed {LIMIT_S} s")
    bad = [(i, p.returncode, err[-3000:]) for i, (p, (_, err)) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, f"{what}: {bad[0]}"


JAX_MOE = """
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_smoke_config
    from repro.models import moe as M
    from repro.distributed.sharding import use_mesh

    d = sys.argv[1]
    z = dict(np.load(d + "/moe_in.npz"))
    x = jnp.asarray(z.pop("x"))
    z.pop("ct")
    p = {k: jnp.asarray(v) for k, v in z.items() if "/" not in k}
    p["shared"] = {k.split("/")[1]: jnp.asarray(v) for k, v in z.items() if "/" in k}
    base = get_smoke_config("kimi_k2_1t_a32b").with_(dtype="float32")
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    ct = jnp.asarray(np.load(d + "/moe_ct.npy"))

    def grads(fn):
        g = jax.jit(jax.grad(lambda p, x: jnp.sum(fn(p, x) * ct), argnums=(0, 1)))(p, x)
        flat = {"x": g[1], **{k: v for k, v in g[0].items() if k != "shared"}}
        flat.update({"shared/" + k: v for k, v in g[0]["shared"].items()})
        return {k: np.asarray(v) for k, v in flat.items()}

    out = {"dense": np.asarray(M.moe_dense(p, base, x))}
    for k, v in grads(lambda p, x: M.moe_dense(p, base, x)).items():
        out["grad/dense/" + k] = v
    for variant, fields in VARIANTS.items():
        for tag, cf in CAPACITIES.items():
            cfg = base.with_(moe=dataclasses.replace(base.moe, impl="ep", capacity_factor=cf,
                                                     **fields))
            with use_mesh(mesh):
                y = jax.jit(lambda p, x: M.moe_ep(p, cfg, x, mesh=mesh))(p, x)
                g = grads(lambda p, x: M.moe_ep(p, cfg, x, mesh=mesh))
            out[variant + "/" + tag] = np.asarray(y)
            for k, v in g.items():
                out["grad/" + variant + "/" + tag + "/" + k] = v
    np.savez(d + "/jax_moe.npz", **out)
"""


def _jax_moe(d: Path):
    code = (f"VARIANTS = {W.MOE_VARIANTS!r}\nCAPACITIES = {W.MOE_CAPACITIES!r}\n"
            + textwrap.dedent(JAX_MOE))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code, str(d)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _inputs(d: Path) -> dict:
    """Write the ranks' inputs; return the JAX references of this process."""
    rng = np.random.default_rng(0)
    cfg = jax_configs.get_smoke_config("kimi_k2_1t_a32b")
    dm, E, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    sf = cfg.moe.n_shared * f

    def w(*shape, fan_in):
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    ct = np.random.default_rng(1).normal(size=MOE_TOKENS + (dm,)).astype(np.float32)
    np.save(d / "moe_ct.npy", ct)
    np.savez(d / "moe_in.npz", x=(0.5 * rng.normal(size=MOE_TOKENS + (dm,))).astype(np.float32),
             ct=ct,
             router=w(dm, E, fan_in=dm), w_gate=w(E, dm, f, fan_in=E),
             w_up=w(E, dm, f, fan_in=E), w_down=w(E, f, dm, fan_in=E),
             **{"shared/w_gate": w(dm, sf, fan_in=dm), "shared/w_up": w(dm, sf, fan_in=dm),
                "shared/w_down": w(sf, dm, fan_in=sf)})
    ws_cfg = jax_configs.get_smoke_config("llama3_405b")
    dm = ws_cfg.d_model
    ws = {"x": rng.normal(size=(4, 1, dm)).astype(np.float32),
          "w_gate": w(dm, 192, fan_in=dm), "w_up": w(dm, 192, fan_in=dm),
          "w_down": w(192, dm, fan_in=192)}
    np.savez(d / "ws_in.npz", **ws)

    jcfg = jax_configs.get_smoke_config("internlm2_20b").with_(dtype="float32")
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0))[0])
    np.savez(d / "internlm2.npz", **W.flat(params))
    toks = (np.arange(4 * 8).reshape(4, 8) % jcfg.vocab).astype(np.int32)
    np.save(d / "internlm2_toks.npy", toks)
    last, cache = jax_prefill(params, jcfg, jnp.asarray(toks), max_len=32)
    logits = [np.asarray(last)]
    for _ in range(W.DECODE_STEPS):
        lg, cache = jax_decode_step(params, jcfg, cache, jnp.argmax(logits[-1], -1))
        logits.append(np.asarray(lg))
    # JAX's single-device train step on the same weights and batch as the
    # ranks' internlm2 train step
    jopt = JaxOptConfig(**W.TRAIN_OPT)
    batch = jax_synthetic_batch(np.random.default_rng(0), jcfg, W.TRAIN_B, W.TRAIN_S)
    jp, _, jm = jax.jit(jax_build_train_step(jcfg, jopt))(
        params, jax_init_opt_state(params, jopt), batch)
    step = {"loss": float(jm["loss"]), "grad_norm": float(jm["grad_norm"]),
            "lr": float(jm["lr"]), "params": W.flat(jax.tree.map(np.asarray, jp))}
    return {"internlm2": logits, "ws": np.asarray(jax_mlp(ws, ws["x"])), "ws_in": ws,
            "internlm2_step": step}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("multirank")
    ref = _inputs(d)
    jax_proc = _jax_moe(d)
    _wait(_launch("main", 8, d, d / "store_main"), "main job")
    _wait([jax_proc], "JAX moe_ep on 8 host devices")
    _wait(_launch("restore", 4, d, d / "store_restore"), "restore job")
    out = dict(np.load(d / "main_out.npz"))
    out.update(np.load(d / "restore_out.npz"))
    comp = [dict(np.load(d / f"comp_{r}.npz")) for r in range(8)]
    restore = [json.loads((d / f"restore_{r}.json").read_text()) for r in range(4)]
    return {"ref": ref, "out": out, "jax_moe": dict(np.load(d / "jax_moe.npz")),
            "comp": comp, "restore": restore}


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


@pytest.mark.slow
@pytest.mark.parametrize("tag", sorted(W.MOE_CAPACITIES))
@pytest.mark.parametrize("variant", list(W.MOE_VARIANTS))
def test_moe_ep_matches_jax_moe_ep(runs, variant, tag):
    out, calls = runs["out"][f"moe/{variant}/{tag}"], runs["out"][f"moe_calls/{variant}/{tag}"]
    assert _err(out, runs["jax_moe"][f"{variant}/{tag}"]) < TOL
    # the expert-parallel body ran (plain or dedup), never the fallback
    dedup = W.MOE_VARIANTS[variant].get("dedup_dispatch", False)
    assert calls.tolist() == ([0, 1, 0] if dedup else [1, 0, 0])


@pytest.mark.slow
@pytest.mark.parametrize("variant", ["plain", "dedup"])
def test_moe_ep_matches_moe_dense(runs, variant):
    dense = runs["jax_moe"]["dense"]
    assert _err(runs["out"][f"moe/{variant}/full"], dense) < TOL
    # the dropping capacity really drops assignments (JAX's too)
    assert _err(runs["out"][f"moe/{variant}/drop"], dense) > 1e-2
    assert _err(runs["jax_moe"][f"{variant}/drop"], dense) > 1e-2


@pytest.mark.slow
def test_moe_fallback_runs_on_local_expert_shards(runs):
    assert runs["out"]["moe_calls/fallback"].tolist() == [1]
    dense = runs["jax_moe"]["dense"][:4, :1]
    # moe_dense is per token: the first token of 4 rows is that of the
    # (8, 16) batch's rows
    assert _err(runs["out"]["moe/fallback"], dense) < TOL


@pytest.mark.slow
@pytest.mark.parametrize("name", ["attention", "decode_attention", "paged_decode_attention",
                                  "paged_decode_attention_int8", "paged_prefill_attention",
                                  "rmsnorm", "ssm_scan"])
def test_kernel_entry_point_takes_dtensors(runs, name):
    """Each ``ops`` entry point on DTensors laid out unlike what it takes
    gives the plain call's result (on the local shards; on the card the
    kernels run there)."""
    assert float(runs["out"][f"ops/{name}"]) < TOL


@pytest.mark.slow
def test_mlp_ws_decode_matches_mlp(runs):
    ws = runs["ref"]["ws_in"]
    port = TL.mlp({k: torch.from_numpy(v) for k, v in ws.items() if k != "x"},
                  torch.from_numpy(ws["x"])).numpy()
    assert _err(runs["out"]["ws/out"], runs["ref"]["ws"]) < TOL
    assert _err(runs["out"]["ws/out"], port) < TOL
    # the result is sharded on d over data, as JAX's P(None, None, "data")
    # (Shard(2) over data, replicated over model)
    assert runs["out"]["ws/placements"].tolist() == [2, -1]


@pytest.mark.slow
def test_compressed_grad_allreduce_matches_numpy(runs):
    comp = runs["comp"]
    for r, c in enumerate(comp):
        assert c["untouched"]
        group = [q for q in range(8) if (comp[q]["coord"][1:] == c["coord"][1:]).all()]
        assert len(group) == 2 and r in group
        for name, shape in (("w", (16, 32)), ("b", (32,))):
            qs, ss = [], []
            for q in group:
                g = np.random.default_rng(100 + q)
                leaves = {"w": g.normal(size=(16, 32)).astype(np.float32)}
                leaves["b"] = g.normal(size=(32,)).astype(np.float32)
                qj, sj = jax_quantize_rowwise(jnp.asarray(leaves[name]))
                qs.append(np.asarray(qj).astype(np.int32))
                ss.append(np.asarray(sj))
            want = (sum(qs).astype(np.float32) * ((ss[0] + ss[1]) / np.float32(2))).reshape(shape)
            np.testing.assert_array_equal(c[name], want)


@pytest.mark.slow
def test_sharded_internlm2_decode_matches_jax_single_device(runs):
    ref = runs["ref"]["internlm2"]
    for i, want in enumerate(ref):
        got = runs["out"][f"internlm2/logits/{i}"]
        assert _err(got, want) < DECODE_TOL, i
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.slow
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharded_decode_matches_unsharded(runs, arch):
    assert float(runs["out"][f"families/{arch}/err"]) < TOL
    assert bool(runs["out"][f"families/{arch}/tokens_equal"])
    # decode_mlp "auto": the weight-stationary MLP never runs
    assert runs["out"][f"families/{arch}/ws_calls"].tolist() == [0, 0]


@pytest.mark.slow
@pytest.mark.parametrize("arch", W.WS_ARCHS)
def test_sharded_ws_decode_matches_unsharded(runs, arch):
    """``decode_mlp="ws"``: each decode step's FFN output, sharded on d over
    data, joins the residual; tokens and logits as the unsharded run's."""
    assert float(runs["out"][f"families_ws/{arch}/err"]) < TOL
    assert bool(runs["out"][f"families_ws/{arch}/tokens_equal"])
    # the weight-stationary body ran at every decode step of every layer
    # (prefill takes mlp and does not count), never its fallback
    cfg = get_smoke_config(arch)
    body, fallback = runs["out"][f"families_ws/{arch}/ws_calls"].tolist()
    assert fallback == 0 and body == W.DECODE_STEPS * cfg.n_layers


@pytest.mark.slow
def test_restore_reshards_bit_for_bit(runs):
    for rep in runs["restore"]:
        assert rep["step"] == 7
        assert rep["equal"] and all(rep["equal"].values())
        assert all(rep["placed"].values())
        # (data 2, model 2): the embedding's vocab over model, d over data
        assert rep["local_shape"]["embedding"] == [128, 48]


# ---------------------------------------------------------------------------
# training on a mesh
# ---------------------------------------------------------------------------
def _train(runs, tag: str, arch: str) -> dict:
    pre = f"train/{tag}/{arch}/"
    return {k[len(pre):]: v for k, v in runs["out"].items() if k.startswith(pre)}


def _leaves(t: dict, what: str) -> dict:
    pre = f"plain/{what}/"
    return {k[len(pre):]: (v, t[f"sharded/{what}/" + k[len(pre):]])
            for k, v in t.items() if k.startswith(pre)}


def _check_grads(t: dict, label: str) -> None:
    """Every gradient leaf against the unsharded one, relative to the
    leaf's largest magnitude (``tests/test_torch_train.py``'s form)."""
    for name, (want, got) in _leaves(t, "grad").items():
        scale = max(float(np.abs(want).max()), 1e-30)
        assert _err(got, want) <= GRAD_TOL * scale, f"{label} {name}: {_err(got, want)} / {scale}"


def _check_params(got: dict, want: dict, lr1: float, label: str) -> None:
    """``test_train_step_matches_jax``'s rule for one AdamW step."""
    assert got.keys() == want.keys()
    for name in want:
        d = np.abs(np.asarray(got[name], np.float64) - np.asarray(want[name], np.float64))
        assert d.max() <= 2 * lr1 + PARAM_TOL, f"{label} {name}: {d.max()}"
        assert (d > PARAM_TOL).mean() < 0.01, f"{label} {name}: {(d > PARAM_TOL).mean()}"


#: the leaves a ``local_call`` body takes replicated while the rows are
#: sharded over ``data``, whose gradients must be summed over it
_REPLICATED_LEAVES = {
    "internlm2_20b": ("final_norm", "norm1", "norm2"),
    "jamba_1_5_large_398b": ("final_norm", "norm1", "norm2", "A_log", "/D", "dt_bias"),
}


@pytest.mark.slow
@pytest.mark.parametrize("tag", ["4x2", "2x2"])
@pytest.mark.parametrize("arch", ["internlm2_20b", "jamba_1_5_large_398b"])
def test_sharded_gradients_match_unsharded(runs, arch, tag):
    """Every gradient leaf of ``loss_and_grads`` on params placed by the
    param specs equals the unsharded one: RMSNorm's gamma and the scan's
    ``A_log``, ``D`` and ``dt_bias`` too, whose gradients each rank holds
    for its own rows only until they are summed over ``data``."""
    t = _train(runs, tag, arch)
    np.testing.assert_allclose(t["sharded/loss"], t["plain/loss"], rtol=LOSS_TOL)
    names = list(_leaves(t, "grad"))
    for part in _REPLICATED_LEAVES[arch]:
        assert any(part in n for n in names), part
    _check_grads(t, f"{arch} {tag}")
    assert bool(t["placed"])


@pytest.mark.slow
@pytest.mark.parametrize("arch", W.HEAD_SPLIT_ARCHS)
def test_sharded_gradients_where_model_splits_a_head(runs, arch):
    """Four heads over a ``model`` dim of 8: each rank holds half a head's
    columns of ``wq``/``wk``/``wv``, so the heads are gathered before
    attention and the merged output's gradient is split back through
    ``sharding.merge_heads`` (Whisper's encoder, self- and
    cross-attention; DeepSeek's MLA).  Every gradient leaf against the
    unsharded ``loss_and_grads``."""
    t = _train(runs, "1x8", arch)
    np.testing.assert_allclose(t["sharded/loss"], t["plain/loss"], rtol=LOSS_TOL)
    assert any("xattn" in n for n in _leaves(t, "grad")) or arch != "whisper_tiny"
    _check_grads(t, f"{arch} 1x8")
    assert bool(t["placed"])


_STEP_CASES = [(a, tag) for tag in ("4x2", "2x2") for a in W.TRAIN_ARCHS] + [
    ("internlm2_20b", "2x2_int8")]


@pytest.mark.slow
@pytest.mark.parametrize("arch,tag", _STEP_CASES)
def test_sharded_train_step_matches_unsharded(runs, arch, tag):
    """One ``build_train_step`` step on the mesh: the loss, ``grad_norm``,
    every gradient leaf and the updated params against the same step
    without a mesh; the gradients and the AdamW state placed as their
    parameters, the step counter a plain tensor."""
    t = _train(runs, tag, arch)
    for key in ("step_loss", "grad_norm"):
        np.testing.assert_allclose(t[f"sharded/{key}"], t[f"plain/{key}"], rtol=LOSS_TOL)
    _check_grads(t, f"{arch} {tag}")
    lr1 = W.TRAIN_OPT["lr"] / W.TRAIN_OPT["warmup_steps"]
    params = _leaves(t, "param")
    _check_params({k: g for k, (_, g) in params.items()}, {k: w for k, (w, _) in params.items()},
                  lr1, f"{arch} {tag}")
    assert bool(t["placed"])
    if arch == "kimi_k2_1t_a32b":   # the expert-parallel body, never its fallback
        n_moe = get_smoke_config(arch).n_layers
        assert t["ep_calls"].tolist() == [n_moe, 0, 0]


@pytest.mark.slow
def test_sharded_train_step_matches_jax_single_device(runs):
    """internlm2's step on (data 4, model 2) against JAX's jitted step on
    one device, on JAX's weights and batch (JAX's own sharded step fails at
    its vocab-sharded gather under the installed JAX)."""
    t = _train(runs, "4x2", "internlm2_20b")
    ref = runs["ref"]["internlm2_step"]
    np.testing.assert_allclose(t["sharded/step_loss"], ref["loss"], rtol=LOSS_TOL)
    np.testing.assert_allclose(t["sharded/grad_norm"], ref["grad_norm"], rtol=LOSS_TOL)
    got = {k[len("sharded/param/"):]: v for k, v in t.items() if k.startswith("sharded/param/")}
    _check_params(got, ref["params"], ref["lr"], "internlm2 4x2 vs JAX")


@pytest.mark.slow
@pytest.mark.parametrize("tag", sorted(W.MOE_CAPACITIES))
@pytest.mark.parametrize("variant", list(W.MOE_VARIANTS))
def test_moe_ep_gradient_matches_jax(runs, variant, tag):
    """``moe_ep`` under grad (the all-to-all's backward is the reverse
    exchange; the int8 dispatch's rounding passes no gradient, as in JAX):
    the input's and every expert leaf's gradient against ``jax.grad`` of
    JAX's ``moe_ep`` on 8 host devices."""
    pre = f"moe_grad/{variant}/{tag}/"
    got = {k[len(pre):]: v for k, v in runs["out"].items() if k.startswith(pre)}
    want = {k[len("grad/" + variant + "/" + tag + "/"):]: v
            for k, v in runs["jax_moe"].items() if k.startswith(f"grad/{variant}/{tag}/")}
    assert got.keys() == want.keys() and "x" in got and "w_down" in got
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert _err(got[name], w) <= GRAD_TOL * scale, f"{name}: {_err(got[name], w)} / {scale}"


@pytest.mark.slow
@pytest.mark.parametrize("variant", ["plain", "dedup"])
def test_moe_ep_gradient_matches_moe_dense(runs, variant):
    """At capacity factor 2.0 nothing is dropped: the gradients equal
    ``moe_dense``'s (JAX's ``jax.grad``), and at 0.5 they do not."""
    for tag, close in (("full", True), ("drop", False)):
        pre = f"moe_grad/{variant}/{tag}/"
        errs = {}
        for k, v in runs["out"].items():
            if k.startswith(pre):
                want = runs["jax_moe"]["grad/dense/" + k[len(pre):]]
                errs[k[len(pre):]] = _err(v, want) / max(float(np.abs(want).max()), 1e-30)
        assert len(errs) == 8
        if close:
            assert max(errs.values()) <= GRAD_TOL, errs
        else:
            assert errs["w_down"] > 1e-2, errs


@pytest.mark.slow
@pytest.mark.parametrize("name", ["attention", "rmsnorm", "ssm_scan"])
def test_kernel_entry_point_gradients_on_dtensors(runs, name):
    """The gradient of every input of an ``ops`` entry point on DTensors
    (laid out unlike what it takes) against the plain-tensor call's: on
    the card the backward kernels run on the local shards."""
    assert float(runs["out"][f"ops/grad/{name}"]) < TOL
    assert int(runs["out"][f"ops/grad/{name}/n"]) == {"attention": 3, "rmsnorm": 2,
                                                       "ssm_scan": 7}[name]


@pytest.mark.slow
def test_int8_state_restores_onto_the_mesh(runs):
    """``(params, opt_state)`` with int8 AdamW state after a step on
    (data 2, model 2), saved and restored with ``state_shardings``: every
    leaf (codes, scales, the step) equal to the bit and placed as it was."""
    out = runs["out"]
    assert bool(out["state_restore/equal"]) and bool(out["state_restore/placed"])
    # 12 params, each m and v as codes and scales, and the step
    assert int(out["state_restore/n"]) == 12 + 12 * 4 + 1
