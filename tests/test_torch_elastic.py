"""The port's elastic example on CPU ``gloo`` ranks.

``examples/elastic_rescale_torch.py --device cpu`` trains internlm2's
smoke config 3 steps on (data 4, model 2), checkpoints the parameters and
the AdamW state, relaunches on 4 ranks, restores onto (data 2, model 2)
and trains 3 more steps.  In float32 its 6 losses equal those of an
uninterrupted 6-step run without a mesh on the same batches, and its
final parameters meet ``test_train_step_matches_jax``'s rule (here with
the largest learning rate of the run).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed.checkpoint import restore_checkpoint
from repro_torch.distributed.optimizer import init_opt_state, tree_leaves
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import init_params
from repro_torch.models.zoo import build_train_step
from test_torch_train import LOSS_TOL, PARAM_TOL

REPO = Path(__file__).resolve().parents[1]
LIMIT_S = 400


def _example():
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import elastic_rescale_torch
    finally:
        sys.path.remove(str(REPO / "examples"))
    return elastic_rescale_torch


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "elastic_rescale_torch.py"), "--device", "cpu",
         "--dtype", "float32", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=LIMIT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out, proc.stdout


def _uninterrupted(ex):
    """The same 6 steps without a mesh: (losses, final params)."""
    cfg = ex._config("float32")
    params = init_params(cfg, 0, "cpu")
    state = init_opt_state(params, ex.OPT)
    step = build_train_step(cfg, ex.OPT)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(sum(n for _, n in ex.PHASES)):
        params, state, m = step(params, state, synthetic_batch(rng, cfg, ex.BATCH, ex.SEQ))
        losses.append(float(m["loss"]))
    return losses, params


def test_elastic_example_prints_both_meshes(elastic):
    _, out = elastic
    assert "[mesh 4x2] step=3 loss=" in out and "[mesh 2x2] step=6 loss=" in out
    assert "restored step 3 onto 2x2 (ranks/leaf: 4)" in out
    assert out.strip().endswith("elastic rescale OK")


def test_elastic_losses_and_params_match_an_uninterrupted_run(elastic):
    out, _ = elastic
    ex = _example()
    want, params = _uninterrupted(ex)
    got = json.loads((out / "losses.json").read_text())
    assert len(got) == 6
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
    final, step = restore_checkpoint(str(out / "final"), like=params)
    assert step == 6
    lr = ex.OPT.lr
    for i, (got_p, want_p) in enumerate(zip(tree_leaves(final), tree_leaves(params))):
        d = (got_p.double() - want_p.double()).abs()
        assert float(d.max()) <= 2 * lr + PARAM_TOL, i
        assert float((d > PARAM_TOL).double().mean()) < 0.01, i


def test_elastic_example_refuses_without_enough_cards(monkeypatch, capsys):
    ex = _example()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert ex.main([]) == 2
    assert "needs 8 CUDA devices" in capsys.readouterr().err
