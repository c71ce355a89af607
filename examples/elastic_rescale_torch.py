"""Elastic scaling on the port: checkpoint on one mesh, restore on another.

The PyTorch twin of ``examples/elastic_rescale.py``: internlm2's smoke
config trains 3 steps on a (data 4, model 2) mesh and checkpoints the
parameters with the AdamW state; then half the data-parallel slice is
"lost": a relaunch on half the ranks rebuilds a (data 2, model 2) mesh,
``restore_checkpoint(shardings=)`` places every stored array on it (the
state as its parameters), and training resumes for 3 more steps.  Each
step prints its loss.

Each phase starts its own ranks, one process each, on a ``FileStore`` in
a temporary directory: 8, then 4.  On the cards (the default) each rank
takes one card over NCCL, and the script refuses to start with fewer
cards than ranks; ``--device cpu`` runs the ranks on ``gloo``.  The
relaunched phase draws and drops the batches the first phase took, so
its steps see the batches an uninterrupted run gives them (JAX's example
runs both phases in one process and one data stream).

``--out DIR`` writes ``DIR/losses.json`` and the final parameters as a
checkpoint (``DIR/final``); ``--dtype float32`` trains in float32 (the
smoke config's dtype otherwise).

Run:  PYTHONPATH=src python examples/elastic_rescale_torch.py --device cpu
"""

import argparse
import datetime
import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.distributed.optimizer import OptConfig, init_opt_state, state_shardings
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import init_params
from repro_torch.models.zoo import build_train_step, param_specs

ARCH = "internlm2_20b"
OPT = OptConfig(lr=1e-3, warmup_steps=2)
BATCH, SEQ = 8, 32
#: (mesh shape, steps) of each phase; the second is a relaunch
PHASES = (((4, 2), 3), ((2, 2), 3))
LIMIT_S = 600


def _config(dtype):
    cfg = get_smoke_config(ARCH)
    return cfg.with_(dtype=dtype) if dtype else cfg


def _phase(rank: int, world: int, store: str, phase: int, args) -> None:
    cpu = args.device == "cpu"
    if not cpu:
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if cpu else "nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=LIMIT_S))
    try:
        if cpu:
            torch.set_num_threads(1)
        _train(rank, phase, args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _train(rank: int, phase: int, args) -> None:
    cfg = _config(args.dtype)
    dev = "cpu" if args.device == "cpu" else torch.device("cuda", rank)
    shape, steps = PHASES[phase]
    tag = "x".join(map(str, shape))
    step_fn = build_train_step(cfg, OPT)
    rng = np.random.default_rng(0)
    mesh = make_mesh(shape, ("data", "model"))
    params = init_params(cfg, 0, dev)
    with shd.use_mesh(mesh):
        sh = shd.tree_shardings(param_specs(cfg), params, mesh)
        if phase == 0:
            start = 0
            params = shd.device_put_tree(params, sh)
            opt_state = init_opt_state(params, OPT)
        else:
            like = (params, init_opt_state(params, OPT))
            (params, opt_state), start = restore_checkpoint(
                args.ckpt, like=like, shardings=(sh, state_shardings(sh, like[1])))
            if rank == 0:
                print(f"restored step {start} onto {tag} (ranks/leaf: "
                      f"{params['embedding'].device_mesh.size()})", flush=True)
            for _ in range(start):   # the batches the first phase took
                synthetic_batch(rng, cfg, BATCH, SEQ)
        losses = []
        for s in range(start, start + steps):
            batch = synthetic_batch(rng, cfg, BATCH, SEQ, device=torch.device(dev))
            params, opt_state, m = step_fn(params, opt_state, batch)
            losses.append(float(m["loss"]))
            if rank == 0:
                print(f"[mesh {tag}] step={s + 1} loss={losses[-1]:.3f}", flush=True)
    save_checkpoint(args.ckpt, start + steps, (params, opt_state), mesh_desc=tag)
    if rank == 0:
        print(f"checkpointed on {tag}", flush=True)
        with open(os.path.join(args.ckpt, f"losses_{phase}.json"), "w") as f:
            json.dump(losses, f)
    if args.out and phase == len(PHASES) - 1:
        save_checkpoint(os.path.join(args.out, "final"), start + steps, params)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dtype", default=None, help="the model dtype (default: the config's)")
    ap.add_argument("--out", default=None, help="write losses.json and the final params here")
    args = ap.parse_args(argv)
    world = max(s[0] * s[1] for s, _ in PHASES)
    if args.device == "cuda" and torch.cuda.device_count() < world:
        print(f"elastic_rescale_torch: needs {world} CUDA devices, one a rank, and sees "
              f"{torch.cuda.device_count()}; run with --device cpu for gloo ranks",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        args.ckpt = os.path.join(tmp, "ckpt")
        losses = []
        for phase, (shape, _) in enumerate(PHASES):
            n = shape[0] * shape[1]
            mp.start_processes(_phase, args=(n, os.path.join(tmp, f"store_{phase}"), phase, args),
                               nprocs=n, join=True, start_method="spawn")
            with open(os.path.join(args.ckpt, f"losses_{phase}.json")) as f:
                losses += json.load(f)
            if phase == 0:
                print(f"-- relaunch on {PHASES[1][0][0] * PHASES[1][0][1]} ranks --", flush=True)
    if args.out:
        with open(os.path.join(args.out, "losses.json"), "w") as f:
            json.dump(losses, f)
    print("elastic rescale OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
