"""Training launcher: real steps on the card, or on the CPU (smoke configs).

Copy of ``repro/launch/train.py`` on one device:

  1. restore the latest checkpoint if present (crash/preemption restart);
  2. build the train step (``models.zoo.build_train_step``: ``lm_loss``,
     autograd — on the card through the flash and RMSNorm backward
     kernels — and AdamW with float32 or int8 state, updated in place as
     JAX's donated step);
  3. step the synthetic LM data pipeline, checkpointing every
     ``--ckpt-every`` steps (atomic publish).

It keeps every flag of the JAX launcher and adds ``--device``: the CUDA
device unless ``--device cpu`` is given.  The JAX launcher's docstring
names a mesh, resharding restores and int8 gradient compression, but its
code builds no mesh and calls no sharding or compression function
(``repro/launch/train.py:61-103``), so this one runs on one device too;
those pieces live in :mod:`repro_torch.distributed` and
:mod:`repro_torch.launch.mesh`.  ``synthetic_batch``
draws with the same numpy calls, so a seed gives JAX's batches; the
weights are the port's own draw from ``--seed``.

Two deliberate departures:

- a run resumed at step ``s`` first draws (and drops) the ``s`` batches
  the steps before it took, so step ``s + 1`` sees the batch an
  uninterrupted run gives it and a restart reproduces the uninterrupted
  losses.  The JAX launcher restarts its data stream at the first batch
  on resume;
- a run that resumes at or past ``--steps`` takes no step, prints
  "nothing to do" and returns 1.  The JAX launcher raises ``IndexError``
  there (it reads ``losses[0]`` of an empty list).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --smoke --device cpu --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..device import resolve_device
from ..distributed.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..distributed.optimizer import OptConfig, init_opt_state
from ..models import init_params
from ..models.zoo import build_train_step


def synthetic_batch(rng: np.random.Generator, cfg, batch: int, seq: int,
                    device: torch.device = torch.device("cpu")):
    """Synthetic LM data pipeline: Zipf-ish token stream + shifted targets."""
    z = rng.zipf(1.3, size=(batch, seq + 1)) % cfg.vocab
    toks = torch.as_tensor(z[:, :-1], dtype=torch.int32, device=device)
    tgts = torch.as_tensor(z[:, 1:], dtype=torch.int32, device=device)
    out = {"tokens": toks, "targets": tgts}
    if cfg.family in ("vlm", "audio"):
        out["enc_input"] = torch.full(
            (batch, cfg.encoder.n_ctx, cfg.d_model), 0.01, dtype=cfg.tdtype, device=device
        )
    return out


def main(argv=None, report: Optional[dict] = None) -> int:
    """Run the launcher; returns 0 when the loss fell, else 1.

    ``report``, when given, is filled with the run: ``losses``,
    ``grad_norms``, ``step_s`` (host seconds of each step, ended by the
    loss's read, which waits for the device), ``start``, and the final
    ``params``, ``opt_state``, ``step_fn``, ``cfg`` and ``args``, so a
    caller can time or trace further steps.
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--opt-state", default="float32", choices=["float32", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where to train: the CUDA device unless 'cpu' is given")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = OptConfig(lr=args.lr, state_dtype=args.opt_state, warmup_steps=5)
    step_fn = build_train_step(cfg, opt_cfg)

    params = init_params(cfg, args.seed, device=dev)
    opt_state = init_opt_state(params, opt_cfg)
    start = 0

    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start = restore_checkpoint(
            args.ckpt_dir, like=(params, opt_state)
        )
        print(f"[train] resumed from step {start}")

    rng = np.random.default_rng(args.seed)
    for _ in range(start):  # the batches the restored steps took
        synthetic_batch(rng, cfg, args.batch, args.seq)
    losses, gnorms, step_s = [], [], []
    t0 = time.perf_counter()
    for s in range(start, args.steps):
        batch = synthetic_batch(rng, cfg, args.batch, args.seq, dev)
        ts = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - ts)
        gnorm = float(metrics["grad_norm"])
        losses.append(loss)
        gnorms.append(gnorm)
        print(f"[train] step={s+1:4d} loss={loss:8.4f} "
              f"gnorm={gnorm:8.3f}", flush=True)
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            p = save_checkpoint(args.ckpt_dir, s + 1, (params, opt_state))
            print(f"[train] checkpointed -> {p}")
    dt = time.perf_counter() - t0
    if report is not None:
        report.update(losses=losses, grad_norms=gnorms, step_s=step_s, start=start,
                      params=params, opt_state=opt_state, step_fn=step_fn, cfg=cfg,
                      args=args)
    if not losses:
        print(f"[train] nothing to do: resumed at step {start} of {args.steps}")
        return 1
    print(f"[train] {args.steps - start} steps in {dt:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
