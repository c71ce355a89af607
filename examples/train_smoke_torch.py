"""Train a reduced llama-family model with checkpoint/restart, on the port.

The PyTorch twin of ``examples/train_smoke.py``: the synthetic LM data
pipeline, AdamW with int8 states, atomic checkpointing every 10 steps, and
crash-restart resume (kill and re-run: it continues from the last
checkpoint), through ``repro_torch.launch.train``.  ``--device`` is passed
through: the CUDA device unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/train_smoke_torch.py --device cpu
"""

import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = [] if args.device is None else ["--device", args.device]
    with tempfile.TemporaryDirectory() as ckpt:
        # phase 1: 10 steps, checkpoint at step 10
        train_main([
            "--arch", "llama3-405b", "--smoke", "--steps", "10",
            "--batch", "4", "--seq", "64", "--opt-state", "int8",
            "--ckpt-dir", ckpt, "--ckpt-every", "10", *dev,
        ])
        print("\n-- simulated restart (picks up from step 10) --\n")
        # phase 2: resumes from the checkpoint and continues to 16
        train_main([
            "--arch", "llama3-405b", "--smoke", "--steps", "16",
            "--batch", "4", "--seq", "64", "--opt-state", "int8",
            "--ckpt-dir", ckpt, "--ckpt-every", "10", *dev,
        ])


if __name__ == "__main__":
    main()
