"""Trace one (architecture × shape × mesh) cell of the port on shapes alone
and print its roofline decomposition: the multi-pod dry run in miniature.

The port's counterpart of ``examples/dryrun_cell.py``.  Each cell starts
a fake process group of the mesh's size, and a process holds one default
group at a time, so this example shells out to the dryrun module, once a
mesh (16×16, then 2×16×16).  Nothing is allocated and no device is used.

Run:  PYTHONPATH=src python examples/dryrun_cell_torch.py [arch] [shape]
"""

import subprocess
import sys


def main() -> None:
    arch = sys.argv[1] if len(sys.argv) > 1 else "internlm2-20b"
    shape = sys.argv[2] if len(sys.argv) > 2 else "decode_32k"
    for extra in ([], ["--multi-pod"]):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape] + extra
        print("$", " ".join(cmd))
        subprocess.run(cmd, check=False)


if __name__ == "__main__":
    main()
