"""Hand-written Hopper kernels of the port, beside their plain versions.

Each ported kernel has:
- ``csrc/<name>.cu`` — the CUDA C++ kernel for ``sm_90a`` with a plain C
  entry point (built by :mod:`._build` at first use, loaded with ctypes);
- ``<module>.py``    — its wrapper: checks, output allocation, launch on
  the current stream, launch check and launch count;
- ``ref.py``         — its plain PyTorch version, the semantics the kernel
  is held against;
- ``ops.py``         — the dispatch the models call (kernel for CUDA
  tensors, plain version for CPU tensors).

Kernels: paged decode attention and paged chunked-prefill attention (over
fp or int8 pages), RMSNorm, slot-cache decode attention, flash attention
and the Mamba selective scan.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
