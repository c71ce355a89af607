"""Kernel launches the host made (``cudaLaunchKernel``, ``cuLaunchKernelEx``
and their kin) over the engine steps of the profiled sub-window."""


def read(rec, cfg):
    t = rec.trace
    if t is None or t.steps == 0:
        return None
    return t.launches / t.steps
