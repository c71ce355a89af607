"""Share (%) of the profiled sub-window in which no kernel ran on the
card: one less the union of the kernels' intervals over its length."""

from bench.harness import idle_share


def read(rec, cfg):
    t = rec.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * idle_share([(a, b) for _, a, b in t.kernels], t.t0, t.t1)
