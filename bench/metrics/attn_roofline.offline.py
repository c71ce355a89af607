"""Share (%) of their roofline the attention kernels reach in the profiled
sub-window: each recorded call's bound time (``bench/roofline.py``, from
its shapes and lengths, bytes once) summed, over the device time of the
port's attention kernels by name."""

from bench import roofline


def read(rec, cfg):
    t = rec.trace
    if t is None or not t.attn_calls:
        return None
    bound = sum(roofline.bound_s(*roofline.attention_call(n, i)) for n, i in t.attn_calls)
    dev = sum(b - a for name, a, b in t.kernels if roofline.is_attention_kernel(name))
    if dev <= 0:
        return None
    return 100.0 * bound / dev
