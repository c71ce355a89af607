"""All of the window's engine ``step()`` wall time over its steps, in ms.
A decode step ends in its logits' host copy, which waits for the device."""


def read(rec, cfg):
    steps = rec.data.get("steps")
    if not steps:
        return None
    return 1e3 * sum(b - a for a, b in steps) / len(steps)
