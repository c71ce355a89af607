"""The whole step's share (%) of the card's bf16 peak: the model FLOPs of
every token the window processed, prompt and decode, at its context
(``bench/roofline.py``), over the window's seconds times 989e12."""

from bench import roofline


def read(rec, cfg):
    flops = rec.data.get("model_flops")
    if not flops or rec.window_s <= 0:
        return None
    return 100.0 * flops / (rec.window_s * roofline.PEAK_BF16_FLOPS)
