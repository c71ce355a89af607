"""Share (%) of the prompt tokens of the window's admissions that the
prefix cache served: the engine's ``prefill_skipped_tokens`` over the
window, over the same plus the tokens its requests prefilled."""


def read(rec, cfg):
    skip = rec.data.get("prefix_skipped")
    run = rec.data.get("prefix_prefilled")
    if skip is None or run is None or skip + run == 0:
        return None
    return 100.0 * skip / (skip + run)
