"""The 95th percentile of the JCT of every job that arrived in the window
(the censored time of an unfinished one), in seconds."""

from bench.harness import percentile


def read(rec, cfg):
    jcts = rec.data.get("jcts")
    return percentile(jcts, 95) if jcts else None
