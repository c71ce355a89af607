"""Mean wall time of ``LLMSched.schedule`` a round in the window, in ms
(host clock around each call, as the program's ``RunMetrics`` takes it)."""


def read(rec, cfg):
    spans = rec.data.get("sched")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
