"""device_idle_pct: the share of the traced window in which no kernel,
memcpy or memset ran on the card (union of the trace's device
activity)."""


def read(run):
    t = run.trace
    if t is None or not t.busy_merged:
        return None
    lo, hi = t.window
    if hi <= lo:
        return None
    return 100.0 * (1.0 - t.busy(lo, hi) / (hi - lo))
