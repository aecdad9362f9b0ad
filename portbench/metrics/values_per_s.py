"""values_per_s: every value of every request completed in the window,
over the window's seconds (host clock, first call to last answer)."""


def read(run):
    if not run.requests or run.window_s <= 0:
        return None
    return sum(r.values for r in run.requests) / run.window_s
