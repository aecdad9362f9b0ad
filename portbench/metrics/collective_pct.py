"""collective_pct: the share of rank 0's traced window covered by the
collectives library's kernels (NCCL: the all-gather of the ranks'
partials).  A collective kernel runs until the last rank has given its
part, so this share holds rank 0's wait for the slowest rank as well as
the exchange.  None where the window ran no collective kernel."""


def read(run):
    t = run.trace
    if t is None:
        return None
    lo, hi = t.window
    part = t.collective(lo, hi)
    if hi <= lo or part <= 0:
        return None
    return 100.0 * part / (hi - lo)
