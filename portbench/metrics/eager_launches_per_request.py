"""eager_launches_per_request: the kernels in the trace of the window
that are not hand-written (aten, cuBLAS), per request."""


def read(run):
    t = run.trace
    if t is None or not t.busy_merged or not run.requests:
        return None
    lo, hi = t.window
    eager = [n for n, _ in t.kernels(lo, hi) if run.handwritten(n) is None]
    return len(eager) / len(run.requests)
