"""eager_launches_per_request: the kernels in the trace of the window
that are neither hand-written nor the collectives library's (aten,
cuBLAS), per request.  NCCL's kernels are left out, since
collective_pct reads them; a cell on one card launches none."""

from portbench.tracing import is_collective


def read(run):
    t = run.trace
    if t is None or not t.busy_merged or not run.requests:
        return None
    lo, hi = t.window
    eager = [n for n, _ in t.kernels(lo, hi)
             if run.handwritten(n) is None and not is_collective(n)]
    return len(eager) / len(run.requests)
