"""kernel_launches_per_request: the increase of the program's launch
counters (``kernels.COUNTS``, one per hand-written kernel) over the
traced window, per request."""


def read(run):
    if run.launches is None or not run.requests:
        return None
    return sum(run.launches.values()) / len(run.requests)
