"""request_ms_p95.device_bound: request_ms_p95, read in the cells
whose device is busy most of the window, under a bound of their own:
their runs spread several times less than those of the cells that the
host's Python paces."""


def read(run):
    return run.metric("request_ms_p95")
