"""request_ms_p50: the median latency of all requests of the window,
each timed on the host clock from the call to its answer."""

import numpy as np


def read(run):
    lat = [r.seconds for r in run.requests]
    return float(np.percentile(lat, 50) * 1e3) if lat else None
