"""request_ms_p95: the 95th percentile of the latencies of all requests
of the window (numpy's linear interpolation between order statistics)."""

import numpy as np


def read(run):
    lat = [r.seconds for r in run.requests]
    return float(np.percentile(lat, 95) * 1e3) if lat else None
