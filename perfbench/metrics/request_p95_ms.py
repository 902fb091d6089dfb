"""The 95th percentile of one request's latency, from the call to its decision on the host, over every request of the window."""

import numpy as np


def read(r):
    lat = r.window.latencies
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
