"""`request_p95_ms`: the 95th percentile of every request's time in the
window (numpy's linear interpolation between order statistics)."""

import numpy as np
from harness.readings import REQUESTS


def read(run):
    lat = run["window"].get("latencies_s")
    if run["kind"] not in REQUESTS or not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95.0)) * 1e3
