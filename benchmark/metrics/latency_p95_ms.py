"""latency_p95_ms: the 95th percentile (linear interpolation) over every
request of the window of the host-clock time from its issue to its result
being usable by the caller.  A failed request counts as missing every
limit (infinitely late); when that reaches the percentile there is no
number to give."""

import math

import numpy as np


def read(run):
    if not run.requests:
        return None
    lat = [r.end - r.start if r.ok else math.inf for r in run.requests]
    p95 = float(np.percentile(lat, 95))
    return p95 * 1e3 if math.isfinite(p95) else None
