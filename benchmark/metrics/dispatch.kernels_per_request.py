"""dispatch.kernels_per_request: device operations (kernels, copies and
fills) that start inside a traced request (its span taken half-open),
per request."""

import numpy as np


def read(run):
    tl = run.timeline
    if tl is None or not tl.requests or not tl.device:
        return None
    starts = np.sort(np.asarray([s for s, _, _ in tl.device]))
    inside = sum(
        int(np.searchsorted(starts, e) - np.searchsorted(starts, s))
        for s, e, _ in tl.requests
    )
    return inside / len(tl.requests)
