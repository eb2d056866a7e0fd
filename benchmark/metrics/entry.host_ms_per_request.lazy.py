"""entry.host_ms_per_request.lazy: the mean over the traced requests of a
request's span less the device's busy time inside it, in ms: what the
entry's host path (padding, uploads, downloads, Python) adds."""

import numpy as np

from benchmark.timeline import covered


def read(run):
    tl = run.timeline
    if tl is None or not tl.requests:
        return None
    starts = np.asarray([s for s, _, _ in tl.requests])
    ends = np.asarray([e for _, e, _ in tl.requests])
    host = (ends - starts) - covered(tl.busy(), starts, ends)
    return 1e3 * float(host.mean())
