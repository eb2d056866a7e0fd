"""entry.masks_ms_per_request.lazy: host ms inside the program's
`fastdnn.masks` spans per request, less the device's busy time inside
them: the caller's mask compared, cast to u8, padded and uploaded
(benchmark.spans)."""

from benchmark.spans import host_ms_per_request


def read(run):
    return host_ms_per_request(run.timeline, "fastdnn.masks")
