"""dispatch.host_ms_per_request: the mean ms of the program's
`fastdnn.score_device` span per request: the Python and the three kernel
launches of a dense request, none of which waits on the device
(benchmark.spans)."""

from benchmark.spans import ms_per_request


def read(run):
    return ms_per_request(run.timeline, "fastdnn.score_device")
