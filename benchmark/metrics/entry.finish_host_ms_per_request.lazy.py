"""entry.finish_host_ms_per_request.lazy: host ms inside the program's
`fastdnn.finish` spans per request, less the device's busy time inside
them: the wait, the download's host side and numpy (benchmark.spans)."""

from benchmark.spans import host_ms_per_request


def read(run):
    return host_ms_per_request(run.timeline, "fastdnn.finish")
