"""output_stats.host_ms_per_request: host ms inside the program's
`fastdnn.output_stats` spans per request, less the device's busy time
inside them: the stats route's allocations and its two launches, K8 and
the normalize (benchmark.spans).  Nothing to read in a program that
records no such span."""

from benchmark.spans import host_ms_per_request


def read(run):
    return host_ms_per_request(run.timeline, "fastdnn.output_stats")
