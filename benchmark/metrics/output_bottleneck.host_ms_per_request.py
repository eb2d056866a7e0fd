"""output_bottleneck.host_ms_per_request: host ms inside the program's
`fastdnn.output_bottleneck` spans per request, less the device's busy time
inside them: a low-rank output layer's bottleneck, its allocations and its
one launch (benchmark.spans).  Nothing to read in a program that records
no such span."""

from benchmark.spans import host_ms_per_request


def read(run):
    return host_ms_per_request(run.timeline, "fastdnn.output_bottleneck")
