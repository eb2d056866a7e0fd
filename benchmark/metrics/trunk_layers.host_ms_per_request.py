"""trunk_layers.host_ms_per_request: host ms inside the program's
`fastdnn.trunk_layers` spans per request, less the device's busy time
inside them: the trunk's per-layer loop, one layer kernel's allocation and
launch a layer (benchmark.spans).  Nothing to read in a program that
records no such span."""

from benchmark.spans import host_ms_per_request


def read(run):
    return host_ms_per_request(run.timeline, "fastdnn.trunk_layers")
