"""output_chain.host_ms_per_request: host ms inside the program's
`fastdnn.output_chain` spans per request, less the device's busy time
inside them: a TDNN-F net's prefinal pair and chain output, their
allocations and four launches (benchmark.spans).  Nothing to read in a
program that records no such span."""

from benchmark.spans import host_ms_per_request


def read(run):
    return host_ms_per_request(run.timeline, "fastdnn.output_chain")
