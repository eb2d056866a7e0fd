"""output_lazy.host_ms_per_request.lazy: host ms inside the program's
`fastdnn.output_lazy` spans per request, less the device's busy time
inside them: the host's side of a frame's output layer, the wrapper's
checks, its output's allocation and the one `lazy_output` launch
(benchmark.spans)."""

from benchmark.spans import host_ms_per_request


def read(run):
    return host_ms_per_request(run.timeline, "fastdnn.output_lazy")
