"""dispatch.kernels_per_request.chunks: device operations (kernels, copies
and fills) that start inside a traced request of chunks, per request: the
launches a TDNN-F request makes, the same count as
dispatch.kernels_per_request's (which moves the lazy cells' latency)."""

from benchmark import spec


def read(run):
    return spec.reader("dispatch.kernels_per_request").read(run)
