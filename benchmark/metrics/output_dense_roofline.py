"""output_dense_roofline: the layer's roofline share in the traced window, in %
(benchmark.roofline.layer_share: its work's least time at the card's peaks over the
device time of the kernels that compute it)."""

from benchmark.roofline import layer_share


def read(run):
    return layer_share(run, "output_dense")
