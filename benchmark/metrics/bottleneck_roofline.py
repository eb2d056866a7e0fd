"""bottleneck_roofline: the low-rank output layer's bottleneck kernel
(`lowrank_bottleneck`) roofline share in the traced window, in %: the
least time of its own work, the output layer's first product and the codes
and scales it writes (benchmark.lowrank_route.bottleneck), over its device
time.  Nothing to read for a net without a rank, or where no such kernel
ran."""

from benchmark.lowrank_route import bottleneck
from benchmark.stats_route import kernel_share


def read(run):
    if "rank" not in run.config:
        return None
    return kernel_share(run, "lowrank_bottleneck", bottleneck)
