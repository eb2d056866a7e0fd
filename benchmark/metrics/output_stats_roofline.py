"""output_stats_roofline: K8's (`flash_stats`) roofline share in the traced
window, in %: the least time of its own work, the output layer's products
and the logits and row stats it writes (benchmark.stats_route.flash_stats),
over its device time.  Nothing to read where no K8 ran."""

from benchmark.stats_route import flash_stats, kernel_share


def read(run):
    return kernel_share(run, "flash_stats", flash_stats)
