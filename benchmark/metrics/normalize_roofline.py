"""normalize_roofline: the stats route's normalize's (`normalize_stats`)
roofline share in the traced window, in %: the least time of the bytes it
moves, the logits and row stats read and the posteriors written
(benchmark.stats_route.normalize), over its device time.  Nothing to read
where no normalize ran."""

from benchmark.stats_route import kernel_share, normalize


def read(run):
    return kernel_share(run, "normalize_stats", normalize)
