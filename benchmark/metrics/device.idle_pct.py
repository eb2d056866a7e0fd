"""device.idle_pct: the share of the traced window in which no kernel,
copy or fill ran on the device (the union of the profiler's device
intervals)."""


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)
