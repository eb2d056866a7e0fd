"""entry.idle_in_program_ms_per_request: ms of the traced window's device
idle time per request that fall inside the span of one of the program's
public entries: the device waiting on the program's own dispatch, not on
its caller (benchmark.spans)."""

from benchmark.spans import idle_in_entries_ms_per_request


def read(run):
    return idle_in_entries_ms_per_request(run.timeline)
