"""entry.idle_in_program_pct.lazy: the share of the traced window's device
idle time that falls inside the span of one of the program's public
entries, in %; the rest fell in the caller's code (benchmark.spans)."""

from benchmark.spans import idle_in_entries_pct


def read(run):
    return idle_in_entries_pct(run.timeline)
