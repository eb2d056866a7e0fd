"""The program's own spans in a traced window: the host spans it records
under the prefix `fastdnn.` (the program's engine/scorer.py lists them)
on the requesting thread, which the timeline keeps among its host
operations (Timeline.host).  A program that records none gives these
readings nothing to read: each is then None.

The arithmetic on them lives here once: the time inside a span's
intervals per request, or its host time (less the device's busy time
inside them), and the device idle time that falls inside the spans of
the program's public entries, per request and as a share of the
window's."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .timeline import Timeline, covered, gaps, union

#: the spans of the program's public entries; the rest are stages inside them
ENTRIES = (
    "fastdnn.score",
    "fastdnn.score_device",
    "fastdnn.score_masked",
    "fastdnn.lazy.until_output",
    "fastdnn.lazy.frame",
)


def intervals(tl: Timeline, names) -> np.ndarray:
    """The union of the host spans named in `names`, clipped to the
    window, [m, 2]."""
    a, b = tl.window
    return union([(max(s, a), min(e, b)) for s, e, name in tl.host
                  if name in names and e > a and s < b])


def _per_request(tl: Optional[Timeline], name: str, less_busy: bool) -> Optional[float]:
    if tl is None or not tl.requests:
        return None
    spans = intervals(tl, (name,))
    if not len(spans):
        return None
    inside = spans[:, 1] - spans[:, 0]
    if less_busy:
        inside = inside - covered(tl.busy(), spans[:, 0], spans[:, 1])
    return 1e3 * float(inside.sum()) / len(tl.requests)


def ms_per_request(tl: Optional[Timeline], name: str) -> Optional[float]:
    """ms inside the spans `name` per traced request, the device's work
    under them included: the span of a call that launches and does not
    wait.  None without a trace, a request or such a span."""
    return _per_request(tl, name, less_busy=False)


def host_ms_per_request(tl: Optional[Timeline], name: str) -> Optional[float]:
    """Host ms inside the spans `name` per traced request: the time inside
    them less the device's busy time inside them, as the harness's
    entry.host_ms_per_request.lazy reads a request, so that the stages of
    one request add up like for like.  None without a trace, a request or
    such a span."""
    return _per_request(tl, name, less_busy=True)


def _idle_in_entries(tl: Optional[Timeline]):
    """(seconds of device idle time inside a public entry's span, seconds
    of the window's device idle time); None without a trace, an entry's
    span or idle time."""
    if tl is None:
        return None
    entries = intervals(tl, ENTRIES)
    idle = gaps(tl.busy(), tl.window)
    if not len(entries) or not len(idle):
        return None
    inside = covered(entries, idle[:, 0], idle[:, 1]).sum()
    return float(inside), float((idle[:, 1] - idle[:, 0]).sum())


def idle_in_entries_ms_per_request(tl: Optional[Timeline]) -> Optional[float]:
    """ms of device idle time inside a public entry's span per traced
    request: the device waiting on the program, not on its caller.  None
    without a trace, a request, an entry's span or idle time."""
    split = _idle_in_entries(tl)
    if split is None or not tl.requests:
        return None
    return 1e3 * split[0] / len(tl.requests)


def idle_in_entries_pct(tl: Optional[Timeline]) -> Optional[float]:
    """The share of the window's device idle time that falls inside a
    public entry's span, in %: the rest fell in the caller's code.  None
    without a trace, an entry's span or idle time."""
    split = _idle_in_entries(tl)
    if split is None:
        return None
    return 100.0 * split[0] / split[1]
