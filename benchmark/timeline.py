"""The traced window as intervals: the requests the benchmark made (its own
`bench.request` spans), the device's operations (kernels, copies, fills)
and the host's operations on the thread that made the requests, all on the
profiler's clock, in seconds.

The arithmetic on them lives here once: the union of the device's
intervals (its busy time), the time it covers inside a span, the idle gaps
between them, and which host operation each gap fell in.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import kernel_table

REQUEST_SPAN = "bench.request"


@dataclass
class Timeline:
    #: (start, end) of the traced window: the first request's start to the
    #: last one's end
    window: tuple[float, float]
    #: request spans [(start, end, counters)], in order
    requests: list = field(default_factory=list)
    #: device operations [(start, end, symbol)], sorted by start
    device: list = field(default_factory=list)
    #: host operations on the requesting thread [(start, end, name)]
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> np.ndarray:
        """The union of the device's intervals inside the window, [m, 2]."""
        a, b = self.window
        spans = [(max(s, a), min(e, b)) for s, e, _ in self.device if e > a and s < b]
        return union(spans)

    def busy_s(self) -> float:
        merged = self.busy()
        return float((merged[:, 1] - merged[:, 0]).sum()) if len(merged) else 0.0


def union(spans) -> np.ndarray:
    """Merge intervals [(start, end)] into disjoint sorted ones, [m, 2]."""
    if not len(spans):
        return np.zeros((0, 2))
    arr = np.asarray(spans, dtype=np.float64)
    arr = arr[np.argsort(arr[:, 0], kind="stable")]
    reach = np.maximum.accumulate(arr[:, 1])
    first = np.ones(len(arr), dtype=bool)
    first[1:] = arr[1:, 0] > reach[:-1]
    idx = np.flatnonzero(first)
    return np.stack([arr[idx, 0], np.maximum.reduceat(arr[:, 1], idx)], axis=1)


def covered(merged: np.ndarray, starts, ends) -> np.ndarray:
    """Seconds of each span [starts[i], ends[i]] that the disjoint sorted
    intervals `merged` cover."""
    starts, ends = np.asarray(starts, np.float64), np.asarray(ends, np.float64)
    if not len(merged):
        return np.zeros_like(starts)
    lo, hi = merged[:, 0], merged[:, 1]
    before = np.concatenate(([0.0], np.cumsum(hi - lo)))

    def busy_until(x):
        i = np.searchsorted(lo, x, side="right")  # intervals that start at or before x
        j = np.maximum(i - 1, 0)
        return np.where(i > 0, before[j] + np.clip(x - lo[j], 0.0, hi[j] - lo[j]), 0.0)

    return np.maximum(busy_until(ends) - busy_until(starts), 0.0)


def gaps(merged: np.ndarray, window: tuple[float, float]) -> np.ndarray:
    """The idle intervals of the window between the busy ones, [g, 2]."""
    edges = np.concatenate(([window[0]], np.asarray(merged, np.float64).ravel(), [window[1]]))
    pairs = edges.reshape(-1, 2)
    return pairs[pairs[:, 1] > pairs[:, 0]]


def innermost(host, points) -> list:
    """For each point (ascending), the name of the innermost host operation
    that covers it, or None.  Host operations on one thread nest."""
    order = sorted(host, key=lambda h: (h[0], -h[1]))
    stack: list = []
    out = []
    j = 0
    for p in points:
        while j < len(order) and order[j][0] <= p:
            while stack and stack[-1][1] < order[j][0]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def breakdown(tl: Timeline, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by the
    host operation it fell in: {"device_ops": [[name, s]], "idle_gaps":
    [[name, s]]}, at most `top` each."""
    ops: dict = defaultdict(float)
    a, b = tl.window
    for s, e, symbol in tl.device:
        if e > a and s < b:
            ops[kernel_table.op_name(symbol)] += min(e, b) - max(s, a)
    idle = gaps(tl.busy(), tl.window)
    by_host: dict = defaultdict(float)
    mids = (idle[:, 0] + idle[:, 1]) / 2 if len(idle) else []
    for (s, e), name in zip(idle, innermost(tl.host, mids)):
        by_host[name or "(no host operation)"] += e - s
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(by_host)}


def from_profiler(prof, counters: list) -> Optional[Timeline]:
    """A stopped torch.profiler run -> Timeline; `counters` are the
    requests' counters in order, matched to the REQUEST_SPAN spans.  Reads
    the profiler's raw events (building its event tree costs minutes on a
    window of small requests).  None when the trace holds no request span
    or not one per request."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    base = results.trace_start_ns()  # in whole ns, so that float seconds keep ns
    spans, device, host = [], [], []
    for ev in results.events():
        s = (ev.start_ns() - base) * 1e-9
        e = s + ev.duration_ns() * 1e-9
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name == REQUEST_SPAN:
                spans.append((s, e, ev.start_thread_id()))
            host.append((s, e, name, ev.start_thread_id()))
        elif not name.startswith("bench."):  # the spans' own device-side copies
            device.append((s, e, name))
    if not spans or len(spans) != len(counters):
        return None
    spans.sort()
    thread = spans[0][2]
    device.sort()
    return Timeline(
        window=(spans[0][0], spans[-1][1]),
        requests=[(s, e, c) for (s, e, _), c in zip(spans, counters)],
        device=device,
        host=[(s, e, n) for s, e, n, t in host if t == thread],
    )
