"""What a run hands the metric readers (metrics/<name>.py): the cell, its
configuration and traffic mix, the set-up time, every request of the
window, and, in a traced run, the window's timeline.

A reader is a module with `read(run) -> float | None`; None means it found
nothing to read in this cell, and the metric is left out of the result."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .timeline import Timeline


@dataclass
class Run:
    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    #: caller.Request, in order
    requests: list
    timeline: Optional[Timeline] = None
