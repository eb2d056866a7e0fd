"""What every closed-loop caller shares.  A caller drives one public entry
of the program; each lives in entries/<entry>.py, found by the name a
traffic mix gives under "entry", and exposes its class as `CALLER`.  One
caller waits for each result before it sends the next request, as a
decoder does; the window runs until the first request that ends past its
length, so every request counted has completed.

A caller has:

  warm()                  every shape the traffic will use, before the window
  run(seconds, span)      the window -> [Request], each request inside `span()`
  distances(reference)    once the program is freed, its kept answers'
                          distances from the reference (reference/compare.py)

Each request records its host-clock span and counters of the work it
asked for, which the metrics read (the net module's `work`, spec.net):
  frames          frames whose posteriors it returned (audio seconds)
  hidden_frames   frames it sent through the input layer and the trunk
  output_frames   frames it sent through the dense output layer
  lazy_active     active senones of the one frame it scored lazily

Answers kept on the host are copied into buffers made before the window,
so that holding them leaves the host's allocator as the program alone
would use it.
"""

from __future__ import annotations

import sys
import traceback
from typing import NamedTuple

import numpy as np
import torch


class Request(NamedTuple):
    start: float
    end: float
    ok: bool
    counts: dict


class Caller:
    def __init__(self, scorer, traffic, device, output_dim: int):
        self.scorer = scorer
        self.traffic = traffic
        self.device = torch.device(device)
        self.event = torch.cuda.Event() if self.device.type == "cuda" else None
        self.answers: dict = {}
        self._reported = False
        # host answers' buffers, written through before the window
        self._buffers = {i: np.ones((len(traffic.utterances[i]), output_dim), np.float32)
                         for i in sorted(traffic.kept)}

    def _wait(self) -> None:
        """Block until the device has finished what was queued so far."""
        if self.event is not None:
            self.event.record()
            self.event.synchronize()

    def _failed(self) -> None:
        """A request raised: it counts as failed; the first traceback goes
        to stderr."""
        if not self._reported:
            traceback.print_exc(file=sys.stderr)
            self._reported = True

    def release(self) -> None:
        """Drop the program's state, so the reference has the memory."""
        self.scorer = None

    def _buckets(self) -> list:
        """One pool index per distinct 128-frame bucket of the pool, from
        the shortest bucket to the longest: every seed warms the same
        shapes in the same order."""
        seen = {}
        for i, u in enumerate(self.traffic.utterances):
            seen.setdefault(-(-len(u) // 128), i)
        return [seen[b] for b in sorted(seen)]
