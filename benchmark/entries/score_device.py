"""`Scorer.score_device` on device-resident batches cycled from a ring
(traffic.batches); a request completes when a CUDA event recorded after
the call fires.  Each ring slot's last answer is kept for the comparison."""

import time

from benchmark.caller import Caller, Request
from benchmark.reference.compare import row_l1


class DeviceBatches(Caller):
    def warm(self) -> None:
        for batch in self.traffic.batches:
            self.scorer.score_device(batch)
        self._wait()

    def run(self, seconds: float, span) -> list:
        ring = self.traffic.batches
        counts = {"frames": ring[0].shape[0], "hidden_frames": ring[0].shape[0],
                  "output_frames": ring[0].shape[0]}
        requests = []
        deadline = time.perf_counter() + seconds
        i = 0
        while True:
            slot = i % len(ring)
            t0 = time.perf_counter()
            with span():
                try:
                    out = self.scorer.score_device(ring[slot])
                    self._wait()
                    ok = True
                except Exception:
                    ok = False
                    self._failed()
            t1 = time.perf_counter()
            if ok:
                self.answers[slot] = out
            requests.append(Request(t0, t1, ok, counts))
            i += 1
            if t1 >= deadline:
                return requests

    def distances(self, ref) -> list:
        out = []
        for slot in sorted(self.answers):
            out.append(row_l1(self.answers.pop(slot), ref.posteriors(self.traffic.batches[slot])))
        return out


CALLER = DeviceBatches
