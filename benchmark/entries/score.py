"""`Scorer.score`: numpy frames in, numpy posteriors out, one utterance per
call, cycled from the pool (traffic.utterances).  Each kept utterance's
first answer is copied into its buffer for the comparison."""

import time

import numpy as np
import torch

from benchmark.caller import Caller, Request
from benchmark.reference.compare import row_l1


class HostUtterances(Caller):
    def warm(self) -> None:
        for i in self._buckets():
            self.scorer.score(self.traffic.utterances[i])

    def run(self, seconds: float, span) -> list:
        pool = self.traffic.utterances
        requests = []
        deadline = time.perf_counter() + seconds
        i = 0
        while True:
            idx = i % len(pool)
            n = len(pool[idx])
            t0 = time.perf_counter()
            with span():
                try:
                    res = self.scorer.score(pool[idx])
                    ok = True
                except Exception:
                    ok = False
                    self._failed()
            t1 = time.perf_counter()
            if ok and idx in self._buffers and idx not in self.answers:
                buf = self._buffers[idx]
                if res.shape == buf.shape:
                    np.copyto(buf, res)
                self.answers[idx] = buf if res.shape == buf.shape else res
            requests.append(Request(t0, t1, ok, {"frames": n, "hidden_frames": n,
                                                 "output_frames": n}))
            i += 1
            if t1 >= deadline:
                return requests

    def distances(self, ref) -> list:
        out = []
        for idx in sorted(self.answers):
            frames = torch.from_numpy(self.traffic.utterances[idx])
            out.append(row_l1(torch.from_numpy(self.answers[idx]), ref.posteriors(frames)))
        return out


CALLER = HostUtterances
