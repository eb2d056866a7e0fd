"""`Scorer.score_device` on device-resident batches of chunks cycled from a
ring (traffic.batches, [chunks, L + T + R, in] each; inputs/chunks.py) for
a net with time context: each request returns the chain output [chunks,
T / f, N].  A request completes when a CUDA event recorded after the call
fires.  Each ring slot's last answer is kept for the comparison, row by
row over the raw outputs.

A request counts `frames` (the audio frames its outputs cover, T a chunk),
`chunks`, `context_frames` (the rows it computed outside the audio, L + R a
chunk) and `subsampled_rows` (its output rows, T / f a chunk), which the
net's `work` reads."""

import time

from benchmark.caller import Caller, Request
from benchmark.reference.compare import row_l1


class DeviceChunks(Caller):
    def warm(self) -> None:
        for batch in self.traffic.batches:
            self.scorer.score_device(batch)
        self._wait()

    def _counts(self) -> dict:
        chunks = self.traffic.batches[0].shape[0]
        frames = self.traffic.chunk_frames
        out_rows = len(range(0, frames, self.traffic.subsampling))
        return {"frames": chunks * frames, "chunks": chunks,
                "context_frames": chunks * sum(self.traffic.context),
                "subsampled_rows": chunks * out_rows}

    def run(self, seconds: float, span) -> list:
        ring = self.traffic.batches
        counts = self._counts()
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
            got = self.answers.pop(slot)
            want = ref.posteriors(self.traffic.batches[slot])
            out.append(row_l1(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])))
        return out


CALLER = DeviceChunks
