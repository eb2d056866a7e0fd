"""`Scorer.new_lazy_context(n)` per utterance, `calculate_until_output`
with its frames, then `calculate_for_output_nodes(mask)` frame by frame
(traffic.utterances, traffic.masks).  A request is one frame; the
utterance's first frame also counts the context and
`calculate_until_output`.  Each kept utterance's frames, up to where the
window closed, are copied into its buffer for the comparison."""

import time

import numpy as np
import torch

from benchmark.caller import Caller, Request
from benchmark.reference.compare import row_l1


class LazyContexts(Caller):
    def warm(self) -> None:
        for i in self._buckets():
            frames, masks = self.traffic.utterances[i], self.traffic.masks[i]
            ctx = self.scorer.new_lazy_context(len(frames))
            ctx.calculate_until_output(frames)
            for t in range(min(3, len(frames))):
                ctx.calculate_for_output_nodes(masks[t])

    def run(self, seconds: float, span) -> list:
        pool, pool_masks = self.traffic.utterances, self.traffic.masks
        active = [m.sum(axis=1, dtype=np.int64) for m in pool_masks]
        requests = []
        deadline = time.perf_counter() + seconds
        u = 0
        while True:
            idx = u % len(pool)
            frames, masks = pool[idx], pool_masks[idx]
            n = len(frames)
            keep = idx in self._buffers and idx not in self.answers
            done = 0
            for t in range(n):
                t0 = time.perf_counter()
                with span():
                    try:
                        if t == 0:
                            ctx = self.scorer.new_lazy_context(n)
                            ctx.calculate_until_output(frames)
                        p = ctx.calculate_for_output_nodes(masks[t])
                        ok = True
                    except Exception:
                        ok = False
                        self._failed()
                t1 = time.perf_counter()
                counts = {"frames": 1, "lazy_active": int(active[idx][t])}
                if t == 0:
                    counts["hidden_frames"] = n
                requests.append(Request(t0, t1, ok, counts))
                if keep and ok and done == t:
                    self._buffers[idx][t] = p
                    done += 1
                if t1 >= deadline:
                    break
            if keep and done:
                self.answers[idx] = done
            if t1 >= deadline:
                return requests
            u += 1

    def distances(self, ref) -> list:
        out = []
        for idx in sorted(self.answers):
            done = self.answers[idx]
            frames = torch.from_numpy(self.traffic.utterances[idx][:done])
            masks = torch.from_numpy(self.traffic.masks[idx][:done])
            program = torch.from_numpy(self._buffers[idx][:done])
            out.append(row_l1(program, ref.masked_posteriors(frames, masks)))
        return out


CALLER = LazyContexts
