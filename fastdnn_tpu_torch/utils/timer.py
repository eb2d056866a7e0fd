"""Observability: throughput counters and a profiler scope, after
fastdnn_tpu/utils/timer.py.

  * `Throughput` — rolling audio-seconds/s and frames/s counters for serving
  * `trace` — context manager around torch.profiler, writing a Chrome trace
  * `Timer` — the plain wall-clock the reference used, for CLIs
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field

FRAMES_PER_AUDIO_SECOND = 100.0


class Timer:
    """Wall-clock timer, the reference engine's std::chrono timing (its dnn.cc:62-73)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False

    @property
    def ms(self) -> float:
        return self.elapsed * 1e3


@dataclass
class Throughput:
    """Rolling throughput counter for a scoring service.

    `batches` counts device dispatches, so frames/batches is the mean
    batch fill — the one number that says whether cross-utterance packing
    (engine/stream.py) is actually amortizing device calls under load.
    `add` takes a lock: the stream's worker adds while server threads read.
    """

    frames: int = 0
    batches: int = 0
    seconds: float = 0.0
    _t0: float = field(default_factory=time.perf_counter)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def add(self, n_frames: int) -> None:
        with self._lock:
            self.seconds = time.perf_counter() - self._t0
            self.frames += n_frames
            self.batches += 1

    def frames_per_s(self) -> float:
        return self.frames / self.seconds if self.seconds > 0 else 0.0

    def audio_seconds_per_s(self) -> float:
        return self.frames_per_s() / FRAMES_PER_AUDIO_SECOND

    def mean_batch_fill(self) -> float:
        """Mean frames per device dispatch (1 utterance = O(100) frames;
        fill >> one utterance's frames means packing is working)."""
        return self.frames / self.batches if self.batches else 0.0

    def reset(self) -> None:
        with self._lock:
            self.frames = 0
            self.batches = 0
            self.seconds = 0.0
            self._t0 = time.perf_counter()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler scope over the host and, where there is one, the card;
    writes `trace.json` (Chrome trace format: chrome://tracing or Perfetto)
    into `log_dir` and yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
