"""Streaming scorer: cross-utterance batching with a pipelined device path,
the counterpart of fastdnn_tpu/engine/stream.py.

Any number of producer threads submit utterances; one worker thread packs
them into frame batches of at most `max_batch_frames` (padded to the
scorer's frame bucket), scores each batch in one pass and resolves a
`Future` per utterance with its rows of the posteriors.  Frames of distinct
utterances are independent (a pure MLP over spliced features), which is
what makes cross-utterance packing sound: each row's arithmetic does not
depend on its batch neighbours, so a packed utterance gets the posteriors a
serial `Scorer.score` would give it.

On the card the overlap that JAX's asynchronous dispatch gave for free is
built explicitly, with three CUDA streams:

  * batch N+1 is assembled into one of two pinned host buffers (a buffer is
    rewritten only after the event of its last upload) and copied to the
    card with `non_blocking=True` on a copy stream;
  * the compute stream waits on that copy's event and runs the kernels;
  * a download stream waits on the compute stream and copies the
    posteriors into a pinned host tensor (PyTorch's pinned caching
    allocator, so a tensor whose rows a caller still holds is never
    reused), behind an event; a batch's futures resolve only after it.

The worker keeps the newest batch in flight while it resolves older ones,
so assembly and the host side of batch N+1 overlap batch N's kernels.  On
a CPU scorer (the caller's choice, not a fallback) every batch is scored
in place, with no pinned memory and no streams.  So is every batch of the
coordinator of a multi-process `MultiHostScorer` (parallel.service): its
coordinated call ships the batch to the ranks through the host, which no
side-stream upload can carry.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import List, Optional

import numpy as np
import torch

from ..utils.timer import Throughput
from . import lazy as _lazy
from .scorer import Scorer

__all__ = ["StreamingScorer"]


class _Item:
    __slots__ = ("frames", "masks", "future")

    def __init__(self, frames, masks, future):
        self.frames = frames
        self.masks = masks
        self.future = future


_CLOSE = object()


def _settle(future: Future, result=None, error: Optional[BaseException] = None) -> None:
    """Resolve a future unless its waiter cancelled it (a cancelled future
    refuses a result; that must not reach the worker)."""
    try:
        if error is not None:
            future.set_exception(error)
        else:
            future.set_result(result)
    except InvalidStateError:
        pass


class _Slot:
    """One of the two pinned host buffers a batch is assembled in, with the
    event recorded after its upload."""

    def __init__(self, rows: int, input_dim: int):
        self.frames = torch.empty((rows, input_dim), dtype=torch.float32, pin_memory=True)
        self.masks: Optional[torch.Tensor] = None
        self.index: Optional[torch.Tensor] = None
        self.uploaded = torch.cuda.Event()

    def mask_buffer(self, width: int) -> torch.Tensor:
        if self.masks is None:
            self.masks = torch.empty((self.frames.shape[0], width), dtype=torch.uint8,
                                     pin_memory=True)
        return self.masks

    def index_buffer(self, capacity: int) -> torch.Tensor:
        if self.index is None:
            self.index = torch.empty(capacity, dtype=torch.int32, pin_memory=True)
        return self.index


class StreamingScorer:
    """Batches utterances across submitters and scores them in one stream.

    Usage:
        ss = StreamingScorer(scorer)
        fut = ss.submit(frames)              # frames [n, dim] float32
        fut = ss.submit(frames, masks)       # lazy path, masks [n, out]
        posteriors = fut.result()            # [n, out] float32
        ss.close()

    Thread-safe; any number of threads may submit.  Masked and unmasked
    submissions are batched in separate groups (they run different
    kernels).  `throughput` exposes rolling frames/s / audio-s/s.  The
    scorer is a single-device one or the coordinator (rank 0) of a
    MultiHostScorer: every rank of a plain mesh Scorer must make the same
    calls, which one worker thread on one rank cannot.
    """

    def __init__(
        self,
        scorer: Scorer,
        *,
        max_batch_frames: int = 8192,
        max_wait_ms: float = 3.0,
        max_queue: int = 1024,
    ):
        if max_batch_frames < 1:
            raise ValueError("max_batch_frames must be >= 1")
        if getattr(scorer, "context", None) is not None:
            from .tdnnf import refuse

            raise refuse("StreamingScorer")
        if scorer.mesh is not None:
            from ..parallel.service import MultiHostScorer

            if not isinstance(scorer, MultiHostScorer):
                raise ValueError(
                    "StreamingScorer takes a single-device Scorer or the coordinator of a "
                    "MultiHostScorer, not a plain mesh Scorer: every rank of a mesh must "
                    "make the same calls, which one worker thread cannot"
                )
            if not scorer.is_coordinator:
                raise ValueError(
                    "StreamingScorer runs on the coordinator (rank 0) of a "
                    "MultiHostScorer; the other ranks run worker_loop()"
                )
        self._scorer = scorer
        self._max_frames = max_batch_frames
        self._max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self.throughput = Throughput()
        self._closed = False
        self._submit_lock = threading.Lock()
        self._carry: Optional[_Item] = None  # worker-private push-back slot
        self._pending: deque = deque()  # worker-private: dispatched groups, oldest first
        self._device = scorer.device
        # a multi-process coordinator's batches go through the host
        self._cuda = self._device.type == "cuda" and not getattr(scorer, "_multi", False)
        if self._cuda:
            if self._device.index is None:  # the worker sets its device by index
                self._device = torch.device("cuda", torch.cuda.current_device())
            # the weights were prepared on this thread's stream; the worker's
            # streams must find them complete
            torch.cuda.synchronize(self._device)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    @property
    def output_dim(self) -> int:
        """Senone count of the wrapped engine (wire-protocol mask width)."""
        return self._scorer.output_dim

    @property
    def input_dim(self) -> int:
        """Feature width of the wrapped engine."""
        return self._scorer.input_dim

    # -- producer side -------------------------------------------------------

    def submit(self, frames, masks=None) -> "Future[np.ndarray]":
        """Enqueue one utterance; returns a Future of posteriors [n, out]."""
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("StreamingScorer is closed")
            return self._submit_locked(frames, masks)

    def _submit_locked(self, frames, masks) -> "Future[np.ndarray]":
        frames = np.ascontiguousarray(frames, dtype=np.float32)
        if frames.ndim != 2:
            raise ValueError(f"frames must be [n, dim], got {frames.shape}")
        if frames.shape[1] > self.input_dim:
            raise ValueError(
                f"input vector size {frames.shape[1]} must be <= network input size "
                f"{self.input_dim}"
            )
        if frames.shape[0] > self._max_frames:
            raise ValueError(
                f"utterance of {frames.shape[0]} frames exceeds "
                f"max_batch_frames={self._max_frames}; split it"
            )
        if masks is not None:
            masks = (np.asarray(masks) != 0).astype(np.uint8)
            if masks.shape != (frames.shape[0], self.output_dim):
                raise ValueError(
                    f"masks must be [{frames.shape[0]}, {self.output_dim}]"
                )
        fut: "Future[np.ndarray]" = Future()
        self._q.put(_Item(frames, masks, fut))
        return fut

    def close(self, wait: bool = True) -> None:
        """Stop accepting work; drain the queue (if wait) and join."""
        with self._submit_lock:
            if self._closed:
                return
            # under the lock no submit() can slip an item behind the
            # sentinel, so everything enqueued before close() is processed
            self._closed = True
            self._q.put(_CLOSE)
        if wait:
            self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- consumer side --------------------------------------------------------

    def _take_group(self) -> Optional[List[_Item]]:
        """Collect compatible items (same masked-ness) up to max_batch_frames,
        waiting at most max_wait for stragglers after the first arrival.

        Push-backs (an incompatible/overflowing item, or the close sentinel)
        go to the worker-private slot, never back onto the shared queue,
        which could block forever when producers keep it full (the worker is
        the only consumer)."""
        if self._carry is not None:
            first, self._carry = self._carry, None
        else:
            first = self._q.get()
        if first is _CLOSE:
            return None
        group = [first]
        total = first.frames.shape[0]
        masked = first.masks is not None
        deadline = time.perf_counter() + self._max_wait
        while total < self._max_frames:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is _CLOSE:
                self._carry = _CLOSE  # re-deliver for the outer loop
                break
            if (item.masks is not None) != masked or (
                total + item.frames.shape[0] > self._max_frames
            ):
                # incompatible or overflowing: carry over, dispatch now
                self._carry = item
                break
            group.append(item)
            total += item.frames.shape[0]
        return group

    def _run(self) -> None:
        try:
            self._serve()
        except BaseException as e:
            self._abandon(e)
            raise

    def _abandon(self, error: BaseException) -> None:
        """The worker failed outside a batch's dispatch: refuse new work and
        fail every future still waiting, so no caller waits on a worker that
        is gone.  The queue is drained before taking the submit lock (a
        producer may hold it while blocked on a full queue) and again after."""
        for group, _ in self._pending:
            for it in group:
                _settle(it.future, error=error)
        if isinstance(self._carry, _Item):
            _settle(self._carry.future, error=error)
        self._fail_queued(error)
        with self._submit_lock:
            self._closed = True
        self._fail_queued(error)

    def _fail_queued(self, error: BaseException) -> None:
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not _CLOSE:
                _settle(item.future, error=error)

    def _serve(self) -> None:
        # the current device, the streams and inference mode are per thread
        if self._cuda:
            torch.cuda.set_device(self._device)
            rows = self._scorer._bucket(self._max_frames)
            self._slots = [_Slot(rows, self.input_dim) for _ in range(2)]
            self._copy_stream = torch.cuda.Stream(self._device)
            self._download_stream = torch.cuda.Stream(self._device)
            compute = torch.cuda.Stream(self._device)
            with torch.cuda.stream(compute), torch.inference_mode():
                self._loop()
        else:
            with torch.inference_mode():
                self._loop()

    def _loop(self) -> None:
        pending = self._pending
        slot = 0
        while True:
            group = self._take_group()
            if group is None:
                while pending:
                    self._resolve(*pending[0])
                    pending.popleft()
                return
            pending.append((group, None))
            try:
                handle = self._dispatch(group, slot)
            except Exception as e:  # delivered to every waiter of the group
                pending.pop()
                for it in group:
                    _settle(it.future, error=e)
                continue
            pending[-1] = (group, handle)
            slot ^= 1
            # the newest batch stays in flight while older ones resolve
            while len(pending) > 1 or (pending and self._q.empty()):
                self._resolve(*pending[0])
                pending.popleft()

    def _assemble(self, group: List[_Item], frames: np.ndarray, masks: Optional[np.ndarray]):
        """Write the group's frames (zero-padded to the input width) and
        masks (zero-padded to the scorer's mask width) into the batch
        buffers, rows past the group zero."""
        row = 0
        for it in group:
            n, dim = it.frames.shape
            frames[row:row + n, :dim] = it.frames
            frames[row:row + n, dim:] = 0
            if masks is not None:
                out = it.masks.shape[1]
                masks[row:row + n, :out] = it.masks
                masks[row:row + n, out:] = 0
            row += n
        frames[row:] = 0
        if masks is not None:
            masks[row:] = 0

    def _dispatch(self, group: List[_Item], slot: int):
        """Assemble, upload and launch one batch; returns the handle
        `_resolve` materializes: (host posteriors, event) on the card, the
        posteriors themselves on the CPU."""
        sc = self._scorer
        n = sum(it.frames.shape[0] for it in group)
        rows = sc._bucket(n)
        masked = group[0].masks is not None
        if self._cuda:
            buf = self._slots[slot]
            buf.uploaded.synchronize()  # this buffer's last upload is done
            frames = buf.frames[:rows]
            masks = buf.mask_buffer(sc._mask_width)[:rows] if masked else None
        else:
            frames = torch.empty((rows, sc.input_dim), dtype=torch.float32)
            masks = torch.empty((rows, sc._mask_width), dtype=torch.uint8) if masked else None
        self._assemble(group, frames.numpy(), None if masks is None else masks.numpy())
        index = None
        if masked and sc._use_gathered(masks.numpy()):
            idx, _ = _lazy.union_active_indices(masks.numpy(), sc._gather_capacity)
            index = buf.index_buffer(idx.shape[0]) if self._cuda else torch.empty(
                idx.shape[0], dtype=torch.int32)
            index.numpy()[:] = idx
        if not self._cuda:
            return self._compute(frames, masks, index)[:n].float().numpy()

        compute = torch.cuda.current_stream(self._device)
        with torch.cuda.stream(self._copy_stream):
            frames, masks, index = (
                None if t is None else t.to(self._device, non_blocking=True)
                for t in (frames, masks, index)
            )
            buf.uploaded.record()
        compute.wait_event(buf.uploaded)
        for t in (frames, masks, index):
            if t is not None:
                t.record_stream(compute)  # allocated on the copy stream, read on compute
        out = self._compute(frames, masks, index)
        if out.dtype != torch.float32:
            out = out.float()  # bf16 posteriors (fast_posteriors) widened on the card
        self._download_stream.wait_stream(compute)
        with torch.cuda.stream(self._download_stream):
            host = torch.empty((n, out.shape[1]), dtype=torch.float32, pin_memory=True)
            host.copy_(out[:n], non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        out.record_stream(self._download_stream)
        return host, done

    def _compute(self, frames, masks, index) -> torch.Tensor:
        """Posteriors [rows, out] of a padded batch on the scorer's device:
        the dense path, or the masked one the scorer's lazy_mode selects
        (gathered when an index of the active union is given)."""
        sc = self._scorer
        if masks is None:
            return sc._run(frames)
        if index is not None:
            return sc._gathered(sc._hidden(frames), masks, index)
        return sc._run_masked(frames, masks)

    def _resolve(self, group: List[_Item], handle) -> None:
        """Materialize one batch's result and settle its futures.

        Materialization can raise (a device fault shows at the event), and
        a waiter may have cancelled its future; neither may kill the worker
        thread, which all other futures depend on."""
        try:
            if self._cuda:
                host, done = handle
                done.synchronize()
                arr = host.numpy()
            else:
                arr = handle
        except Exception as e:
            for it in group:
                _settle(it.future, error=e)
            return
        counts = [it.frames.shape[0] for it in group]
        self.throughput.add(int(sum(counts)))
        offsets = np.cumsum([0] + counts)
        for it, a, b in zip(group, offsets[:-1], offsets[1:]):
            _settle(it.future, arr[a:b])
