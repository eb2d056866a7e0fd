"""Multi-process serving: a coordinator/worker wrapper around the mesh
Scorer, the counterpart of fastdnn_tpu/parallel/service.py on
torch.distributed.

A mesh Scorer (`Scorer(mesh=...)`) is SPMD: every rank must make the same
calls with the same inputs, so a TCP request that reaches one process
cannot call it alone.  `MultiHostScorer` makes rank 0, the coordinator,
the only caller:

  * each scoring call on the coordinator first broadcasts a header of five
    int32 (op, rows, width, mask width, sequence number) to every rank,
    ships each rank its rows of the batch, then every rank runs its share
    of the mesh programs and enters the gather of the posteriors;
  * the other ranks run `worker_loop()`, which blocks on the next header
    and mirrors the coordinator's calls;
  * a heartbeat thread broadcasts no-ops while idle, so that a worker's
    pending broadcast never reaches the process group's timeout;
  * `close()` broadcasts a stop op; `worker_loop` returns.

Control messages and payloads ride a gloo group of their own, made by every
rank when it constructs the scorer, so they are host tensors whatever
backend the mesh's collectives use.  Every header with its payload and its
gather, and every heartbeat, is sent under one lock, so the ranks see them
in the same order.

Payload: with `scatter=True` (the default) the coordinator sends each rank
only the rows of its data coordinate (`dist.scatter` on the control group;
the model ranks of one data row receive the same window, and the windows
are equal because frame counts are bucketed to frame_bucket x data).
`scatter=False` broadcasts the whole batch to every rank.  Weights never
move at call time: every rank builds its net from the same bytes.  The JAX
package ships the rows through its coordination service's key-value store
instead; torch has no public client of that store.

Failure model: a dead worker stalls the next collective (a hung collective
cannot be cancelled), or, on gloo, makes it raise when the peer's socket
closes.  `call_timeout_s` arms a watchdog around every coordinated call,
whose clock starts once the call holds the lock.  On expiry, or when a
collective of the call raises, the scorer marks itself closed and raises
RuntimeError; later calls fail fast, and supervisors restart every process.
First-of-its-kind calls (per program and bucketed shape) get the larger
`first_call_timeout_s` (they build the kernels and warm the allocator).  On
expiry a best-effort OP_STOP is queued behind the abandoned call from a
daemon thread, so the workers of a pod that was merely slow leave their
loops.  Workers log and re-raise a failure of their own (`worker_loop`).

With one process the wrapper is inert and behaves exactly like
`Scorer(mesh=...)`, so a CLI can always construct it.

LazyContext over several processes is a coordinator-side shim
(`_MultiHostLazyContext`) that routes each frame through the coordinated
masked program: no device state is kept across calls and no protocol op is
added.  For throughput use `score_masked` batch-wise.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import EngineConfig
from ..engine.scorer import Scorer
from ..quant.quantize import QuantizedNet
from .mesh import gather_blocks, local_cols, local_rows, mesh_shape

OP_STOP, OP_NOOP, OP_SCORE, OP_MASKED = 0, 1, 2, 3

_log = logging.getLogger(__name__)


def _broadcast(x: np.ndarray, group) -> np.ndarray:
    """Rank 0's `x` on every rank of `group` (gloo: a host array)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    dist.broadcast(t, src=0, group=group)
    return t.numpy()


class MultiHostScorer(Scorer):
    """Scorer over a multi-process mesh with coordinator-side distribution.

    Construct identically on every rank (same net bytes, same config, same
    mesh, each rank on its own `device`); call `worker_loop()` on ranks
    other than 0; use the normal Scorer API on rank 0.  A coordinated call
    returns the whole posteriors on the coordinator (score_device too, as a
    host tensor under gloo).

    scatter: ship each rank only its data rows (default); False = the
        whole batch to every rank.
    call_timeout_s: watchdog for coordinated calls; on expiry the scorer
        closes itself and raises.  None = wait forever.
    first_call_timeout_s: the watchdog's allowance for every first call of
        its kind, one per (program, bucketed shape).  Defaults to
        max(call_timeout_s, 300); ignored when call_timeout_s is None.
    """

    def __init__(
        self,
        net: QuantizedNet,
        config: Optional[EngineConfig] = None,
        mesh=None,
        *,
        device="cuda",
        heartbeat_s: float = 5.0,
        scatter: bool = True,
        call_timeout_s: Optional[float] = None,
        first_call_timeout_s: Optional[float] = None,
    ):
        if mesh is None:
            raise ValueError("MultiHostScorer requires a mesh")
        super().__init__(net, config, device=device, mesh=mesh)
        self._multi = dist.get_world_size() > 1
        self.is_coordinator = dist.get_rank() == 0
        self._closed = False
        self._hb_thread: Optional[threading.Thread] = None
        self._call_timeout_s = call_timeout_s
        if first_call_timeout_s is None and call_timeout_s is not None:
            first_call_timeout_s = max(call_timeout_s, 300.0)
        self._first_call_timeout_s = first_call_timeout_s
        # (program, shape) keys whose call completed once
        self._warm_keys: set = set()
        self._ctl = None  # the control group
        if not self._multi:
            return
        self._scatter = scatter
        self._seq = 0
        # every header with its payload and gather is serialized: the
        # heartbeat and concurrent callers may not interleave collectives
        self._bcast_lock = threading.Lock()
        self._ctl = dist.new_group(backend="gloo")
        # each global rank's data coordinate: the rows it is sent
        self._data_coord = [0] * dist.get_world_size()
        for d, ranks in enumerate(mesh.mesh.tolist()):
            for r in ranks:
                self._data_coord[r] = d
        if self.is_coordinator and heartbeat_s > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat, args=(heartbeat_s,), daemon=True
            )
            self._hb_thread.start()

    # -- coordinator side: the Scorer's hooks -----------------------------------

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        if self._multi:  # batches leave the coordinator through the host
            return torch.from_numpy(np.ascontiguousarray(array))
        return super()._to_device(array)

    def _run(self, frames: torch.Tensor) -> torch.Tensor:
        if not self._multi:
            return super()._run(frames)
        return self._coordinated(OP_SCORE, frames)

    def _run_masked(self, frames: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        if not self._multi:
            return super()._run_masked(frames, masks)
        return self._coordinated(OP_MASKED, frames, masks)

    def _finish(self, out: torch.Tensor, n: int) -> np.ndarray:
        if not self._multi:
            return super()._finish(out, n)
        return out[:n].float().numpy()  # gathered inside the coordinated call

    # -- payload distribution ---------------------------------------------------

    def _ship(self, x: torch.Tensor) -> torch.Tensor:
        """Coordinator: send every rank its rows of the batch `x` (scatter)
        or all of it (broadcast); returns this rank's rows."""
        if not self._scatter:
            dist.broadcast(x, src=0, group=self._ctl)
            return local_rows(x, self.mesh)
        rows = x.shape[0] // mesh_shape(self.mesh)[0]
        chunks = [x[d * rows:(d + 1) * rows].contiguous() for d in self._data_coord]
        mine = torch.empty_like(chunks[0])
        dist.scatter(mine, chunks, src=0, group=self._ctl)
        return mine

    def _recv(self, shape, dtype) -> torch.Tensor:
        """Worker: this rank's rows of a batch of `shape`."""
        if not self._scatter:
            x = torch.empty(shape, dtype=dtype)
            dist.broadcast(x, src=0, group=self._ctl)
            return local_rows(x, self.mesh)
        mine = torch.empty((shape[0] // mesh_shape(self.mesh)[0], *shape[1:]), dtype=dtype)
        dist.scatter(mine, None, src=0, group=self._ctl)
        return mine

    def _execute(self, frames: torch.Tensor, masks: Optional[torch.Tensor]) -> torch.Tensor:
        """Every rank: its share of the mesh programs on its rows (and its
        mask columns), then the gather every rank enters -> the whole
        posteriors [rows, output_dim]."""
        with torch.inference_mode():  # per thread: the watchdog runs calls on its own
            frames = frames.to(self.device)
            if masks is not None:
                masks = local_cols(masks.to(self.device), self.mesh)
            out = self._run_local(frames, masks)
            return gather_blocks(out, self.mesh)[:, : self._output_dim]

    # -- coordinator side ---------------------------------------------------------

    def _with_watchdog(self, fn, key=None):
        """Run fn(locked); if the call timeout elapses first, declare the
        pod dead.

        `fn` receives a threading.Event and must set it the moment it holds
        `_bcast_lock`: the timeout clock starts only then.  Concurrent
        callers are supported (the lock serializes them), so time spent
        queued behind another healthy call does not count; while queued,
        the caller polls `_closed`, so a pod declared dead by the call
        ahead of it fails fast instead of waiting out its own timer.

        A call whose (program, shape) `key` has not completed before gets
        first_call_timeout_s, repeat calls call_timeout_s.  A hung
        collective cannot be cancelled: the runner thread is abandoned
        (daemon), the scorer closes, and a best-effort OP_STOP is sent from
        another daemon thread once the lock frees, so the workers of a pod
        that was merely slow leave their loops; if a worker is truly dead
        that stop hangs too, but only inside the abandoned thread.
        """
        if self._call_timeout_s is None:
            return fn(None)
        warm = key in self._warm_keys
        timeout = self._call_timeout_s if warm else self._first_call_timeout_s
        result: list = [None]
        error: list = [None]
        locked = threading.Event()

        def run():
            try:
                result[0] = fn(locked)
            except BaseException as e:  # surfaced to the caller below
                error[0] = e
            finally:
                locked.set()  # unblock the caller on a failure before the lock too

        t = threading.Thread(target=run, daemon=True)
        t.start()
        while not locked.wait(0.25):  # the untimed queueing phase
            if self._closed:
                raise RuntimeError(
                    "MultiHostScorer was closed while this call was queued "
                    "behind another (pod declared dead or workers released)"
                )
        t.join(timeout)
        if t.is_alive():
            self._closed = True

            def _stop_when_drained():
                # the lock orders this after the abandoned call's collectives
                lock = getattr(self, "_bcast_lock", None)
                if lock is None:  # one process: nothing to release
                    return
                with lock:
                    _broadcast(np.array([OP_STOP, 0, 0, 0, 0], np.int32), self._ctl)

            threading.Thread(target=_stop_when_drained, daemon=True).start()
            raise RuntimeError(
                f"multi-process scoring call did not complete within {timeout}s: "
                "a worker process is likely dead and the collectives cannot make "
                "progress; restart all processes"
            )
        if error[0] is not None:
            raise error[0]
        self._warm_keys.add(key)
        return result[0]

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                "MultiHostScorer is closed (workers released or pod declared dead)"
            )

    def _coordinated(self, op: int, frames: torch.Tensor,
                     masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One coordinated call: header, payload, every rank's programs and
        the gather -> the whole posteriors [rows, output_dim] on the host."""
        if not self.is_coordinator:
            raise RuntimeError(
                "scoring calls are coordinator-only on a multi-process mesh; "
                "the other ranks run worker_loop()"
            )
        frames = frames.float().cpu().contiguous()
        masks = None if masks is None else masks.to(torch.uint8).cpu().contiguous()
        width = 0 if masks is None else masks.shape[1]
        header = np.array([op, frames.shape[0], frames.shape[1], width, 0], np.int32)

        def call(locked=None):
            self._check_open()  # fail fast: the lock may be held by a hung call
            with self._bcast_lock:
                if locked is not None:
                    locked.set()  # the watchdog's clock starts here
                self._check_open()
                self._seq += 1
                header[4] = self._seq
                try:
                    _broadcast(header, self._ctl)
                    local_frames = self._ship(frames)  # in worker_loop's order
                    local_masks = None if masks is None else self._ship(masks)
                    return self._execute(local_frames, local_masks).cpu()
                except Exception as e:
                    # a collective failed (gloo raises when a peer's socket
                    # closes): the ranks are out of step for good
                    self._closed = True
                    raise RuntimeError(
                        f"multi-process scoring call failed ({type(e).__name__}: {e}); "
                        "a worker process is likely dead; restart all processes"
                    ) from e

        kind = ("score",) if masks is None else ("masked", width)
        return self._with_watchdog(call, kind + tuple(frames.shape))

    def _heartbeat(self, interval: float) -> None:
        def beat(locked=None):
            with self._bcast_lock:
                if locked is not None:
                    locked.set()  # the watchdog's clock starts here
                if self._closed:
                    return
                _broadcast(np.array([OP_NOOP, 0, 0, 0, 0], np.int32), self._ctl)

        while not self._closed:
            time.sleep(interval)
            if self._closed:
                return
            try:
                # under the same watchdog as scoring calls: a beat hung on a
                # dead worker holds the lock, and the watchdog declares the
                # pod dead so that queued calls fail fast
                self._with_watchdog(beat, ("heartbeat",))
            except Exception:
                if self._closed:
                    return  # pod declared dead (by this beat or a queued call)
                # a transient failure with the scorer open must not stop the
                # heartbeat: the workers' pending broadcast would time out
                _log.warning("multi-process heartbeat broadcast failed; retrying",
                             exc_info=True)

    def close(self) -> None:
        """Coordinator: release the workers (broadcast stop)."""
        if not self._multi or not self.is_coordinator or self._closed:
            self._closed = True
            return
        with self._bcast_lock:
            self._closed = True
            _broadcast(np.array([OP_STOP, 0, 0, 0, 0], np.int32), self._ctl)

    # -- worker side ----------------------------------------------------------------

    def worker_loop(self) -> None:
        """Ranks other than 0: mirror the coordinator's calls until stop.

        A failure here is fatal for the pod (the coordinator's next
        collective fails or hangs against this rank), so it is logged and
        re-raised; supervisors treat a worker exit without a stop op as a
        pod restart."""
        if not self._multi:
            return
        if self.is_coordinator:
            raise RuntimeError("worker_loop is for ranks other than 0")
        try:
            while True:
                op, n, d, m, _ = _broadcast(np.zeros(5, np.int32), self._ctl)
                if op == OP_STOP:
                    return
                if op == OP_NOOP:
                    continue
                frames = self._recv((n, d), torch.float32)
                masks = self._recv((n, m), torch.uint8) if op == OP_MASKED else None
                self._execute(frames, masks)
        except Exception:
            _log.exception(
                "multi-process scoring worker %d died; the collectives cannot make "
                "progress; restart all processes", dist.get_rank(),
            )
            raise

    # -- lazy API over several processes ----------------------------------------------

    def new_lazy_context(self, input_vector_count: int):
        """LazyContext over a multi-process mesh: coordinator-only; each
        frame routes through the coordinated masked program, so the workers
        keep running worker_loop()."""
        if self._multi:
            if not self.is_coordinator:
                raise RuntimeError(
                    "LazyContext is coordinator-only on a multi-process mesh; the "
                    "other ranks run worker_loop()"
                )
            return _MultiHostLazyContext(self, input_vector_count)
        return super().new_lazy_context(input_vector_count)


class _MultiHostLazyContext:
    """Frame-by-frame lazy scoring over several processes, the same surface
    as engine.scorer.LazyContext: each `calculate_for_output_nodes(mask)`
    scores one frame through the coordinated masked program, recomputing
    the trunk for it instead of keeping sharded activations (which would
    need every per-frame device step mirrored in the worker protocol).
    Exact: the same masked program as the batch path."""

    def __init__(self, scorer: MultiHostScorer, input_vector_count: int):
        self._scorer = scorer
        self.input_vector_count = input_vector_count
        self.current_vector_index = 0
        self._frames: Optional[np.ndarray] = None

    def calculate_until_output(self, frames) -> None:
        frames = np.asarray(frames, dtype=np.float32)
        if frames.shape[0] != self.input_vector_count:
            raise ValueError(
                f"expected {self.input_vector_count} frames, got {frames.shape[0]}"
            )
        self._frames = frames
        self.current_vector_index = 0  # the context is reusable across utterances

    def calculate_for_output_nodes(self, mask) -> np.ndarray:
        """Posteriors f32 [out] for the next frame given its active-node mask."""
        if self._frames is None:
            raise RuntimeError("call calculate_until_output first")
        i = self.current_vector_index
        if i >= self.input_vector_count:
            raise IndexError("all frames already consumed")
        mask = (np.asarray(mask).reshape(1, -1) != 0).astype(np.uint8)
        out = self._scorer.score_masked(self._frames[i : i + 1], mask)
        self.current_vector_index += 1
        return out[0]
