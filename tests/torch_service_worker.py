"""One rank of the port's multi-process scorer, for tests/test_torch_service.py.

Started once per rank with torch.multiprocessing (spawn) by the test's
fixtures: the ranks join a gloo process group through a rendezvous file in
`workdir`, build a ("data", "model") mesh of CPU ranks and load the net and
inputs the test wrote there (`q.npz`, `inputs.npz`).  In mode "cases"
rank 0 coordinates a MultiHostScorer through every case, the 1-pass bf16
input layer (input_precision="default") among them (then serves it over
TCP through a StreamingScorer) while the other ranks run
`worker_loop()`; then every rank runs the plain SPMD `Scorer(mesh=...)`
and `make_gspmd_scorer` on the same inputs.  In mode "death" rank 1 dies
after its first call and rank 0 times what the watchdog reports.  Rank 0
writes `rank0.npz`; a failure is written to `rank<r>.err`.  It imports no
JAX: the test compares the results with the JAX package in its own process.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

SEMANTICS = ("reference", "active_only")
DEATH_TIMEOUT_S = 10.0


def _configs():
    """The MultiHostScorers both sides build, in order: (name, config kw,
    scatter)."""
    return [
        ("reference", {}, True),
        ("active_only", {"lazy_semantics": "active_only"}, True),
        ("broadcast", {}, False),
        ("bf16_input", {"input_precision": "default"}, True),
    ]


def _refused(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def _coordinate(name, sc, inputs, out) -> None:
    frames, masks = inputs["frames"], inputs["masks"]
    out[f"{name}_score"] = sc.score(frames)
    out[f"{name}_masked"] = sc.score_masked(frames, masks)
    if name != "reference":
        return
    ctx = sc.new_lazy_context(3)
    ctx.calculate_until_output(frames[:3])
    out["lazy_rows"] = np.stack([ctx.calculate_for_output_nodes(masks[i]) for i in range(3)])
    out["utterances"] = np.concatenate(
        sc.score_utterances([frames[:5], frames[5:13], frames[13:24]]))
    _serve(sc, inputs, out)


def _serve(sc, inputs, out) -> None:
    """A ScoreServer over a StreamingScorer over the coordinator, driven by
    a client over loopback TCP (masked and unmasked utterances)."""
    from fastdnn_tpu_torch import StreamingScorer
    from fastdnn_tpu_torch.cli.serve import ScoreClient, ScoreServer

    stream = StreamingScorer(sc, max_batch_frames=256, max_wait_ms=2.0)
    server = ScoreServer(("127.0.0.1", 0), stream)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = ScoreClient(*server.server_address[:2])
        frames, masks = inputs["frames"], inputs["masks"]
        for i, (lo, hi) in enumerate(((0, 9), (9, 26), (26, 31))):
            out[f"served{i}"] = client.score(frames[lo:hi])
        out["served_masked"] = client.score(frames[:9], masks[:9])
        out["served_output_dim"] = np.array(client.stats()["output_dim"])
        client.close()
    finally:
        server.shutdown()
        server.server_close()
        stream.close()
    thread.join(30)


def _spmd(q, mesh, inputs, out) -> None:
    """Every rank: the plain SPMD mesh Scorer and make_gspmd_scorer."""
    from fastdnn_tpu_torch import EngineConfig, Scorer, StreamingScorer
    from fastdnn_tpu_torch.parallel.sharded import make_gspmd_scorer

    frames, masks = inputs["frames"], inputs["masks"]
    for semantics in SEMANTICS:
        plain = Scorer(q, EngineConfig(lazy_semantics=semantics), device="cpu", mesh=mesh)
        out[f"plain_{semantics}_masked"] = plain.score_masked(frames, masks)
        out[f"plain_{semantics}_score"] = plain.score(frames)
    reference = Scorer(q, EngineConfig(), device="cpu", mesh=mesh)
    ctx = reference.new_lazy_context(3)
    ctx.calculate_until_output(frames[:3])
    out["plain_lazy_rows"] = np.stack([ctx.calculate_for_output_nodes(masks[i])
                                       for i in range(3)])
    out["stream_refuses_plain_mesh"] = np.array(_refused(lambda: StreamingScorer(plain)))
    bf16_input = Scorer(q, EngineConfig(input_precision="default"), device="cpu", mesh=mesh)
    out["plain_bf16_input_score"] = bf16_input.score(frames)
    out["plain_bf16_input_masked"] = bf16_input.score_masked(frames, masks)
    score, score_masked = make_gspmd_scorer(mesh)
    f, m = torch.from_numpy(frames), torch.from_numpy(masks)
    out["gspmd_score"] = score(q, f).numpy()
    out["gspmd_score_again"] = score(q, f).numpy()  # the prepared net, kept
    out["gspmd_masked"] = score_masked(q, f, m).numpy()
    score, _ = make_gspmd_scorer(mesh, input_precision="default")
    out["gspmd_bf16_input_score"] = score(q, f).numpy()


def _cases(rank, q, mesh, inputs) -> dict:
    from fastdnn_tpu_torch import EngineConfig, StreamingScorer
    from fastdnn_tpu_torch.parallel.service import MultiHostScorer

    out = {}
    for name, kw, scatter in _configs():
        sc = MultiHostScorer(q, EngineConfig(**kw), mesh, device="cpu", heartbeat_s=0.2,
                             scatter=scatter, call_timeout_s=60.0)
        if rank == 0:
            try:
                _coordinate(name, sc, inputs, out)
            finally:
                sc.close()
        else:
            if name == "reference":
                out["stream_refuses_worker"] = np.array(
                    _refused(lambda: StreamingScorer(sc)))
            sc.worker_loop()
    _spmd(q, mesh, inputs, out)
    return out


def _death(rank, q, mesh, inputs, work: Path) -> None:
    """Rank 1 dies after its first call; rank 0 reports how the failure
    surfaced (then both leave without the process group's shutdown)."""
    from fastdnn_tpu_torch import EngineConfig
    from fastdnn_tpu_torch.parallel.service import MultiHostScorer

    sc = MultiHostScorer(q, EngineConfig(), mesh, device="cpu", heartbeat_s=0,
                         call_timeout_s=DEATH_TIMEOUT_S)
    frames = inputs["frames"][:16]
    if rank != 0:
        execute = sc._execute

        def execute_then_die(*args):
            execute(*args)
            os._exit(17)  # no stop op: a crash

        sc._execute = execute_then_die
        sc.worker_loop()
        return
    first = sc.score(frames)
    time.sleep(1.0)  # let the worker finish dying
    t0 = time.monotonic()
    err = ""
    try:
        sc.score(frames)
    except RuntimeError as e:
        err = str(e)
    dead_s = time.monotonic() - t0
    t0 = time.monotonic()
    fast = ""
    try:
        sc.score(frames)
    except RuntimeError as e:
        fast = str(e)
    np.savez(work / "rank0.npz", first=first, err=np.array(err), dead_s=np.array(dead_s),
             fast=np.array(fast), fast_s=np.array(time.monotonic() - t0),
             closed=np.array(sc._closed))


def run(rank: int, world: int, data: int, model: int, workdir: str, mode: str) -> None:
    """Rank `rank` of `world`: join, build the mesh, run `mode`, write
    rank0.npz (rank 0) or rank<r>.err, leave."""
    work = Path(workdir)
    try:
        from fastdnn_tpu_torch.parallel.mesh import init_multihost, make_mesh
        from fastdnn_tpu_torch.quant.serialize import load_qnet

        init_multihost(f"file://{work / 'rendezvous'}", world_size=world, rank=rank,
                       backend="gloo")
        mesh = make_mesh(data, model, device_type="cpu")
        with np.load(work / "inputs.npz") as z:
            inputs = {k: z[k] for k in z.files}
        q = load_qnet(work / "q.npz")
        if mode == "death":
            _death(rank, q, mesh, inputs, work)
            os._exit(0)  # the group has a dead peer: skip its shutdown
        out = _cases(rank, q, mesh, inputs)
        if rank == 0:
            np.savez(work / "rank0.npz", **out)
        else:
            np.savez(work / f"rank{rank}.npz", **{k: v for k, v in out.items()
                                                  if k == "stream_refuses_worker"})
        dist.destroy_process_group()
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
