"""Spawned ranks on one host: one process per rank, joined to a gloo group
on a fresh localhost port, one report gathered from each, none left
behind (cli.bench's scaling grid, examples/mesh_scoring.py)."""

from __future__ import annotations

import queue
import socket
import time


def free_port() -> int:
    """A localhost TCP port that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(target, world: int, args: tuple = (), *, timeout: float, what: str = "ranks") -> dict:
    """Spawn `world` processes target(rank, port, *args, results), all given
    one free port for tcp://localhost:<port> -> {rank: report}.

    Each rank puts exactly one dict with its "rank" on `results`: its
    report, or {"rank": r, "error": traceback} when it failed.  A reported
    error raises RuntimeError with the traceback; a rank that exits
    non-zero without a report raises RuntimeError; no report from every
    rank within `timeout` seconds raises TimeoutError.  Every rank is gone
    on return.  Keep `args` small: they are pickled into each process."""
    import torch.multiprocessing as mp

    spawn = mp.get_context("spawn")
    results = spawn.Queue()
    port = free_port()
    procs = [spawn.Process(target=target, args=(r, port, *args, results)) for r in range(world)]
    for proc in procs:
        proc.start()
    reports: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(reports) < world:
            try:
                report = results.get(timeout=1.0)
            except queue.Empty:
                dead = {i: p.exitcode for i, p in enumerate(procs) if p.exitcode not in (None, 0)}
                if dead:
                    raise RuntimeError(f"{what}: rank(s) exited {dead} without a report") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{what}: {len(reports)} of {world} ranks reported in "
                                       f"{timeout:g} s") from None
                continue
            if "error" in report:
                raise RuntimeError(f"{what}: rank {report['rank']} failed:\n{report['error']}")
            reports[report["rank"]] = report
        for proc in procs:
            proc.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join()
    return reports
