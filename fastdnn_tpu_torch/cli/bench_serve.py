"""Serving-under-load benchmark of the PyTorch/CUDA port: N concurrent TCP
clients against the scoring server (cli/serve.py over engine/stream.py),
after the JAX package's tools/bench_serve.py.

  * N client threads, each streaming utterances back-to-back over its own
    persistent TCP connection (closed-loop load: a client sends its next
    utterance the moment the previous response lands);
  * utterance lengths drawn uniformly from [min_len, max_len] frames
    (real ASR decode spans ~1-10 s of audio = 100-1000 frames);
  * a --masked-frac fraction of clients sends the lazy path (random masks
    at --mask-density);
  * reported per run: aggregate audio-s/s, per-utterance latency
    p50/p90/p99, and the server's own mean batch fill (frames per device
    dispatch, from the stats op) — the number that says whether
    cross-utterance packing amortizes device calls.

Usage (spawns its own server unless --port points at a running one):

    python -m fastdnn_tpu_torch.cli.bench_serve                  # one run
    python -m fastdnn_tpu_torch.cli.bench_serve --clients 16 --max-wait-ms 3
    python -m fastdnn_tpu_torch.cli.bench_serve --ladder         # sweep table

Without --model it writes the default net, 429 -> 5x1024 -> 4000 aligned
to 4/16 with weights drawn by numpy from MODEL_SEED, in the reference binary
format under the package's build directory.  Output: one JSON line per
configuration (plus a markdown table with --ladder).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from .serve import ScoreClient

#: the directory that holds the package, the working directory of a spawned server
ROOT = Path(__file__).resolve().parents[2]
DEFAULT_MODEL = Path(__file__).resolve().parents[1] / "_build" / "bench_serve_model.bin"
MODEL_SEED = 7  # the default net's weights


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_for_server(port: int, proc, timeout_s: float) -> None:
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if proc.poll() is not None:
            out = proc.stdout.read() if proc.stdout else ""
            raise RuntimeError(f"server exited early:\n{out[-3000:]}")
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            time.sleep(0.3)
    raise TimeoutError(f"server not up on :{port} within {timeout_s}s")


def spawn_server(model: str, port: int, *, device: str, max_wait_ms: float,
                 max_batch_frames: int, timeout_s: float) -> subprocess.Popen:
    proc = subprocess.Popen(
        [sys.executable, "-m", "fastdnn_tpu_torch.cli.serve", str(model),
         "--port", str(port), "--device", device,
         "--max-wait-ms", str(max_wait_ms),
         "--max-batch-frames", str(max_batch_frames), "--warmup"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ,
             "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")},
    )
    try:
        _wait_for_server(port, proc, timeout_s)
    except BaseException:
        _stop(proc)
        raise
    return proc


def _stop(proc: subprocess.Popen) -> None:
    proc.terminate()
    try:
        proc.wait(20)
    except subprocess.TimeoutExpired:
        proc.kill()  # a wedged server must die before the next one starts
        proc.wait(20)


def write_default_model(path=DEFAULT_MODEL) -> Path:
    """The default net, 429 -> 5x1024 -> 4000 aligned to 4/16, weights drawn
    by numpy from MODEL_SEED, in the reference binary format."""
    from ..formats.binary import write_model
    from ..models.feedforward import align, random_net, to_raw

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    net = align(random_net(np.random.default_rng(MODEL_SEED), 429, [1024] * 5, 4000), 4, 16)
    write_model(to_raw(net), path)
    return path


class ClientLoad(threading.Thread):
    """One closed-loop client: stream utterances, record latencies; with
    `keep`, also the first response to each of its first `keep` pool
    utterances."""

    def __init__(self, port: int, input_dim: int, output_dim: int, *,
                 seed: int, duration_s: float, min_len: int, max_len: int,
                 masked: bool, mask_density: float, start_evt: threading.Event,
                 keep: int = 0):
        super().__init__(daemon=True)
        self.port = port
        self.rng = np.random.default_rng(seed)
        self.input_dim, self.output_dim = input_dim, output_dim
        self.duration_s = duration_s
        self.min_len, self.max_len = min_len, max_len
        self.masked, self.density = masked, mask_density
        self.start_evt = start_evt
        self.keep = keep
        self.latencies: list[float] = []
        self.frames = 0
        self.responses: dict[int, tuple] = {}
        self.error: Exception | None = None

    def run(self) -> None:
        try:
            cli = ScoreClient("127.0.0.1", self.port)
            # pre-generate a pool of utterances: payload generation must not
            # serialize with the measurement loop
            pool = []
            for _ in range(8):
                n = int(self.rng.integers(self.min_len, self.max_len + 1))
                f = self.rng.standard_normal((n, self.input_dim)).astype(np.float32)
                m = None
                if self.masked:
                    m = (self.rng.random((n, self.output_dim)) < self.density
                         ).astype(np.uint8)
                pool.append((f, m))
            self.start_evt.wait()
            deadline = time.perf_counter() + self.duration_s
            i = 0
            while time.perf_counter() < deadline:
                f, m = pool[i % len(pool)]
                t0 = time.perf_counter()
                out = cli.score(f, m)
                dt = time.perf_counter() - t0
                if out.shape != (f.shape[0], self.output_dim):
                    raise RuntimeError(f"response of shape {out.shape} to {f.shape[0]} frames")
                if i < min(self.keep, len(pool)):
                    self.responses[i] = (f, m, out)
                self.latencies.append(dt)
                self.frames += f.shape[0]
                i += 1
            cli.close()
        except Exception as e:  # surfaced by the harness
            self.error = e


def run_load(port: int, *, clients: int, duration_s: float, min_len: int,
             max_len: int, masked_frac: float, mask_density: float,
             keep: int = 0) -> dict:
    """Drive the server on `port` with `clients` closed-loop clients for
    `duration_s` -> one result row.  With `keep`, the row also holds
    "responses": for each client, the (frames, masks or None, posteriors)
    of its first `keep` distinct utterances, for checking against a serial
    scorer."""
    probe = ScoreClient("127.0.0.1", port)
    st = probe.stats()
    input_dim, output_dim = st["input_dim"], st["output_dim"]
    start = threading.Event()
    n_masked = int(round(clients * masked_frac))
    loads = [
        ClientLoad(port, input_dim, output_dim, seed=100 + i,
                   duration_s=duration_s, min_len=min_len, max_len=max_len,
                   masked=i < n_masked, mask_density=mask_density,
                   start_evt=start, keep=keep)
        for i in range(clients)
    ]
    for ld in loads:
        ld.start()
    time.sleep(0.3)  # let every client finish generating its pool
    stats0 = probe.stats()
    t0 = time.perf_counter()
    start.set()
    for ld in loads:
        ld.join(duration_s + 120)
    wall = time.perf_counter() - t0
    stats1 = probe.stats()
    probe.close()
    for ld in loads:
        if ld.is_alive():
            raise TimeoutError("a client did not finish within its time limit")
        if ld.error is not None:
            raise ld.error
    lats = np.concatenate([np.asarray(ld.latencies) for ld in loads])
    frames = sum(ld.frames for ld in loads)
    sframes = stats1["frames"] - stats0["frames"]
    sbatches = stats1["batches"] - stats0["batches"]
    row = {
        "clients": clients,
        "masked_clients": n_masked,
        "utterances": int(lats.size),
        "frames": int(frames),
        "audio_s_per_s": round(frames / 100.0 / wall, 1),
        "p50_ms": round(float(np.percentile(lats, 50)) * 1e3, 1),
        "p90_ms": round(float(np.percentile(lats, 90)) * 1e3, 1),
        "p99_ms": round(float(np.percentile(lats, 99)) * 1e3, 1),
        "mean_batch_fill": round(sframes / sbatches, 1) if sbatches else 0.0,
        "wall_s": round(wall, 1),
    }
    if keep:
        row["responses"] = [[r for _, r in sorted(ld.responses.items())] for ld in loads]
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default=None,
                   help="model path (default: write the default net, see above)")
    p.add_argument("--port", type=int, default=0,
                   help="attach to a running server instead of spawning")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the spawned server's device")
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--duration-s", type=float, default=10.0)
    p.add_argument("--min-len", type=int, default=100)
    p.add_argument("--max-len", type=int, default=1000)
    p.add_argument("--masked-frac", type=float, default=0.25)
    p.add_argument("--mask-density", type=float, default=0.08)
    p.add_argument("--max-wait-ms", type=float, default=3.0)
    p.add_argument("--max-batch-frames", type=int, default=8192)
    p.add_argument("--ladder", action="store_true",
                   help="sweep clients x max_wait_ms, print a markdown table")
    args = p.parse_args(argv)

    model = args.model
    if model is None and not args.port:
        model = write_default_model()

    configs = [(args.clients, args.max_wait_ms)]
    if args.ladder:
        configs = [(c, w) for w in (1.0, 3.0, 10.0) for c in (1, 4, 16, 64)]

    rows = []
    server, server_wait, port = None, None, args.port
    try:
        for clients, wait_ms in configs:
            if not args.port and wait_ms != server_wait:
                # one server per max_wait_ms value (server-side knob)
                if server is not None:
                    _stop(server)
                    server = None
                port = _free_port()
                server = spawn_server(model, port, device=args.device, max_wait_ms=wait_ms,
                                      max_batch_frames=args.max_batch_frames, timeout_s=600)
                server_wait = wait_ms
            r = run_load(port, clients=clients, duration_s=args.duration_s,
                         min_len=args.min_len, max_len=args.max_len,
                         masked_frac=args.masked_frac, mask_density=args.mask_density)
            r["max_wait_ms"] = wait_ms
            rows.append(r)
            print(json.dumps(r), flush=True)
    finally:
        if server is not None:
            _stop(server)

    if args.ladder and rows:
        print("\n| wait ms | clients | audio-s/s | p50 ms | p90 ms | p99 ms | fill |")
        print("|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['max_wait_ms']} | {r['clients']} | {r['audio_s_per_s']} "
                  f"| {r['p50_ms']} | {r['p90_ms']} | {r['p99_ms']} "
                  f"| {r['mean_batch_fill']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
