"""Scoring server of the PyTorch/CUDA port: a TCP front end over the
streaming engine, the counterpart of fastdnn_tpu/cli/serve.py.

    python -m fastdnn_tpu_torch.cli.serve MODEL --port 8477 [--device cuda|cpu]
        [--cutoff 3.0] [--hidden-bits 8|4] [--int4-packed] [--fast-posteriors]
        [--input-precision highest|high|default]
        [--lazy-mode auto|dense|gathered|block_sparse]
        [--max-batch-frames 8192] [--max-wait-ms 3] [--warmup]
        [--mesh-model M] [--mesh-data D]
        [--coordinator HOST:PORT --num-processes N --process-id R]

Concurrent clients submit utterances; the StreamingScorer packs them into
shared batches on the card (engine/stream.py).  `--device cuda` (the
default) runs the hand-written kernels and fails when no GPU is present;
`--device cpu` runs their plain PyTorch versions.

A mesh flag or `--coordinator` serves over several processes: every
process joins one process group (`--coordinator` with `--num-processes`
and `--process-id`, or torchrun's environment without them), builds the
same MultiHostScorer (parallel/service.py) on cuda:(rank % cards), and
rank 0 serves TCP while the other ranks mirror its calls in
`worker_loop()`.  SIGTERM or Ctrl-C on rank 0 closes the scorer, which
releases the workers.  The backend is NCCL when each rank on the host has
a card of its own, else gloo (parallel.mesh.join_ranks).

Wire protocol (all integers little-endian u32 unless noted), byte for byte
the JAX package's, so either package's client and the native
`fastdnn-io score HOST:PORT` work against either server:

    request:  magic b"FDN1" | op u8 | n | dim | f32 frames[n*dim]
              op 1 = score
              op 2 = score_masked: followed by u8 masks[n * out_dim]
              op 3 = stats (no body)
    response: status u8 (0 ok, 1 error) |
              ok:    n | out | f32 posteriors[n*out]
              error: len | utf-8 message
              stats: len | utf-8 json

One request per connection round; connections persist for many rounds.
"""

from __future__ import annotations

import argparse
import json
import signal
import socket
import socketserver
import struct
import sys
import threading

import numpy as np

MAGIC = b"FDN1"
OP_SCORE, OP_SCORE_MASKED, OP_STATS = 1, 2, 3


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("client closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _send_ok(sock: socket.socket, arr: np.ndarray) -> None:
    n, out = arr.shape
    sock.sendall(struct.pack("<BII", 0, n, out))
    sock.sendall(np.ascontiguousarray(arr, dtype=np.float32).tobytes())


def _send_err(sock: socket.socket, msg: str) -> None:
    raw = msg.encode()
    sock.sendall(struct.pack("<BI", 1, len(raw)) + raw)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: "ScoreServer" = self.server  # type: ignore[assignment]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                head = _recv_exact(sock, 5)
            except ConnectionError:
                return
            if head[:4] != MAGIC:
                _send_err(sock, "bad magic")
                return
            op = head[4]
            if op not in (OP_SCORE, OP_SCORE_MASKED, OP_STATS):
                # reject BEFORE reading a body the op doesn't define —
                # otherwise the handler blocks waiting for phantom payload
                _send_err(sock, f"unknown op {op}")
                continue
            try:
                if op == OP_STATS:
                    tp = server.stream.throughput
                    payload = json.dumps(
                        {
                            "frames": tp.frames,
                            "batches": tp.batches,
                            "mean_batch_fill": round(tp.mean_batch_fill(), 1),
                            "frames_per_s": round(tp.frames_per_s(), 1),
                            "audio_seconds_per_s": round(tp.audio_seconds_per_s(), 2),
                            # model dims so clients can size feature vectors
                            # and mask payloads without out-of-band knowledge
                            "input_dim": server.stream.input_dim,
                            "output_dim": server.stream.output_dim,
                        }
                    ).encode()
                    sock.sendall(struct.pack("<BI", 0, len(payload)) + payload)
                    continue
                n, dim = struct.unpack("<II", _recv_exact(sock, 8))
                if n == 0 or dim == 0 or n * dim > 1 << 28 or dim > server.stream.input_dim:
                    # the declared payload length is untrustworthy (and a
                    # wrong dim desynchronizes a masked request's byte
                    # stream), so error out and drop the connection rather
                    # than misparse what follows
                    _send_err(
                        sock,
                        f"bad frame count/dim {n}x{dim} "
                        f"(model input dim {server.stream.input_dim})",
                    )
                    return
                frames = np.frombuffer(
                    _recv_exact(sock, 4 * n * dim), dtype="<f4"
                ).reshape(n, dim)
                masks = None
                if op == OP_SCORE_MASKED:
                    out_dim = server.stream.output_dim
                    masks = np.frombuffer(
                        _recv_exact(sock, n * out_dim), dtype=np.uint8
                    ).reshape(n, out_dim)
                fut = server.stream.submit(frames, masks)
                _send_ok(sock, fut.result())
            except (ConnectionError, BrokenPipeError):
                return
            except Exception as e:  # surface engine errors to the client
                try:
                    _send_err(sock, f"{type(e).__name__}: {e}")
                except OSError:
                    return


class ScoreServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, stream):
        self.stream = stream
        super().__init__(addr, _Handler)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fastdnn-torch-serve",
        description="Scoring server: TCP front end over the streaming engine (PyTorch/CUDA)",
    )
    p.add_argument(
        "model",
        help="reference-format binary model, or a .npz int8 checkpoint "
        "(quantize once, serve forever)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8477)
    p.add_argument("--cutoff", type=float, default=3.0)
    p.add_argument("--hidden-bits", type=int, default=None, choices=[8, 4],
                   help="4 = int4 hidden trunk (output layer stays int8)")
    p.add_argument(
        "--int4-packed", action="store_true",
        help="store an int4 trunk two nibbles per byte and run the packed "
        "hidden-layer kernel (config.EngineConfig.int4_packed)",
    )
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="cuda: hand-written kernels (fails without a GPU); cpu: plain versions",
    )
    p.add_argument("--max-batch-frames", type=int, default=8192)
    p.add_argument("--max-wait-ms", type=float, default=3.0)
    p.add_argument(
        "--lazy-mode",
        default="auto",
        choices=["auto", "dense", "gathered", "block_sparse"],
        help="masked-scoring strategy (config.EngineConfig.lazy_mode); "
        "block_sparse skips all-inactive tiles (cuda only; clients must send "
        "clustered senone ids, engine.cluster)",
    )
    p.add_argument(
        "--mesh-model", type=int, default=0,
        help="model-parallel ranks for the senone axis (0 = no mesh: one "
        "device, one process); with a mesh, frames are data-parallel over "
        "the remaining ranks",
    )
    p.add_argument(
        "--mesh-data", type=int, default=None,
        help="data-parallel ranks (default: all ranks not used by --mesh-model)",
    )
    p.add_argument(
        "--coordinator", default=None,
        help="HOST:PORT of rank 0's rendezvous (torch.distributed, tcp://); "
        "with --num-processes and --process-id, else from torchrun's "
        "environment.  Rank 0 serves TCP, the other ranks run the worker loop",
    )
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument(
        "--fast-posteriors", action="store_true",
        help="bf16 posteriors on the device (EngineConfig.fast_posteriors); "
        "responses still carry f32",
    )
    p.add_argument(
        "--input-precision",
        default="high",
        choices=["highest", "high", "default"],
        help="the float input layer's product (EngineConfig.input_precision): "
        "'high' and 'highest' run the 3xTF32 kernel; 'default' (1-pass bf16) "
        "is the throughput setting and can flip a few sigmoid counts",
    )
    p.add_argument(
        "--warmup",
        action="store_true",
        help="score a few batches before accepting clients (the first CUDA "
        "call builds the kernels; do it at startup, not on the first request)",
    )
    return p


def _multi(args) -> bool:
    """A mesh flag or --coordinator: serve over several processes."""
    return bool(getattr(args, "mesh_model", 0) or getattr(args, "mesh_data", None)
                or getattr(args, "coordinator", None))


def build_scorer(args):
    """Model load + quantize + scorer -> (scorer, topology): one device,
    or, with a mesh flag or --coordinator, a MultiHostScorer after joining
    the process group (whose rank decides the role: see main)."""
    from ..config import EngineConfig
    from ..quant.serialize import load_quantized

    device = getattr(args, "device", "cuda")
    if _multi(args):
        from ..parallel.mesh import join_ranks

        coordinator = getattr(args, "coordinator", None)
        if coordinator:
            device = join_ranks(device, f"tcp://{coordinator}", world_size=args.num_processes,
                                rank=args.process_id)
        else:
            device = join_ranks(device)
    qnet, topology = load_quantized(
        args.model, cutoff=args.cutoff, hidden_bits=getattr(args, "hidden_bits", None),
    )
    cfg = EngineConfig(
        lazy_mode=getattr(args, "lazy_mode", "auto"),
        int4_packed=getattr(args, "int4_packed", False),
        fast_posteriors=getattr(args, "fast_posteriors", False),
        input_precision=getattr(args, "input_precision", "high"),
    )
    if not _multi(args):
        from ..engine.scorer import Scorer

        return Scorer(qnet, cfg, device=device), topology
    from ..parallel.mesh import make_mesh
    from ..parallel.service import MultiHostScorer

    mesh = make_mesh(data=getattr(args, "mesh_data", None),
                     model=getattr(args, "mesh_model", 0) or 1, device_type=device.type)
    return MultiHostScorer(qnet, cfg, mesh, device=device), topology


def make_server(args, prebuilt=None) -> ScoreServer:
    from ..engine.stream import StreamingScorer

    scorer, topology = prebuilt if prebuilt is not None else build_scorer(args)
    print(f"Network = {topology}", flush=True)
    if getattr(args, "warmup", False):
        bucket = scorer.config.frame_bucket
        for n in (bucket, 4 * bucket, args.max_batch_frames):
            n = min(n, args.max_batch_frames)
            scorer.score(np.zeros((n, scorer.input_dim), np.float32))
            print(f"warmed {n}-frame batch", flush=True)
    stream = StreamingScorer(
        scorer,
        max_batch_frames=args.max_batch_frames,
        max_wait_ms=args.max_wait_ms,
    )
    return ScoreServer((args.host, args.port), stream)


def _interrupt(signum, frame):
    raise KeyboardInterrupt  # SIGTERM shuts down as Ctrl-C does


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prebuilt = None
    if _multi(args):
        import torch.distributed as dist

        # build first (it joins the process group), then take the role from
        # the rank, so that a rendezvous from torchrun's environment works
        scorer, topology = build_scorer(args)
        try:
            if not scorer.is_coordinator:
                # no TCP: mirror the coordinator's calls until it stops
                print(f"worker {dist.get_rank()}: Network = {topology}", flush=True)
                scorer.worker_loop()
                return 0
            prebuilt = (scorer, topology)
            return _serve(args, prebuilt)
        finally:
            scorer.close()
            dist.destroy_process_group()
    return _serve(args, prebuilt)


def _serve(args, prebuilt) -> int:
    server = make_server(args, prebuilt)
    host, port = server.server_address[:2]
    print(f"serving on {host}:{port}", flush=True)
    previous = signal.signal(signal.SIGTERM, _interrupt)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, previous)
        server.shutdown()
        server.server_close()
        server.stream.close()
    return 0


# -- minimal client (also used by tests) -------------------------------------


class ScoreClient:
    """Blocking client for the serve protocol."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def score(self, frames: np.ndarray, masks: np.ndarray | None = None) -> np.ndarray:
        frames = np.ascontiguousarray(frames, dtype=np.float32)
        n, dim = frames.shape
        op = OP_SCORE_MASKED if masks is not None else OP_SCORE
        with self._lock:
            self._sock.sendall(MAGIC + struct.pack("<BII", op, n, dim))
            self._sock.sendall(frames.tobytes())
            if masks is not None:
                self._sock.sendall(
                    np.ascontiguousarray(masks, dtype=np.uint8).tobytes()
                )
            return self._read_response()

    def stats(self) -> dict:
        with self._lock:
            self._sock.sendall(MAGIC + struct.pack("<B", OP_STATS))
            status, ln = struct.unpack("<BI", _recv_exact(self._sock, 5))
            payload = _recv_exact(self._sock, ln)
        if status != 0:
            raise RuntimeError(payload.decode())
        return json.loads(payload)

    def _read_response(self) -> np.ndarray:
        status = _recv_exact(self._sock, 1)[0]
        if status != 0:
            (ln,) = struct.unpack("<I", _recv_exact(self._sock, 4))
            raise RuntimeError(_recv_exact(self._sock, ln).decode())
        n, out = struct.unpack("<II", _recv_exact(self._sock, 8))
        data = _recv_exact(self._sock, 4 * n * out)
        return np.frombuffer(data, dtype="<f4").reshape(n, out).copy()

    def close(self) -> None:
        self._sock.close()


def _cli(argv=None) -> int:
    """Entry point with one-line error reporting for expected failures
    (bad paths, dims or parameters, no GPU)."""
    try:
        return main(argv)
    except (OSError, ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(_cli())
