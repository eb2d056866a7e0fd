#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fastdnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, checks each against its plain
PyTorch version on the card at the shapes the main path gives it, drives the
main path (`Scorer.score` on the 432 -> 7x2048 -> 8000 net, seeded random
weights) at three batch sizes, the lazy path (`Scorer.score_masked` under
both semantics and in the block-sparse and gathered modes, and a beam decode
through `LazyContext`), the same net with an int4 hidden trunk (unpacked,
and packed two nibbles per byte through the packed-layer kernel), and the
command-line chain from a Kaldi text model through `convert model`,
`convert quantize --hidden-bits 4` and `score`, the stats output kernel
(K8) and its normalize at the flagship shapes, a 432 -> 2x3072 -> 8000 net
too wide for the resident softmax and the stack kernels (scored through K8
and the normalize kernel, traced to show no other device work), and the
tensor-parallel `Scorer(mesh=...)` on the flagship net with two ranks on the
one card (gloo); shows through the launch counters that each run went
through the kernels it should, and times kernels and paths beside their
plain versions: the input kernel (K9) against the f64 product + K1 route it
replaced, K3 against six K2 launches, the block-sparse softmax (K6) against
the dense masked one (K4) and the skipping stats kernel (K8), the packed
int4 layer (K7) against K2, all in turns, the logits kernel (K5) at the
LazyContext's 64 frames and at 8192, single, queued and under the profiler,
with each kernel's bound and, as a yardstick, the
product alone at its shape (`torch._int_mm`; for K9 the f64 and the f32
`torch.matmul`), which the port never calls.  Then the serving path on the
flagship net: the StreamingScorer fed by 8 submitter threads (every result
against serial scoring, in turns with a serial loop, under the profiler,
and where one 8192-frame batch's time goes), a ScoreServer on loopback TCP
driven by bench_serve.run_load with 16 clients, and 8 threads sharing one
Scorer beside 4 LazyContexts decoding at once.  Then the multi-process
path, each extra rank a second process on the card over gloo: a
MultiHostScorer coordinated from this process with one worker rank (every
case against the single device, each rank's launches per call), the
serve CLI as two processes under bench_serve's load, a worker that dies
mid-stream, the score CLI under torchrun, make_gspmd_scorer on two ranks,
and the native reader against the numpy parsers.  Any failed check raises
and the script exits non-zero.
The last line of standard output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

It needs the repository around it and a CUDA device; without either it
fails before printing any result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SEED = 0
INPUT_DIM, HIDDEN, DEPTH, SENONES = 432, 2048, 7, 8000
FRAMES_PER_AUDIO_SECOND = 100  # 10 ms frame shift
TIMED_REPS = 12
LAZY_DENSITY = 0.4  # the JAX bench's lazy mix: 40% of the senones active
BF16_RTOL, BF16_ATOL = 2e-2, 1e-3
# the normalize kernel against its plain version on the same f32 stats
NORMALIZE_RTOL, NORMALIZE_ATOL = 1e-6, 1e-12
DECODE_FRAMES = 60
CLI_HIDDEN, CLI_DEPTH, CLI_SENONES = 256, 3, 1000  # the text net, before --extend
CLI_FRAMES = 1000
WIDE_HIDDEN, WIDE_DEPTH = 3072, 2  # wider than K4's K and K3's H
TP_RANKS = 2  # tensor-parallel ranks on the one card
TP_TIMEOUT_S = 300  # per-rank join timeout of phase 16
# published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
PEAK_OPS_PER_S = {"int8": 1979e12, "tf32": 494.7e12}
HBM_BYTES_PER_S = 3.35e12
COUNT_FLIP_RATE = 1e-4  # the input layer's gate: <= 1 count on <= 1e-4 of the entries
SMOKE_DIR = Path(__file__).resolve().parent / "fastdnn_tpu_torch" / "_build" / "smoke_cli"
# the serving phases: bench_serve's mix (utterances of 100-1000 frames, a
# quarter of them masked at density 0.08), the stream's and the server's
# defaults (8192-frame batches, 3 ms wait)
STREAM_UTTERANCES, STREAM_SUBMITTERS = 96, 8
SERVE_CLIENTS, SERVE_SECONDS, SERVE_KEEP = 16, 5.0, 8
UTT_MIN, UTT_MAX, MASKED_FRAC, SERVE_DENSITY = 100, 1000, 0.25, 0.08
SERVE_BOUND = 3e-5  # every streamed or served posterior against serial scoring
# the multi-process phases (22-25): a coordinator and a worker on cuda:0 over
# gloo, the flagship net from one checkpoint, the output split over 2 ranks
SERVICE_DIR = Path(__file__).resolve().parent / "fastdnn_tpu_torch" / "_build" / "smoke_service"
SERVICE_CALL_TIMEOUT_S = 120.0
SERVICE_CONFIGS = (  # (name, EngineConfig fields, scatter), built in this order on both ranks
    ("scatter", {}, True),
    ("active_only", {"lazy_semantics": "active_only"}, True),
    ("block_sparse", {"lazy_mode": "block_sparse"}, True),
    ("broadcast", {}, False),
)
SERVICE_CTX_FRAMES = 8  # the LazyContext through the coordinator
DEATH_TIMEOUT_S = 15.0  # phase 24's call_timeout_s
MASKED_BOUND = 3e-5  # masked posteriors of the multi-process path against one device


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    print(f"  ok  {what}", flush=True)


def time_ms(torch, fn, reps: int = TIMED_REPS) -> float:
    """Median device time of `fn` in ms over `reps` CUDA-event-timed calls,
    after two warm-up calls (L2 warm: calls run back to back)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def host_ms(torch, fn, reps: int = TIMED_REPS) -> float:
    """Median wall time of `fn` in ms over `reps` calls on the host clock,
    each synchronized, after two warm-up calls: what a tensor-parallel rank
    can time, its collectives going through the host."""
    times = []
    for i in range(2 + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(ops: float, kind: str, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take for work of `ops` operations
    on tensor-core type `kind` ("int8" or "tf32") moving `nbytes` bytes
    (each input read once, each output written once), and which of the two
    bounds it."""
    ops_ms, bytes_ms = ops / PEAK_OPS_PER_S[kind] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def back_to_back_ms(torch, fn, calls: int = 20) -> float:
    """Device time of `fn` in ms per call over `calls` calls queued back to
    back between two CUDA events, after two warm-up calls: the wrapper's
    host time hides behind the queued kernels, unlike time_ms's single
    calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / calls


def profile_device(torch, fn, calls: int = 10):
    """`fn` called `calls` times under torch.profiler (CUPTI), after one
    warm-up call -> (host window in ms per call, [(kernel name, device ms
    per call)]); the list is empty when the profiler recorded no device
    time.  Launch counts come from the wrappers' counters, not from here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3 / calls
    device = [(e.key, e.self_device_time_total / 1e3 / calls) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return window_ms, device


def in_turns(torch, fns: dict, timer=time_ms) -> dict:
    """Time each of `fns` (name -> callable) twice with `timer`, in the
    order a, b, c, c, b, a -> name -> [first, second] ms."""
    order = list(fns) + list(fns)[::-1]
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(timer(torch, fns[name]))
    return times


def count_gate(got, want, what: str) -> float:
    """s8 counts `got` within 1 of `want` on at most COUNT_FLIP_RATE of the
    entries -> the share that differ."""
    d = (got.int() - want.int()).abs()
    share = float((d > 0).float().mean())
    check(got.shape == want.shape and int(d.max()) <= 1 and share <= COUNT_FLIP_RATE,
          f"{what}: max |d| = {int(d.max())} <= 1, {int((d > 0).sum())} of {d.numel()} differ "
          f"(share {share:.3g} <= {COUNT_FLIP_RATE:g})")
    return share


def random_layer(rng, k: int, n: int):
    """A seeded int8 hidden layer in the plain layout: w [K, N], colsum128
    [N], inv_scale (a float), bias [N], as numpy."""
    w = rng.integers(-24, 25, (k, n), dtype=np.int8)
    colsum = 128 * w.astype(np.int32).sum(axis=0, dtype=np.int32)
    inv = float(np.float32(1.0 / (rng.integers(20, 60) * 255.0)))
    bias = (rng.standard_normal(n) * 0.5).astype(np.float32)
    return w, colsum, inv, bias


def random_stack(rng, layers: int, h: int):
    """A seeded int8 hidden stack in the plain layout: w [L, H, H] ([K, N]
    per layer), colsum128 [L, H], inv_scales [L], bias [L, H], as numpy."""
    w = rng.integers(-24, 25, (layers, h, h), dtype=np.int8)
    colsum = 128 * w.astype(np.int32).sum(axis=1, dtype=np.int32)
    inv = (1.0 / (rng.integers(20, 60, layers) * 255.0)).astype(np.float32)
    bias = (rng.standard_normal((layers, h)) * 0.5).astype(np.float32)
    return w, colsum, inv, bias


def band_masks(rng, frames: int, block: int = 64, width: int = SENONES // 10) -> np.ndarray:
    """Clustered masks: each `block`-frame block activates half of one band
    of `width` senones (about 10% of them), as clustered decoder masks do."""
    masks = np.zeros((frames, SENONES), np.uint8)
    for lo in range(0, frames, block):
        start = int(rng.integers(0, SENONES - width))
        rows = min(block, frames - lo)
        masks[lo:lo + rows, start:start + width] = rng.random((rows, width)) < 0.5
    return masks


def network_text(raw) -> str:
    """A RawNetwork as Kaldi nnet1 text (weights row by row, then the bias)."""
    out = ["<Nnet>"]
    for i, layer in enumerate(raw.layers):
        out.append(f"<AffineTransform> {layer.output_dim} {layer.input_dim}")
        rows = [" ".join(f"{v:.9g}" for v in row) for row in layer.weights]
        out.append("[ " + "\n  ".join(rows) + " ]")
        out.append("[ " + " ".join(f"{v:.9g}" for v in layer.bias) + " ]")
        out.append("<Softmax>" if i == len(raw.layers) - 1 else "<Sigmoid>")
    return "\n".join(out + ["</Nnet>"]) + "\n"


def transform_text(raw) -> str:
    """The feature transform as Kaldi text: splice, shift and scale blocks."""
    shift = " ".join(f"{v:.9g}" for v in raw.shift)
    scale = " ".join(f"{v:.9g}" for v in raw.scale)
    return f"<Splice> [ 0 ]\n<AddShift> [ {shift} ]\n<Rescale> [ {scale} ]\n"


def close(got, want, what: str, bound: float = 1e-4) -> None:
    """Posteriors `got` (host f32) within `bound` of `want` with argmax
    agreement >= 0.999, finite and of the same shape."""
    check(got.shape == want.shape and got.dtype == np.float32 and bool(np.isfinite(got).all()),
          f"{what}: finite f32 {list(got.shape)}")
    dp = float(np.abs(got - want).max())
    agree = float((got.argmax(1) == want.argmax(1)).mean())
    check(dp <= bound and agree >= 0.999,
          f"{what}: max |dp| = {dp:.3g} <= {bound:g}, argmax agreement {agree:.4f} >= 0.999")


def tp_rank(rank: int, port: int, results) -> None:
    """One rank of phase 16: the flagship net with its output layer split
    over TP_RANKS model ranks on cuda:0 (gloo), every run checked against
    the single-device path in this process; reports launch counts, errors
    and times through `results`."""
    import traceback

    try:
        import torch

        from fastdnn_tpu_torch import EngineConfig, Scorer, quantize_net, random_net
        from fastdnn_tpu_torch.ops import kernels
        from fastdnn_tpu_torch.parallel.mesh import init_multihost, make_mesh
        from fastdnn_tpu_torch.parallel.sharded import _valid_count

        dev = torch.device("cuda", 0)
        torch.zeros(1, device=dev)  # the rank's device, chosen before the mesh
        init_multihost(f"tcp://localhost:{port}", world_size=TP_RANKS, rank=rank, backend="gloo")
        mesh = make_mesh(1, TP_RANKS, device_type="cuda")
        rng = np.random.default_rng(SEED)  # the parent's net and frames
        qnet = quantize_net(random_net(rng, INPUT_DIM, [HIDDEN] * DEPTH, SENONES))
        frames = rng.standard_normal((8192, INPUT_DIM), dtype=np.float32)
        mask_rng = np.random.default_rng(SEED + 16)
        masks = (mask_rng.random((8192, SENONES), dtype=np.float32) < LAZY_DENSITY).astype(np.uint8)
        masks[7] = 0
        bands = band_masks(mask_rng, 8192)
        report = {"rank": rank, "runs": {}}
        cases = (
            ("score", EngineConfig(), None, "reference"),
            ("score_masked reference", EngineConfig(), masks, "reference"),
            ("score_masked active_only", EngineConfig(lazy_semantics="active_only"), masks,
             "active_only"),
            ("score_masked block_sparse, band masks", EngineConfig(lazy_mode="block_sparse"),
             bands, "reference"),
        )
        tp = None
        for title, config, m, semantics in cases:
            single = Scorer(qnet, EngineConfig(lazy_semantics=semantics), device=dev)
            want = single.score(frames) if m is None else single.score_masked(frames, m)
            del single
            tp = Scorer(qnet, config, device=dev, mesh=mesh)
            kernels.reset_launch_counts()
            got = tp.score(frames) if m is None else tp.score_masked(frames, m)
            counts = kernels.launch_counts()
            report["runs"][title] = {
                "counts": counts,
                "shape_ok": got.shape == want.shape and got.dtype == np.float32,
                "finite": bool(np.isfinite(got).all()),
                "max_dp": float(np.abs(got - want).max()),
                "agree": float((got.argmax(1) == want.argmax(1)).mean()),
            }
        scorer = Scorer(qnet, EngineConfig(), device=dev, mesh=mesh)
        batch = torch.from_numpy(frames).to(dev)
        block = scorer.score_device(batch)
        report["block_shape"] = list(block.shape)
        report["valid_count"] = _valid_count(block.shape[1], SENONES, rank)
        # both ranks in lockstep: each call all-reduces
        report["score_device_ms"] = host_ms(torch, lambda: scorer.score_device(batch))
        results.put(report)
        torch.distributed.destroy_process_group()
    except BaseException:
        results.put({"rank": rank, "error": traceback.format_exc()})
        raise


def service_rank(rank: int, port: int, mode: str, results) -> None:
    """A spawned rank of phases 22, 24 and 25 on cuda:0 (gloo, mesh 1 x
    TP_RANKS), its net from the checkpoint in SERVICE_DIR:

      "worker"             phase 22's worker: every SERVICE_CONFIGS scorer's
                           worker_loop in turn, with each call's launch counts;
      "death-coordinator"  phase 24's rank 0: a StreamingScorer over the
                           coordinator, whose worker dies after one call;
      "death-worker"       phase 24's rank 1: dies after its first call;
      "gspmd"              phase 25's rank 1: make_gspmd_scorer's two calls.

    Reports through `results`."""
    import os
    import traceback

    try:
        import torch
        import torch.distributed as dist

        from fastdnn_tpu_torch import EngineConfig, StreamingScorer, load_qnet
        from fastdnn_tpu_torch.ops import kernels
        from fastdnn_tpu_torch.parallel.mesh import init_multihost, make_mesh
        from fastdnn_tpu_torch.parallel.service import MultiHostScorer
        from fastdnn_tpu_torch.parallel.sharded import make_gspmd_scorer

        dev = torch.device("cuda", 0)
        torch.zeros(1, device=dev)  # the rank's device, chosen before the mesh
        init_multihost(f"tcp://localhost:{port}", world_size=TP_RANKS, rank=rank, backend="gloo")
        mesh = make_mesh(1, TP_RANKS, device_type="cuda")
        qnet = load_qnet(SERVICE_DIR / "flagship.npz")
        frames = np.load(SERVICE_DIR / "frames.npy")
        report = {"rank": rank, "mode": mode}
        if mode == "worker":
            report["calls"] = {}
            for name, fields, scatter in SERVICE_CONFIGS:
                sc = MultiHostScorer(qnet, EngineConfig(**fields), mesh, device=dev,
                                     scatter=scatter)
                calls = report["calls"][name] = []
                execute = sc._execute

                def counted(*args, execute=execute, calls=calls):
                    kernels.reset_launch_counts()
                    out = execute(*args)
                    calls.append(kernels.launch_counts())
                    return out

                sc._execute = counted
                sc.worker_loop()
                del sc
        elif mode == "death-worker":
            sc = MultiHostScorer(qnet, EngineConfig(), mesh, device=dev, heartbeat_s=0,
                                 call_timeout_s=DEATH_TIMEOUT_S)
            execute = sc._execute

            def execute_then_die(*args):
                execute(*args)
                os._exit(17)  # no stop op: a crash in the middle of the stream

            sc._execute = execute_then_die
            sc.worker_loop()
            report["error"] = "the worker loop returned"
        elif mode == "death-coordinator":
            sc = MultiHostScorer(qnet, EngineConfig(), mesh, device=dev, heartbeat_s=0,
                                 call_timeout_s=DEATH_TIMEOUT_S)
            utt = frames[:UTT_MAX]
            with StreamingScorer(sc, max_batch_frames=8192, max_wait_ms=3.0) as ss:
                report["first_shape"] = list(ss.submit(utt).result(300).shape)
                time.sleep(1.0)  # the worker is dead by now
                for what in ("dead", "after"):
                    t0 = time.monotonic()
                    try:
                        ss.submit(utt).result(DEATH_TIMEOUT_S + 60)
                        report[what] = ("no error", "")
                    except Exception as e:  # the type is the finding; checked by the parent
                        report[what] = (type(e).__name__, str(e)[:300])
                    report[f"{what}_s"] = time.monotonic() - t0
            report["closed"] = sc._closed
            results.put(report)
            results.close()
            results.join_thread()
            os._exit(0)  # the group has a dead peer: skip its shutdown
        elif mode == "gspmd":
            masks = np.load(SERVICE_DIR / "masks.npy")
            score, score_masked = make_gspmd_scorer(mesh)
            f, m = torch.from_numpy(frames).to(dev), torch.from_numpy(masks).to(dev)
            kernels.reset_launch_counts()
            report["shapes"] = [list(score(qnet, f).shape),
                                list(score_masked(qnet, f, m).shape)]
            report["counts"] = kernels.launch_counts()
        results.put(report)
        dist.destroy_process_group()
    except BaseException:
        results.put({"rank": rank, "mode": mode, "error": traceback.format_exc()})
        raise


def spawn_ranks(modes: dict, port: int):
    """Start `service_rank` for each {rank: mode} -> (processes, queue)."""
    import torch.multiprocessing as mp

    spawn = mp.get_context("spawn")
    results = spawn.Queue()
    procs = {r: spawn.Process(target=service_rank, args=(r, port, mode, results))
             for r, mode in modes.items()}
    for proc in procs.values():
        proc.start()
    return procs, results


def collect(procs: dict, results, count: int, timeout: float = TP_TIMEOUT_S) -> list:
    """`count` reports from the spawned ranks, then every rank joined (a
    rank still alive at the deadline is killed)."""
    reports = []
    deadline = time.monotonic() + timeout
    try:
        for _ in range(count):
            reports.append(results.get(timeout=max(deadline - time.monotonic(), 1)))
        for proc in procs.values():
            proc.join(max(deadline - time.monotonic(), 1))
    finally:
        for proc in procs.values():
            if proc.is_alive():
                proc.kill()
                proc.join()
    errors = [r["error"] for r in reports if "error" in r]
    check(not errors, f"{len(procs)} spawned rank(s) reported" + (
        "" if not errors else ":\n" + "\n".join(errors)))
    return reports


def split_coordinated(torch, mh, frames, calls: int = 3) -> dict:
    """Where a coordinated `score` goes on the coordinator, host clock,
    median of `calls`: the header broadcast, the frames' scatter, this
    rank's kernels (synchronized), the posteriors' gather, and the rest
    (padding, the watchdog's thread, the host copy out)."""
    from fastdnn_tpu_torch.parallel import service

    spans = {"header broadcast": [], "scatter of the frames": [],
             "this rank's kernels": [], "gather of the posteriors": []}

    def timed(name, fn, sync=False):
        def run(*args):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            if sync:
                torch.cuda.synchronize()
            spans[name][-1] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    patched = {
        (service, "_broadcast"): timed("header broadcast", service._broadcast),
        (service, "gather_blocks"): timed("gather of the posteriors", service.gather_blocks),
        (mh, "_ship"): timed("scatter of the frames", mh._ship),
        (mh, "_run_local"): timed("this rank's kernels", mh._run_local, sync=True),
    }
    saved = {key: getattr(*key) for key in patched}
    totals = []
    try:
        for obj_name, fn in patched.items():
            setattr(*obj_name, fn)
        for _ in range(calls):
            for v in spans.values():
                v.append(0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mh.score(frames)
            totals.append((time.perf_counter() - t0) * 1e3)
    finally:
        for key, fn in saved.items():
            setattr(*key, fn)
    out = {name: statistics.median(v) for name, v in spans.items()}
    out["the whole call"] = statistics.median(totals)
    out["the rest"] = out["the whole call"] - sum(statistics.median(v) for v in spans.values())
    return out


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from fastdnn_tpu_torch import (
        BeamDecoder,
        EngineConfig,
        Scorer,
        quantize_net,
        random_lexicon,
        random_net,
    )
    from fastdnn_tpu_torch.engine import cuda_backend
    from fastdnn_tpu_torch.ops import _build, kernels
    from fastdnn_tpu_torch.ops import matmul as plain
    from fastdnn_tpu_torch.ops.sigmoid import reference_lut_lookup

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)

    phase("1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"  torch.cuda.get_device_name: {kind}")
    print(f"  nvidia-smi name, power.limit: {smi}")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase("2. build the kernels (nvcc, sm_90a)")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"  {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line or "setmaxnreg" in line:
            print(f"  ptxas: {line.strip()}")
    lib = _build.load()
    seats = [lib.fdn_hidden_stack_wgmma_max_clusters(HIDDEN, c, 0) for c in (1, 2)]
    print(f"  K3 wgmma loop, H = {HIDDEN}: clusters of 1 / 2 blocks seated at once: "
          f"{seats[0]} / {seats[1]} (B = 8192 needs 128 / 64)")
    print(f"  K4 wgmma loop, K = {HIDDEN}: clusters of 2 blocks seated at once: "
          f"{lib.fdn_resident_softmax_wgmma_max_clusters(HIDDEN, 0)} (B = 8192 has 128)")

    report = {name: {"max_abs_err": None, "ms": None, "plain_ms": None} for name in kernels.KERNELS}
    path_launches = dict.fromkeys(kernels.KERNELS, 0)

    def drive(title: str, expect, fn):
        """Run one path with every launch count set to 0 just before, check
        each count exactly just after, and add them to the path's totals.
        `expect` is the counts, or a function of the path's result that
        gives them (a stream launches once per batch it formed)."""
        kernels.reset_launch_counts()
        result = fn()
        counts = kernels.launch_counts()
        if callable(expect):
            expect = expect(result)
        print(f"  launch counts of {title}: {counts}")
        for name, count in counts.items():
            check(count == expect.get(name, 0),
                  f"{title}: {name} launched {count} times (expected {expect.get(name, 0)})")
            path_launches[name] += count
        return result

    phase("3. K1 quantized sigmoid, exhaustive against the reference table")
    k = np.arange(-640, 641, dtype=np.float64)
    half_steps = np.arange(-641, 641, dtype=np.float64) + 0.5
    x = np.concatenate([
        k / 100.0,
        half_steps / 100.0,
        half_steps / 100.0 - 1e-6,
        half_steps / 100.0 + 1e-6,
    ]).astype(np.float32)
    lin = torch.from_numpy(x)[None, :].to(dev)
    zero_bias = torch.zeros(x.size, dtype=torch.float32, device=dev)
    got = kernels.bias_sigmoid_i8(lin, zero_bias).cpu().numpy()[0].astype(np.int32)
    want = reference_lut_lookup(x).astype(np.int32) - 128
    check(np.array_equal(got[:1281], want[:1281]), "K1 equals the reference LUT - 128 at all 1281 table inputs")
    check(np.array_equal(got, want), f"K1 equals the reference LUT - 128 at {x.size - 1281} half-step-boundary inputs")
    check(np.array_equal(got, plain.bias_sigmoid_i8(lin, zero_bias).cpu().numpy()[0]),
          "K1 equals its plain version on the same inputs")

    phase("4. each kernel against its plain version at the flagship shapes")
    rng = np.random.default_rng(SEED)
    net = random_net(rng, INPUT_DIM, [HIDDEN] * DEPTH, SENONES)
    qnet = quantize_net(net)
    frames = rng.standard_normal((8320, INPUT_DIM), dtype=np.float32)
    scorer = Scorer(qnet, EngineConfig(), device="cuda")
    reference = Scorer(qnet, EngineConfig(backend="torch"), device="cuda")
    check(scorer.backend == "cuda" and reference.backend == "torch", "kernel and plain scorers built")
    # kernel operands: the scorer's padded net in the kernels' weight layout;
    # plain operands: the plain scorer's net as quantized
    q, r = scorer.net, reference.net
    frames_dev = torch.from_numpy(frames).to(dev)

    lin = plain.matmul_f32(frames_dev[:8192], r.input_w)
    k1 = kernels.bias_sigmoid_i8(lin, r.input_b)
    check(torch.equal(k1, plain.bias_sigmoid_i8(lin, r.input_b)),
          f"K1 bias_sigmoid_i8 [8192, {r.input_w.shape[1]}] bitwise")
    # the 16-column vector path (N a multiple of 16), every row's scalar
    # tail and the misaligned rows: N = 5127 puts every row after the first
    # off a 16-byte boundary, and a slice of a larger buffer 4 bytes past one
    # puts every row there
    k1_rng = np.random.default_rng(SEED + 1)
    k1_buf = torch.from_numpy(k1_rng.uniform(-8, 8, 8192 * SENONES + 1).astype(np.float32)).to(dev)
    k1_cases = {
        f"[8192, {SENONES}]": k1_buf[:8192 * SENONES].view(8192, SENONES),
        "[3, 5127]": k1_buf[:3 * 5127].view(3, 5127),
        "[3, 5127], base 4 bytes past a 16-byte boundary": k1_buf[1:1 + 3 * 5127].view(3, 5127),
        "[64, 2048], base 4 bytes past a 16-byte boundary": k1_buf[1:1 + 64 * 2048].view(64, 2048),
        "[1, 1]": k1_buf[:1].view(1, 1),
        "[0, 2048]": k1_buf[:0].view(0, 2048),
    }
    for what, x_k1 in k1_cases.items():
        b_k1 = torch.from_numpy(
            (k1_rng.standard_normal(x_k1.shape[1]) * 0.5).astype(np.float32)).to(dev)
        got = kernels.bias_sigmoid_i8(x_k1, b_k1)
        check(got.shape == x_k1.shape and torch.equal(got, plain.bias_sigmoid_i8(x_k1, b_k1)),
              f"K1 bias_sigmoid_i8 {what} bitwise")
    report["bias_sigmoid_i8"]["max_abs_err"] = 0.0

    # K9 against its plain version (the f64 product rounded once to f32):
    # the flagship input layer, K_in = 429 (frames padded to 432 for TMA) and
    # H = 3072, seeded apart from the net
    k9 = kernels.input_layer(frames_dev[:8192], q.input_w, q.input_operand, q.input_b)
    p9 = plain.input_layer_step(frames_dev[:8192], r.input_w, r.input_b)
    shares = [count_gate(k9, p9, f"K9 input_layer [8192, {INPUT_DIM}] x [{INPUT_DIM}, {HIDDEN}]")]
    in_rng = np.random.default_rng(SEED + 9)
    for k_in, h in ((429, HIDDEN), (INPUT_DIM, 3072)):
        w_in = torch.from_numpy(in_rng.standard_normal((k_in, h), dtype=np.float32)
                                * np.float32(k_in ** -0.5)).to(dev)
        b_in = torch.from_numpy((in_rng.standard_normal(h) * 0.1).astype(np.float32)).to(dev)
        x_in = torch.from_numpy(in_rng.standard_normal((8192, k_in), dtype=np.float32)).to(dev)
        got = kernels.input_layer(x_in, w_in, kernels.input_layer_operand(w_in), b_in)
        shares.append(count_gate(got, plain.input_layer_step(x_in, w_in, b_in),
                                 f"K9 input_layer [8192, {k_in}] x [{k_in}, {h}]"))
    report["input_layer"]["max_abs_err"] = 1.0 if max(shares) > 0 else 0.0

    acts = plain.input_layer_step(frames_dev, r.input_w, r.input_b)
    layer = (q.weights[0], q.colsum128[0], q.inv_scales[0], q.biases[0])
    plain_layer = (r.weights[0], r.colsum128[0], r.inv_scales[0], r.biases[0])
    # K2 bitwise: the flagship layer, a non-square one and the wide net's
    # 3072 x 3072; 64 frames, 129 blocks of 64 (clusters of 1) and 130
    # (clusters of 2)
    layer_rng = np.random.default_rng(SEED + 2)
    k2_cases = [(HIDDEN, HIDDEN, acts, layer, plain_layer)]
    for k_dim, n_dim in ((384, 640), (WIDE_HIDDEN, WIDE_HIDDEN)):
        w, colsum, inv, bias = random_layer(layer_rng, k_dim, n_dim)
        w_dev, colsum_dev, bias_dev = (torch.from_numpy(a).to(dev) for a in (w, colsum, bias))
        a = torch.from_numpy(layer_rng.integers(-128, 128, (8320, k_dim), dtype=np.int8)).to(dev)
        k2_cases.append((k_dim, n_dim, a, (kernels.kernel_layout(w_dev), colsum_dev, inv, bias_dev),
                         (w_dev, colsum_dev, inv, bias_dev)))
    for k_dim, n_dim, a, args, plain_args in k2_cases:
        for b in (64, 8256, 8320):
            check(torch.equal(kernels.hidden_layer(a[:b], *args),
                              plain.hidden_layer_step(a[:b], *plain_args)),
                  f"K2 hidden_layer B={b} K={k_dim} N={n_dim}: bitwise")
    report["hidden_layer"]["max_abs_err"] = 0.0

    hstack, plain_hstack = scorer._hstack, reference._hstack
    k3 = kernels.hidden_stack(acts[:8192], *hstack)
    p3 = plain.hidden_stack_step(acts[:8192], plain_hstack)
    d3 = int((k3.int() - p3.int()).abs().max())
    check(d3 == 0, f"K3 hidden_stack B=8192 L={hstack[0].shape[0]} H={HIDDEN} bitwise (max |d| = {d3})")
    # 127 blocks of 64 frames: clusters of 1
    check(torch.equal(kernels.hidden_stack(acts[:8128], *hstack), p3[:8128]),
          "K3 B=8128 (clusters of 1): bitwise")
    # the widest stack the gate lets through, seeded apart from the net
    wide_rng = np.random.default_rng(SEED + 4)
    h_max = kernels.HIDDEN_STACK_MAX_H
    stack_max = [torch.from_numpy(a).to(dev) for a in random_stack(wide_rng, DEPTH - 1, h_max)]
    acts_max = torch.from_numpy(wide_rng.integers(-128, 128, (8192, h_max), dtype=np.int8)).to(dev)
    k3_max = kernels.hidden_stack(acts_max, kernels.kernel_layout(stack_max[0]), *stack_max[1:])
    p3_max = plain.hidden_stack_step(acts_max, tuple(stack_max))
    check(torch.equal(k3_max, p3_max), f"K3 hidden_stack B=8192 L={DEPTH - 1} H={h_max} bitwise")
    report["hidden_stack"]["max_abs_err"] = float(d3)

    out = (q.weights[-1], q.colsum128[-1], q.inv_scales[-1], q.biases[-1])
    plain_out = (r.weights[-1], r.colsum128[-1], r.inv_scales[-1], r.biases[-1])
    k4 = kernels.resident_softmax(p3, *out, out_dim=SENONES)
    p4 = plain.output_posteriors(p3, *plain_out, out_dim=SENONES)
    d4 = float((k4 - p4).abs().max())
    sums = k4.double().sum(dim=1)
    check(d4 <= 3e-5, f"K4 resident_softmax B=8192 K={HIDDEN} N={out[0].shape[0]} max |d| = {d4:.3g} <= 3e-5")
    check(float((sums - 1).abs().max()) <= 1e-5, "K4 row sums are 1 +- 1e-5")
    check(torch.equal(k4.argmax(1), p4.argmax(1)), "K4 argmax equals the plain version's")
    k4_64 = kernels.resident_softmax(p3[:64], *out, out_dim=SENONES)
    d4_64 = float((k4_64 - plain.output_posteriors(p3[:64], *plain_out, out_dim=SENONES)).abs().max())
    check(d4_64 <= 3e-5, f"K4 B=64 (one cluster) max |d| = {d4_64:.3g} <= 3e-5")
    d4 = max(d4, d4_64)
    d = float((kernels.resident_softmax(p3[:8128], *out, out_dim=SENONES) - p4[:8128]).abs().max())
    check(d <= 3e-5, f"K4 B=8128 (127 clusters) max |d| = {d:.3g} <= 3e-5")
    d4 = max(d4, d)
    report["resident_softmax"]["max_abs_err"] = d4

    phase("5. main path: Scorer.score on the 432-7x2048-8000 net")
    sizes = (1000, 8192, 8300)  # 8300 buckets to 8320 > 8192: per-layer trunk
    want_p = {n: reference.score(frames[:n]) for n in sizes}
    dense_expect = {"input_layer": 3, "hidden_stack": 2, "hidden_layer": DEPTH - 1,
                    "resident_softmax": 3}
    got_p = drive("the main-path run", dense_expect,
                  lambda: {n: scorer.score(frames[:n]) for n in sizes})
    for n in sizes:
        got, want = got_p[n], want_p[n]
        check(got.shape == (n, SENONES) and got.dtype == np.float32 and bool(np.isfinite(got).all()),
              f"n={n}: finite f32 [{n}, {SENONES}]")
        dp = float(np.abs(got - want).max())
        agree = float((got.argmax(1) == want.argmax(1)).mean())
        check(dp <= 1e-4 and agree >= 0.999,
              f"n={n}: max |dp| = {dp:.3g} <= 1e-4, argmax agreement {agree:.4f} >= 0.999")
        check(float(np.abs(got.astype(np.float64).sum(1) - 1).max()) <= 1e-5, f"n={n}: row sums 1 +- 1e-5")

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_p = scorer.score(frames[:1000])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(np.array_equal(tf32_p, got_p[1000]), "the input layer ignores the TF32 switch (bitwise)")

    phase(f"6. times (median of {TIMED_REPS} CUDA-event-timed calls; card: {smi})")
    batch = frames_dev[:8192].contiguous()
    audio_s = 8192 / FRAMES_PER_AUDIO_SECOND
    a3 = acts[:8192]

    # in turns: plain, kernels, kernels, plain (K9: plain, f64 + K1, K9, ...)
    route = {  # the input layer before K9: the f64 product, then K1
        "plain": lambda: plain.input_layer_step(batch, r.input_w, r.input_b),
        "f64 product + K1": lambda: kernels.bias_sigmoid_i8(plain.matmul_f32(batch, q.input_w),
                                                            q.input_b),
        "K9": lambda: kernels.input_layer(batch, q.input_w, q.input_operand, q.input_b),
    }
    turn_cases = {
        "input_layer": route,
        "score_device": {"plain": lambda: reference.score_device(batch),
                         "kernels": lambda: scorer.score_device(batch)},
        "hidden_stack": {"plain": lambda: plain.hidden_stack_step(a3, plain_hstack),
                         "kernels": lambda: kernels.hidden_stack(a3, *hstack)},
        "resident_softmax": {
            "plain": lambda: plain.output_posteriors(p3, *plain_out, out_dim=SENONES),
            "kernels": lambda: kernels.resident_softmax(p3, *out, out_dim=SENONES)},
    }
    turn_ms = {}
    for what, fns in turn_cases.items():
        times = in_turns(torch, fns)
        turn_ms[what] = {name: sum(t) / len(t) for name, t in times.items()}
        print(f"  {what:16s} in turns: " + ", ".join(
            f"{name} {t[0]:.4f} / {t[1]:.4f}" for name, t in times.items()) + f" ms  [{smi}]")
    for name in ("hidden_stack", "resident_softmax"):
        report[name]["ms"], report[name]["plain_ms"] = turn_ms[name]["kernels"], turn_ms[name]["plain"]
    report["input_layer"]["ms"] = turn_ms["input_layer"]["K9"]
    report["input_layer"]["plain_ms"] = turn_ms["input_layer"]["plain"]
    # the trunk above 8192 frames: K2 at B = 8320, and score_device there
    # against B = 8192 (the stack)
    k2_times = in_turns(torch, {"plain": lambda: plain.hidden_layer_step(acts, *plain_layer),
                                "K2": lambda: kernels.hidden_layer(acts, *layer)})
    print(f"  hidden_layer B=8320 K=N={HIDDEN} in turns: " + ", ".join(
        f"{name} {t[0]:.4f} / {t[1]:.4f}" for name, t in k2_times.items()) + f" ms  [{smi}]")
    report["hidden_layer"]["ms"] = sum(k2_times["K2"]) / 2
    report["hidden_layer"]["plain_ms"] = sum(k2_times["plain"]) / 2
    times = in_turns(torch, {"B=8192": lambda: scorer.score_device(batch),
                             "B=8320": lambda: scorer.score_device(frames_dev)})
    print("  score_device in turns: " + ", ".join(
        f"{name} {t[0]:.4f} / {t[1]:.4f}" for name, t in times.items())
        + f" ms (B=8320 runs the per-layer trunk)  [{smi}]")
    # K3 against the six K2 launches it replaces, over B (the stack threshold)
    six_layers = [(hstack[0][i], hstack[1][i], float(hstack[2][i]), hstack[3][i])
                  for i in range(hstack[0].shape[0])]

    def per_layer(x):
        for args in six_layers:
            x = kernels.hidden_layer(x, *args)
        return x

    check(torch.equal(per_layer(acts[:1024]), kernels.hidden_stack(acts[:1024], *hstack)),
          "six K2 launches equal one K3 launch (B=1024)")
    for b in (1024, 4096, 8192):
        times = in_turns(torch, {"K3": lambda b=b: kernels.hidden_stack(acts[:b], *hstack),
                                 "6 x K2": lambda b=b: per_layer(acts[:b])})
        print(f"  trunk B={b:4d} in turns: " + ", ".join(
            f"{name} {t[0]:.4f} / {t[1]:.4f}" for name, t in times.items()) + f" ms  [{smi}]")
    for name, ms in turn_ms["score_device"].items():
        print(f"  score_device B=8192 {name:8s} {ms:.4f} ms/batch, {audio_s / ms * 1e3:.1f} audio-s/s"
              f"  [{smi}]")
    # K1: single calls (the wrapper's host time included), 20 queued back to
    # back, under the profiler, and the wrapper's host time alone
    k1_fn = lambda: kernels.bias_sigmoid_i8(lin, r.input_b)  # noqa: E731
    report["bias_sigmoid_i8"]["ms"] = time_ms(torch, k1_fn)
    report["bias_sigmoid_i8"]["plain_ms"] = time_ms(torch, lambda: plain.bias_sigmoid_i8(lin, r.input_b))
    k1_queued = back_to_back_ms(torch, k1_fn)
    _, device = profile_device(torch, k1_fn, 20)
    k1_traced = (f"{sum(row[1] for row in device):.4f} ms under the profiler"
                 if device else "profiler: no device time recorded")
    k1_fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        k1_fn()
    k1_host_us = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    print(f"  bias_sigmoid_i8 [8192, 2048] single {report['bias_sigmoid_i8']['ms']:.4f} ms, 20 queued "
          f"{k1_queued:.4f} ms per call, {k1_traced}; wrapper host time {k1_host_us:.2f} us per call "
          f"(mean of 2000); plain {report['bias_sigmoid_i8']['plain_ms']:.4f} ms  [{smi}]")
    k1_wide = k1_cases[f"[8192, {SENONES}]"]
    k1_wide_bias = torch.zeros(SENONES, dtype=torch.float32, device=dev)
    print(f"  bias_sigmoid_i8 [8192, {SENONES}] 20 queued "
          f"{back_to_back_ms(torch, lambda: kernels.bias_sigmoid_i8(k1_wide, k1_wide_bias)):.4f} "
          f"ms per call (bound {8192 * SENONES * 5 / HBM_BYTES_PER_S * 1e3:.4f} ms)  [{smi}]")
    # where score_device's device time goes, and how much of a window of
    # back-to-back calls the device is busy (torch.profiler, CUPTI): at B =
    # 8192 (the stack trunk) and 8320 (six K2 launches)
    calls = 10
    for frames_in in (batch, frames_dev):
        b = frames_in.shape[0]
        window_ms, device = profile_device(torch, lambda: scorer.score_device(frames_in), calls)
        if not device:
            print(f"  score_device B={b} under torch.profiler: no device time recorded; idle share "
                  "not measured")
            continue
        busy = sum(ms for _, ms in device) / window_ms
        print(f"  score_device B={b} under torch.profiler ({calls} calls, host window "
              f"{window_ms:.4f} ms/call): device busy {busy:.1%}, idle {1 - busy:.1%}  [{smi}]")
        for name, ms in sorted(device, key=lambda row: -row[1]):
            print(f"    {ms:.4f} ms/call  {name[:100]}")
        library = [name for name, _ in device if re.search("gemm|copy|cast|convert", name, re.I)]
        check(not library, f"score_device B={b} runs no library product and no cast kernel on the "
                           f"device ({len(device)} kernels)")

    phase("7. K4 masked and bf16, K5, K6 against their plain versions at the flagship shapes")
    n_pad = out[0].shape[0]
    masks_host = (rng.random((8320, SENONES), dtype=np.float32) < LAZY_DENSITY).astype(np.uint8)
    masks_host[7] = 0  # a frame with no active senone
    bands_host = band_masks(rng, 8192)

    def device_masks(m):
        return torch.nn.functional.pad(torch.from_numpy(m).to(dev), (0, n_pad - SENONES))

    masks40, bands = device_masks(masks_host[:8192]), device_masks(bands_host)
    skip40, skip_bands = kernels.block_skip_share(masks40), kernels.block_skip_share(bands)
    print(f"  masks: uniform {LAZY_DENSITY:.0%} (density {float(masks40.float().mean()):.4f}, "
          f"K6 skip share {skip40:.4f}); bands (density {float(bands.float().mean()):.4f}, "
          f"K6 skip share {skip_bands:.4f})")
    for sem in ("reference", "active_only"):
        p4m = plain.output_posteriors(p3, *plain_out, masks40, out_dim=SENONES, semantics=sem)
        k4m = kernels.resident_softmax(p3, *out, masks40, out_dim=SENONES, semantics=sem)
        d = float((k4m - p4m).abs().max())
        check(d <= 3e-5, f"K4 masked {sem} B=8192 N={n_pad} max |d| = {d:.3g} <= 3e-5")
        check(torch.equal(k4m.argmax(1), p4m.argmax(1)), f"K4 masked {sem}: argmax equal")
        if sem == "active_only":
            check(bool((k4m[7] == 0).all()) and bool((k4m[masks40[:, :SENONES] == 0] == 0).all()),
                  "K4 active_only: inactive senones and the fully masked row are exactly 0")
        else:
            check(float((k4m[7] - 1.0 / SENONES).abs().max()) <= 1e-9,
                  "K4 reference: the fully masked row is uniform")
        report["resident_softmax"]["max_abs_err"] = max(report["resident_softmax"]["max_abs_err"], d)
    for m, what in ((None, "unmasked"), (masks40, "masked reference")):
        p4 = plain.output_posteriors(p3, *plain_out, m, out_dim=SENONES)
        k4f = kernels.resident_softmax(p3, *out, m, out_dim=SENONES, fast=True)
        df = float((k4f.float() - p4).abs().max())
        check(k4f.dtype == torch.bfloat16 and bool(torch.allclose(k4f.float(), p4, rtol=BF16_RTOL, atol=BF16_ATOL)),
              f"K4 fast {what}: bf16 within rtol {BF16_RTOL}, atol {BF16_ATOL} of the plain f32 "
              f"(max |d| = {df:.3g})")
    # K5 writes the padded width: its plain version takes the same padded
    # operands, the weight back in the plain layout
    plain_out_padded = (out[0].t(), *out[1:])
    for b in (64, 8128, 8192):  # one frame block (columns split), clusters of 1 and of 2
        k5 = kernels.output_logits(p3[:b], *out)
        p5 = plain.output_logits(p3[:b], *plain_out_padded)
        check(k5.shape == (b, n_pad) and torch.equal(k5, p5), f"K5 output_logits B={b} N={n_pad} bitwise")
    report["output_logits"]["max_abs_err"] = 0.0
    report["resident_softmax_block_sparse"]["max_abs_err"] = 0.0
    # K6 on both mask sets with the 64-frame block at rows 128-191 all
    # masked (every one of its tiles skipped), the 40% set keeping its
    # fully masked row 7; and with out_dim 7990, which ends inside the last
    # column tile (not a multiple of 4: the sweep's 4-byte path)
    blocked = 128
    for m, what in ((masks40, "40% masks"), (bands, "band masks")):
        m = m.clone()
        m[blocked:blocked + kernels.RESIDENT_SOFTMAX_FRAMES] = 0
        for sem in ("reference", "active_only"):
            for od in (SENONES, SENONES - 10):
                k6 = kernels.resident_softmax_block_sparse(p3, *out, m, out_dim=od, semantics=sem)
                p6 = plain.output_posteriors_block_sparse(p3, *plain_out, m, out_dim=od,
                                                          semantics=sem)
                d6 = float((k6 - p6).abs().max())
                check(d6 <= 3e-5 and torch.equal(k6.argmax(1), p6.argmax(1)),
                      f"K6 {what} {sem} B=8192 out_dim={od} max |d| = {d6:.3g} <= 3e-5, argmax equal")
                report["resident_softmax_block_sparse"]["max_abs_err"] = max(
                    report["resident_softmax_block_sparse"]["max_abs_err"], d6)
                block = k6[blocked:blocked + kernels.RESIDENT_SOFTMAX_FRAMES]
                if sem == "active_only":
                    row7 = what == "40% masks"  # its fully masked frame
                    check(bool((block == 0).all()) and (not row7 or bool((k6[7] == 0).all())),
                          f"K6 {what} active_only out_dim={od}: the masked frame block"
                          f"{' and row 7 are' if row7 else ' is'} exactly 0")
                else:
                    du = float((block - 1.0 / od).abs().max())
                    check(du <= 1e-9, f"K6 {what} reference out_dim={od}: the masked frame block is "
                                      f"uniform 1/{od} (max |d| = {du:.3g})")

    phase("8. lazy path: score_masked, block-sparse, gathered, LazyContext beam decode")
    semantics_scorers = {
        "reference": (scorer, reference),
        "active_only": (Scorer(qnet, EngineConfig(lazy_semantics="active_only"), device="cuda"),
                        Scorer(qnet, EngineConfig(backend="torch", lazy_semantics="active_only"),
                               device="cuda")),
    }
    for sem, (lazy, plain_lazy) in semantics_scorers.items():
        want_m = {n: plain_lazy.score_masked(frames[:n], masks_host[:n]) for n in sizes}
        got_m = drive(f"score_masked {sem}", dense_expect,
                      lambda: {n: lazy.score_masked(frames[:n], masks_host[:n]) for n in sizes})
        for n in sizes:
            close(got_m[n], want_m[n], f"score_masked {sem} n={n}")
        if sem == "active_only":
            check(bool((got_m[8192][7] == 0).all()), "score_masked active_only: the fully masked row is 0")

    sparse = Scorer(qnet, EngineConfig(lazy_mode="block_sparse"), device="cuda")
    sparse_sizes = (1000, 8192)
    want_b = {n: reference.score_masked(frames[:n], bands_host[:n]) for n in sparse_sizes}
    got_b = drive("score_masked block_sparse",
                  {"input_layer": 2, "hidden_stack": 2, "resident_softmax_block_sparse": 2},
                  lambda: {n: sparse.score_masked(frames[:n], bands_host[:n]) for n in sparse_sizes})
    for n in sparse_sizes:
        close(got_b[n], want_b[n], f"score_masked block_sparse n={n} (band masks)")

    gathered = Scorer(qnet, EngineConfig(lazy_mode="gathered"), device="cuda")
    subset = rng.choice(SENONES, SENONES * 3 // 8, replace=False)  # a union the capacity admits
    masks_g = np.zeros((1000, SENONES), np.uint8)
    masks_g[:, subset] = masks_host[:1000, subset]
    got_g = drive("score_masked gathered", {"input_layer": 1, "hidden_stack": 1},
                  lambda: gathered.score_masked(frames[:1000], masks_g))
    close(got_g, reference.score_masked(frames[:1000], masks_g), "score_masked gathered n=1000")

    decoder = BeamDecoder(random_lexicon(np.random.default_rng(3), 30, SENONES), SENONES,
                          beam_width=32, word_exit_beam=4)
    utterance = frames[:DECODE_FRAMES]
    lazy_dec, dense_dec = drive(
        "LazyContext beam decode + dense decode",
        {"input_layer": 2, "hidden_stack": 2, "output_logits": DECODE_FRAMES, "resident_softmax": 1},
        lambda: (decoder.decode_lazy(scorer, utterance), decoder.decode_dense(scorer, utterance)),
    )
    check(lazy_dec.words == dense_dec.words,
          f"LazyContext decode words equal the dense decode's ({len(lazy_dec.words)} words)")
    check(np.array_equal(lazy_dec.masks, dense_dec.masks),
          f"LazyContext decode masks equal the dense decode's (density {lazy_dec.avg_density:.4f}, "
          f"churn {lazy_dec.avg_churn:.4f})")

    phase(f"9. lazy times (median of {TIMED_REPS} CUDA-event-timed calls; card: {smi})")
    masks_dev = torch.from_numpy(masks_host[:8192]).to(dev)
    masked_ms = time_ms(torch, lambda: scorer._run_masked(batch, masks_dev))
    plain_masked_ms = time_ms(torch, lambda: reference._run_masked(batch, masks_dev))
    print(f"  score_masked B=8192 {LAZY_DENSITY:.0%} kernels: {masked_ms:.4f} ms/batch, "
          f"{audio_s / masked_ms * 1e3:.1f} audio-s/s  [{smi}]")
    print(f"  score_masked B=8192 {LAZY_DENSITY:.0%} plain:   {plain_masked_ms:.4f} ms/batch, "
          f"{audio_s / plain_masked_ms * 1e3:.1f} audio-s/s  [{smi}]")
    bands_dev = torch.from_numpy(bands_host).to(dev)
    times = in_turns(torch, {"dense": lambda: scorer._run_masked(batch, bands_dev),
                             "block_sparse": lambda: sparse._run_masked(batch, bands_dev)})
    print("  score_masked B=8192 band masks in turns: " + ", ".join(
        f"{name} {t[0]:.4f} / {t[1]:.4f}" for name, t in times.items()) + f" ms/batch  [{smi}]")
    for sc, what in ((scorer, "kernels"), (reference, "plain")):
        ctx = sc.new_lazy_context(DECODE_FRAMES)
        ctx.calculate_until_output(utterance)
        ctx.calculate_for_output_nodes(lazy_dec.masks[0])  # warm-up
        ctx.calculate_until_output(utterance)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for m in lazy_dec.masks:
            ctx.calculate_for_output_nodes(m)
        per_frame = (time.perf_counter() - t0) * 1e3 / DECODE_FRAMES
        print(f"  LazyContext.calculate_for_output_nodes {what}: {per_frame:.4f} ms/frame "
              f"(host clock, numpy in and out)  [{smi}]")
    # K4's masked and bf16 variants, in turns with their plain versions
    for title, kw in (("masked reference", {}), ("masked active_only", {"semantics": "active_only"}),
                      ("fast masked reference", {"fast": True})):
        times = in_turns(torch, {
            "plain": lambda kw=kw: plain.output_posteriors(p3, *plain_out, masks40, out_dim=SENONES, **kw),
            "kernel": lambda kw=kw: kernels.resident_softmax(p3, *out, masks40, out_dim=SENONES, **kw)})
        print(f"  K4 {title:22s} in turns: " + ", ".join(
            f"{name} {t[0]:.4f} / {t[1]:.4f}" for name, t in times.items()) + f" ms  [{smi}]")
    # K6 in turns with the kernels that compute the same posteriors (K4
    # masked) or its stats (K8 skipping) on the same masks; the JSON row
    # reports the band masks, which K6 is meant for
    for m, what in ((masks40, "40% masks"), (bands, "band masks")):
        fns = {
            "K6": lambda m=m: kernels.resident_softmax_block_sparse(p3, *out, m, out_dim=SENONES),
            "K4 masked": lambda m=m: kernels.resident_softmax(p3, *out, m, out_dim=SENONES),
            "K8 skipping": lambda m=m: kernels.flash_stats_block_sparse(p3, *out, m,
                                                                        valid_count=SENONES)}
        times = in_turns(torch, {"plain": lambda m=m: plain.output_posteriors_block_sparse(
            p3, *plain_out, m, out_dim=SENONES), **fns})
        print(f"  K6 {what:10s} in turns: " + ", ".join(
            f"{name} {t[0]:.4f} / {t[1]:.4f}" for name, t in times.items()) + f" ms  [{smi}]")
        queued = in_turns(torch, fns, back_to_back_ms)
        print(f"  K6 {what:10s} 20 back to back, in turns: " + ", ".join(
            f"{name} {t[0]:.4f} / {t[1]:.4f}" for name, t in queued.items()) + f" ms per call  [{smi}]")
        report["resident_softmax_block_sparse"]["ms"] = sum(times["K6"]) / 2
        report["resident_softmax_block_sparse"]["plain_ms"] = sum(times["plain"]) / 2
    # K5 single, 20 queued back to back (no wrapper host time) and its
    # device time under the profiler; the last B is the one the JSON row
    # reports: the LazyContext shape
    k5_ms = {}
    for b in (8192, 64):
        kernel_fn = lambda b=b: kernels.output_logits(p3[:b], *out)
        plain_fn = lambda b=b: plain.output_logits(p3[:b], *plain_out_padded)
        ms, plain_ms = time_ms(torch, kernel_fn), time_ms(torch, plain_fn)
        queued_ms = back_to_back_ms(torch, kernel_fn)
        _, device = profile_device(torch, kernel_fn, 20)
        traced = (f"{sum(row[1] for row in device):.4f} ms under the profiler ({len(device)} kernel)"
                  if device else "profiler: no device time recorded")
        report["output_logits"]["ms"], report["output_logits"]["plain_ms"] = ms, plain_ms
        k5_ms[b] = ms
        print(f"  K5 output_logits B={b:4d}: single {ms:.4f} ms, 20 queued {queued_ms:.4f} ms per "
              f"call, {traced}; plain {plain_ms:.4f} ms  [{smi}]")
    # the B = 64 call is host time: the part of it each wrapper spends on its
    # shared-memory check, and the whole wrapper, on the host clock
    calls = 5000
    host_us = {}
    for what, fn in (("shared-memory check", lambda: kernels._require_smem(
            "output_logits", dev, lib.fdn_output_logits_smem_bytes())),
            ("K5 wrapper, B=64 (launch not awaited)", lambda: kernels.output_logits(p3[:64], *out))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_us[what] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    print("  host time per call (mean of 5000): " + ", ".join(
        f"{what} {us:.2f} us" for what, us in host_us.items()) + f"  [{smi}]")

    phase("10. K7 packed int4 hidden layer against its plain version and against K2")
    q4 = quantize_net(net, hidden_bits=4)
    int4 = Scorer(q4, EngineConfig(), device="cuda")
    packed4 = Scorer(q4, EngineConfig(int4_packed=True), device="cuda")
    plain_packed4 = Scorer(q4, EngineConfig(backend="torch", int4_packed=True), device="cuda")
    check(packed4.net.packed_int4 and packed4._hstack is None and int4._hstack is not None,
          "int4 scorers built: the packed one has no hidden stack")
    check(tuple(packed4.net.weights[0].shape) == (HIDDEN, HIDDEN // 2),
          f"packed layer in the kernels' layout [{HIDDEN}, {HIDDEN // 2}]")
    acts4 = plain.input_layer_step(frames_dev, r.input_w, r.input_b)  # same input layer as int8
    pnet = packed4.net
    q7 = (pnet.weights[0], pnet.colsum128[0], pnet.inv_scales[0], pnet.biases[0])
    p7_args = (plain_packed4.net.weights[0], *q7[1:])
    k2_args = (int4.net.weights[0], *q7[1:])
    k7 = kernels.hidden_layer_packed(acts4, *q7)
    p7 = plain.hidden_layer_step_packed(acts4, *p7_args)
    k2_4 = kernels.hidden_layer(acts4, *k2_args)
    d7 = int((k7.int() - p7.int()).abs().max())
    check(d7 == 0, f"K7 hidden_layer_packed B=8320 K=N={HIDDEN} (packed [{HIDDEN // 2}, {HIDDEN}]) "
                   f"bitwise with its plain version (max |d| = {d7})")
    check(torch.equal(k7, k2_4), "K7 bitwise with K2 on the same int4 values held unpacked")
    check(torch.equal(kernels.hidden_layer_packed(acts4[:64], *q7), p7[:64]),
          "K7 B=64 (one frame block, its columns split over the SMs) bitwise")
    report["hidden_layer_packed"]["max_abs_err"] = float(d7)
    # packed halves of 192 and 64 bytes: not a multiple of K7's 128-byte stage
    for width in (384, 128):
        narrow = quantize_net(random_net(rng, INPUT_DIM, [width, width], 400), hidden_bits=4)
        n_packed = Scorer(narrow, EngineConfig(int4_packed=True), device="cuda").net
        n_plain = Scorer(narrow, EngineConfig(backend="torch", int4_packed=True), device="cuda").net
        n_int4 = Scorer(narrow, EngineConfig(), device="cuda").net
        a_n = torch.from_numpy(rng.integers(-128, 128, (8320, width)).astype(np.int8)).to(dev)
        layer_n = (n_packed.colsum128[0], n_packed.inv_scales[0], n_packed.biases[0])
        k7n = kernels.hidden_layer_packed(a_n, n_packed.weights[0], *layer_n)
        check(torch.equal(k7n, plain.hidden_layer_step_packed(a_n, n_plain.weights[0], *layer_n)),
              f"K7 B=8320 K=N={width} (packed half {width // 2}) bitwise with its plain version")
        check(torch.equal(k7n, kernels.hidden_layer(a_n, n_int4.weights[0], *layer_n)),
              f"K7 K=N={width} bitwise with K2 on the same int4 values")

    phase("11. int4 trunk: Scorer.score on the 432-7x2048-8000 int4 net, packed and unpacked")
    plain_int4 = Scorer(q4, EngineConfig(backend="torch"), device="cuda")
    want4 = {n: plain_int4.score(frames[:n]) for n in sizes}
    want4p = {n: plain_packed4.score(frames[:n]) for n in sizes}
    for n in sizes:
        check(np.array_equal(want4[n], want4p[n]), f"n={n}: plain packed and unpacked int4 equal")
    got4 = drive("int4 unpacked", dense_expect, lambda: {n: int4.score(frames[:n]) for n in sizes})
    got4p = drive("int4 packed", {"input_layer": 3, "hidden_layer_packed": 3 * (DEPTH - 1),
                                  "resident_softmax": 3},
                  lambda: {n: packed4.score(frames[:n]) for n in sizes})
    for n in sizes:
        close(got4[n], want4[n], f"int4 unpacked n={n}")
        close(got4p[n], want4[n], f"int4 packed n={n}")
    d48 = float(np.abs(got4[8192] - got_p[8192]).max())
    agree48 = float((got4[8192].argmax(1) == got_p[8192].argmax(1)).mean())
    print(f"  int4 against int8 posteriors at n=8192: max |dp| = {d48:.4g}, "
          f"argmax agreement {agree48:.4f} (a different quantization, not a bound)")

    phase("12. command line: Kaldi text -> convert model -> convert quantize --hidden-bits 4 -> score")
    from fastdnn_tpu_torch import load_qnet, read_features, to_raw
    from fastdnn_tpu_torch.cli import convert as convert_cli
    from fastdnn_tpu_torch.cli import score as score_cli
    from fastdnn_tpu_torch.formats.kaldi_text import write_features_text_kaldi

    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    SMOKE_DIR.mkdir(parents=True)
    try:
        raw = to_raw(random_net(rng, INPUT_DIM, [CLI_HIDDEN] * CLI_DEPTH, CLI_SENONES))
        (SMOKE_DIR / "nnet.txt").write_text(network_text(raw))
        (SMOKE_DIR / "transform.txt").write_text(transform_text(raw))
        cli_frames = rng.standard_normal((CLI_FRAMES, INPUT_DIM), dtype=np.float32)
        write_features_text_kaldi({"utt-0": cli_frames}, SMOKE_DIR / "feats.txt")

        def f(name: str) -> str:
            return str(SMOKE_DIR / name)

        check(convert_cli.main(["model", f("nnet.txt"), f("transform.txt"), f("m.bin"),
                                "--extend", str(HIDDEN), str(SENONES)]) == 0,
              f"convert model (text {INPUT_DIM}-{CLI_DEPTH - 1}x{CLI_HIDDEN}-{CLI_SENONES}, "
              f"--extend {HIDDEN} {SENONES})")
        check(convert_cli.main(["quantize", f("m.bin"), f("q4.npz"), "--hidden-bits", "4"]) == 0,
              "convert quantize --hidden-bits 4")
        check(convert_cli.main(["features", f("feats.txt"), f("feats.bin")]) == 0, "convert features")
        cli_depth = CLI_DEPTH - 1  # hidden-to-hidden layers of the extended net
        drive("score --device cuda --int4-packed (warm-up call + scoring call)",
              {"input_layer": 2, "hidden_layer_packed": 2 * cli_depth, "resident_softmax": 2},
              lambda: check(score_cli.main([f("q4.npz"), f("feats.bin"), f("post.bin"), "BIN",
                                            "--device", "cuda", "--int4-packed"]) == 0,
                            "score --device cuda --int4-packed"))
        q_cli = load_qnet(f("q4.npz"))
        check(q_cli.hidden_bits == 4 and q_cli.layer_dims() == [HIDDEN] * CLI_DEPTH + [SENONES],
              f"the checkpoint is the int4 {INPUT_DIM}-{cli_depth}x{HIDDEN}-{SENONES} net")
        want_cli = Scorer(q_cli, device="cpu").score(read_features(f("feats.bin")))
        close(read_features(f("post.bin")), want_cli, "CLI posteriors against Scorer(device='cpu')")
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)

    phase(f"13. int4 times (median of {TIMED_REPS} CUDA-event-timed calls; card: {smi})")
    times = in_turns(torch, {"plain": lambda: plain.hidden_layer_step_packed(acts4, *p7_args),
                             "K7": lambda: kernels.hidden_layer_packed(acts4, *q7),
                             "K2 on the same int4 values": lambda: kernels.hidden_layer(acts4, *k2_args)})
    print(f"  hidden_layer_packed B=8320 K=N={HIDDEN} in turns: " + ", ".join(
        f"{name} {t[0]:.4f} / {t[1]:.4f}" for name, t in times.items()) + f" ms  [{smi}]")
    queued = in_turns(torch, {"K7": lambda: kernels.hidden_layer_packed(acts4, *q7),
                              "K2": lambda: kernels.hidden_layer(acts4, *k2_args)}, back_to_back_ms)
    print(f"  hidden_layer_packed B=8320 K=N={HIDDEN} 20 back to back, in turns: " + ", ".join(
        f"{name} {t[0]:.4f} / {t[1]:.4f}" for name, t in queued.items()) + f" ms per call  [{smi}]")
    report["hidden_layer_packed"]["ms"] = sum(times["K7"]) / 2
    report["hidden_layer_packed"]["plain_ms"] = sum(times["plain"]) / 2
    # in turns (int8, unpacked, packed, packed, unpacked, int8), one card, one call
    path_order = (("int8", scorer), ("int4 unpacked", int4), ("int4 packed", packed4))
    path_times = {name: [] for name, _ in path_order}
    for name, sc in path_order + path_order[::-1]:
        path_times[name].append(time_ms(torch, lambda: sc.score_device(batch)))
    for name, ms in path_times.items():
        mean = sum(ms) / len(ms)
        print(f"  score_device B=8192 {name:13s} {ms[0]:.4f} / {ms[1]:.4f} ms/batch, "
              f"{audio_s / mean * 1e3:.1f} audio-s/s  [{smi}]")

    phase("14. K8 flash stats against its plain version at the flagship shapes")
    def stats_check(title, got, want, fast=False, out_dim=SENONES):
        """K8's (z, m, s[, tile_max]) against the plain version's: z, m and
        the tile maxes bitwise, s within rtol 1e-5 -> the posteriors' max |d|
        against the plain normalize of the plain stats."""
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"K8 {title}: z{' (bf16)' if fast else ''} and m bitwise")
        s_rel = float(((got[2] - want[2]).abs() / want[2].abs().clamp(min=1e-30)).max())
        check(s_rel <= 1e-5, f"K8 {title}: s within rtol {s_rel:.3g} <= 1e-5")
        if fast:
            check(torch.equal(got[3], want[3]), f"K8 {title}: tile maxes bitwise")
        tile = (got[3], want[3]) if fast else (None, None)
        p_got = kernels.normalize_stats(*got[:3], out_dim=out_dim, tile_max=tile[0])
        p_want = plain.normalize_stats(*want[:3], out_dim=out_dim, tile_max=tile[1])
        return p_got, float((p_got.float() - p_want.float()).abs().max())

    def normalize_check(title, stats, out_dim=SENONES, zero_rows=()):
        """The normalize kernel against its plain version on the same stats:
        f32 within rtol NORMALIZE_RTOL + atol NORMALIZE_ATOL (the same expf
        and division, so equal on the card), bf16 (fast stats) within
        rtol/atol of the plain bf16; `zero_rows` (no active senone) exactly
        0 -> max |d|."""
        tile = stats[3] if len(stats) == 4 else None
        got = kernels.normalize_stats(*stats[:3], out_dim=out_dim, tile_max=tile)
        want = plain.normalize_stats(*stats[:3], out_dim=out_dim, tile_max=tile)
        d = float((got.float() - want.float()).abs().max())
        if tile is None:
            ok = got.dtype == torch.float32 and bool(torch.allclose(
                got, want, rtol=NORMALIZE_RTOL, atol=NORMALIZE_ATOL))
            bound_text = f"within rtol {NORMALIZE_RTOL:g}, atol {NORMALIZE_ATOL:g}"
        else:
            ok = got.dtype == torch.bfloat16 and bool(torch.allclose(
                got.float(), want.float(), rtol=BF16_RTOL, atol=BF16_ATOL))
            bound_text = f"bf16 within rtol {BF16_RTOL}, atol {BF16_ATOL}"
        zeros = not zero_rows or bool((got[list(zero_rows)] == 0).all())
        check(ok and zeros and got.shape == (stats[0].shape[0], out_dim),
              f"normalize_stats {title} out_dim={out_dim}: max |d| {d:.3g} {bound_text}"
              + (f", {len(zero_rows)} fully masked or capped row(s) exactly 0" if zero_rows else ""))
        report["normalize_stats"]["max_abs_err"] = max(report["normalize_stats"]["max_abs_err"], d)

    report["flash_stats"]["max_abs_err"] = 0.0
    report["flash_stats_block_sparse"]["max_abs_err"] = 0.0
    report["normalize_stats"]["max_abs_err"] = 0.0
    for vc in (SENONES, 4096, 3904, 0):
        got = kernels.flash_stats(p3, *out, valid_count=vc)
        stats_check(f"unmasked valid_count={vc}", got, plain.flash_stats(p3, *plain_out_padded,
                                                                         valid_count=vc))
        if vc == 0:  # every column capped: every row's max at -1e30, all posteriors 0
            normalize_check("valid_count=0 (all capped)", got, zero_rows=range(p3.shape[0]))
        else:
            normalize_check(f"valid_count={vc}", got)
    # out_dim not a multiple of 4 (one value per thread), and the padded width
    normalize_check("out_dim 7990", got, out_dim=SENONES - 10)
    normalize_check(f"out_dim {n_pad}", got, out_dim=n_pad)
    got = kernels.flash_stats(p3, *out, valid_count=SENONES)
    p8, d8 = stats_check("unmasked", got, plain.flash_stats(p3, *plain_out_padded,
                                                            valid_count=SENONES))
    d84 = float((p8 - k4).abs().max())
    check(d8 <= 3e-5 and d84 <= 3e-5,
          f"K8 + normalize B=8192 K={HIDDEN} N={n_pad}: max |d| {d8:.3g} against the plain "
          f"version, {d84:.3g} against K4, <= 3e-5")
    report["flash_stats"]["max_abs_err"] = max(d8, d84)
    for sem in ("reference", "active_only"):
        got = kernels.flash_stats(p3, *out, masks40, valid_count=SENONES, semantics=sem)
        p8, d8 = stats_check(f"masked {sem}", got, plain.flash_stats(
            p3, *plain_out_padded, masks40, valid_count=SENONES, semantics=sem))
        d84 = float((p8 - kernels.resident_softmax(p3, *out, masks40, out_dim=SENONES,
                                                   semantics=sem)).abs().max())
        check(d8 <= 3e-5 and d84 <= 3e-5,
              f"K8 masked {sem}: posteriors max |d| {d8:.3g} (plain), {d84:.3g} (K4) <= 3e-5")
        normalize_check(f"masked {sem}", got, zero_rows=(7,) if sem == "active_only" else ())
        if sem == "active_only":
            check(bool((p8[7] == 0).all()), "K8 active_only: the fully masked row is 0")
        report["flash_stats"]["max_abs_err"] = max(report["flash_stats"]["max_abs_err"], d8, d84)
    for m, what in ((None, "unmasked"), (masks40, "masked reference")):
        got = kernels.flash_stats(p3, *out, m, valid_count=SENONES, fast=True)
        p8f, _ = stats_check(f"fast {what}", got, plain.flash_stats(
            p3, *plain_out_padded, m, valid_count=SENONES, fast=True), fast=True)
        normalize_check(f"fast {what}", got)
        ref = kernels.resident_softmax(p3, *out, m, out_dim=SENONES)
        check(p8f.dtype == torch.bfloat16 and bool(torch.allclose(p8f.float(), ref, rtol=BF16_RTOL,
                                                                   atol=BF16_ATOL)),
              f"K8 fast {what}: bf16 posteriors within rtol {BF16_RTOL}, atol {BF16_ATOL} of K4 f32")
    for m, what in ((bands, "band masks"), (masks40, "40% masks")):
        for sem in ("reference", "active_only"):
            for capped, vc in ((False, SENONES), (True, 3904)):
                got = kernels.flash_stats_block_sparse(p3, *out, m, valid_count=vc,
                                                       semantics=sem, capped_fill=capped)
                want = plain.block_sparse_stats(p3, *plain_out_padded, m, valid_count=vc,
                                                semantics=sem, capped_fill=capped)
                p8, d8 = stats_check(f"block-sparse {what} {sem} capped_fill={capped} "
                                     f"valid_count={vc}", got, want)
                if capped:  # the shards' stats, normalized at their full width
                    normalize_check(f"block-sparse {what} {sem} capped", got, out_dim=n_pad)
                if not capped:
                    d86 = float((p8 - kernels.resident_softmax_block_sparse(
                        p3, *out, m, out_dim=SENONES, semantics=sem)).abs().max())
                    check(d8 <= 3e-5 and d86 <= 3e-5,
                          f"K8 block-sparse {what} {sem}: posteriors max |d| {d8:.3g} (plain), "
                          f"{d86:.3g} (K6) <= 3e-5")
                    report["flash_stats_block_sparse"]["max_abs_err"] = max(
                        report["flash_stats_block_sparse"]["max_abs_err"], d8, d86)

    phase(f"15. a net too wide for K4 and K3: 432-{WIDE_DEPTH}x{WIDE_HIDDEN}-{SENONES} through K8")
    limit = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin",
                    kernels.HOPPER_BLOCK_SMEM)
    for name, fn, widest in (
            ("K4", lib.fdn_resident_softmax_wgmma_smem_bytes, kernels.RESIDENT_SOFTMAX_MAX_K),
            ("K6", lib.fdn_resident_softmax_block_sparse_smem_bytes, kernels.RESIDENT_SOFTMAX_MAX_K),
            ("K3", lib.fdn_hidden_stack_wgmma_smem_bytes, kernels.HIDDEN_STACK_MAX_H)):
        check(fn(widest) <= limit < fn(widest + kernels.TILE_K),
              f"{name}: {widest} fits the card's {limit} bytes "
              f"({fn(widest)}), {widest + kernels.TILE_K} does not ({fn(widest + kernels.TILE_K)})")
    fixed = {"K2": lib.fdn_hidden_layer_smem_bytes(), "K5": lib.fdn_output_logits_smem_bytes(),
             "K7": lib.fdn_hidden_layer_packed_smem_bytes(), "K8": lib.fdn_flash_stats_smem_bytes(0),
             "K8 skipping": lib.fdn_flash_stats_smem_bytes(1), "K9": lib.fdn_input_layer_smem_bytes()}
    check(all(v <= limit for v in fixed.values()),
          ", ".join(f"{k} ({v})" for k, v in fixed.items()) + f", any K, fit the card's {limit} bytes")
    q_wide = quantize_net(random_net(rng, INPUT_DIM, [WIDE_HIDDEN] * WIDE_DEPTH, SENONES))
    wide = Scorer(q_wide, EngineConfig(), device="cuda")
    wide_cpu = Scorer(q_wide, device="cpu")
    check(wide._hstack is None, f"the wide net has no hidden stack (H = {WIDE_HIDDEN})")
    # K8 and the normalize at the shapes the other routes give them, with
    # phase 14's gates: the wide net's last hidden activations (K = 3072)
    # and output weight; one shard of the flagship's output layer per mesh
    # rank (N = n_local = 4096, valid counts 4096 and 3904, capped skipping);
    # and the skipping variant past K6's widest N (65,536)
    qw = wide.net
    xw = kernels.input_layer(batch, qw.input_w, qw.input_operand, qw.input_b)
    for i in range(WIDE_DEPTH - 1):
        xw = kernels.hidden_layer(xw, qw.weights[i], qw.colsum128[i], qw.inv_scales[i],
                                  qw.biases[i])
    w_out = (qw.weights[-1], qw.colsum128[-1], qw.inv_scales[-1], qw.biases[-1])
    w_plain = (w_out[0].t(), *w_out[1:])
    check(xw.shape == (8192, WIDE_HIDDEN) and w_out[0].shape == (n_pad, WIDE_HIDDEN),
          f"wide net: activations [8192, {WIDE_HIDDEN}], output weight [{n_pad}, {WIDE_HIDDEN}]")
    wide_k = f"K={WIDE_HIDDEN} N={n_pad}"
    got = kernels.flash_stats(xw, *w_out, valid_count=SENONES)
    _, d = stats_check(f"{wide_k} unmasked", got, plain.flash_stats(xw, *w_plain,
                                                                     valid_count=SENONES))
    normalize_check(f"{wide_k} unmasked", got)
    for sem in ("reference", "active_only"):
        got = kernels.flash_stats(xw, *w_out, masks40, valid_count=SENONES, semantics=sem)
        d = max(d, stats_check(f"{wide_k} masked {sem}", got, plain.flash_stats(
            xw, *w_plain, masks40, valid_count=SENONES, semantics=sem))[1])
        normalize_check(f"{wide_k} masked {sem}", got,
                        zero_rows=(7,) if sem == "active_only" else ())
        got = kernels.flash_stats_block_sparse(xw, *w_out, bands, valid_count=SENONES,
                                               semantics=sem)
        d = max(d, stats_check(f"{wide_k} block-sparse band masks {sem}", got,
                               plain.block_sparse_stats(xw, *w_plain, bands, valid_count=SENONES,
                                                        semantics=sem))[1])
        normalize_check(f"{wide_k} block-sparse band masks {sem}", got)
    got = kernels.flash_stats(xw, *w_out, valid_count=SENONES, fast=True)
    stats_check(f"{wide_k} fast", got, plain.flash_stats(xw, *w_plain, valid_count=SENONES,
                                                         fast=True), fast=True)
    normalize_check(f"{wide_k} fast", got)
    check(d <= 3e-5, f"K8 + normalize {wide_k}: posteriors max |d| {d:.3g} against the plain "
                     "version <= 3e-5")

    n_local = -(-SENONES // (kernels.TILE_N * TP_RANKS)) * kernels.TILE_N
    n_all = n_local * TP_RANKS

    def pad_cols(t, axis):  # zero columns (weight rows) up to n_all
        shape = list(t.shape)
        shape[axis] = n_all
        full = torch.zeros(shape, dtype=t.dtype, device=t.device)
        full.narrow(axis, 0, t.shape[axis]).copy_(t)
        return full

    shard_w, shard_cs, shard_b = pad_cols(out[0], 0), pad_cols(out[1], 0), pad_cols(out[3], 0)
    shard_m40, shard_bands = pad_cols(masks40, 1), pad_cols(bands, 1)
    d = 0.0
    for rank in range(TP_RANKS):
        cols = slice(rank * n_local, (rank + 1) * n_local)
        valid = min(max(SENONES - rank * n_local, 0), n_local)
        s_out = (shard_w[cols].contiguous(), shard_cs[cols].contiguous(), out[2],
                 shard_b[cols].contiguous())
        s_plain = (s_out[0].t(), *s_out[1:])
        m40, mb = shard_m40[:, cols].contiguous(), shard_bands[:, cols].contiguous()
        what = f"shard {rank} K={HIDDEN} N={n_local} valid_count={valid}"
        got = kernels.flash_stats(p3, *s_out, valid_count=valid)
        d = max(d, stats_check(f"{what} unmasked", got, plain.flash_stats(
            p3, *s_plain, valid_count=valid), out_dim=n_local)[1])
        normalize_check(f"{what} unmasked", got, out_dim=n_local)
        for sem in ("reference", "active_only"):
            got = kernels.flash_stats(p3, *s_out, m40, valid_count=valid, semantics=sem)
            d = max(d, stats_check(f"{what} masked {sem}", got, plain.flash_stats(
                p3, *s_plain, m40, valid_count=valid, semantics=sem),
                out_dim=n_local)[1])
            got = kernels.flash_stats_block_sparse(p3, *s_out, mb, valid_count=valid,
                                                   semantics=sem, capped_fill=True)
            d = max(d, stats_check(f"{what} block-sparse band masks {sem} capped", got,
                                   plain.block_sparse_stats(p3, *s_plain, mb, valid_count=valid,
                                                            semantics=sem, capped_fill=True),
                                   out_dim=n_local)[1])
            normalize_check(f"{what} block-sparse {sem} capped", got, out_dim=n_local)
    check(d <= 3e-5, f"K8 + normalize on the shards: posteriors max |d| {d:.3g} against the "
                     "plain version <= 3e-5")

    # past K6's widest output layer: 514 column tiles per block of a pair
    wide_n = 2 * 65536 + 3 * kernels.TILE_N
    far_rng = np.random.default_rng(SEED + 15)
    far_w, far_colsum, far_inv, far_bias = random_layer(far_rng, 256, wide_n)
    far = (kernels.kernel_layout(torch.from_numpy(far_w).to(dev)),
           torch.from_numpy(far_colsum).to(dev), far_inv, torch.from_numpy(far_bias).to(dev))
    far_plain = (far[0].t(), *far[1:])
    far_x = torch.from_numpy(far_rng.integers(-128, 128, (128, 256), dtype=np.int8)).to(dev)
    tiles_on = far_rng.random((2, wide_n // kernels.TILE_N)) < 0.2
    far_masks = torch.from_numpy(
        np.repeat(np.repeat(tiles_on, 64, axis=0), kernels.TILE_N, axis=1)
        & (far_rng.random((128, wide_n)) < 0.5)).to(torch.uint8).to(dev)
    for sem in ("reference", "active_only"):
        for capped, valid in ((False, wide_n), (True, wide_n - 200)):
            got = kernels.flash_stats_block_sparse(far_x, *far, far_masks, valid_count=valid,
                                                   semantics=sem, capped_fill=capped)
            _, d = stats_check(f"block-sparse B=128 K=256 N={wide_n} {sem} capped_fill={capped}",
                               got, plain.block_sparse_stats(far_x, *far_plain, far_masks,
                                                             valid_count=valid, semantics=sem,
                                                             capped_fill=capped), out_dim=valid)
            check(d <= 3e-5, f"K8 block-sparse N={wide_n} {sem}: posteriors max |d| {d:.3g} "
                             "<= 3e-5")
    one_call = {"input_layer": 1, "hidden_layer": WIDE_DEPTH - 1, "flash_stats": 1,
                "normalize_stats": 1}
    for n in sizes:
        want = wide_cpu.score(frames[:n])
        close(drive(f"wide score n={n}", one_call, lambda: wide.score(frames[:n])), want,
              f"wide score n={n} against Scorer(device='cpu')")
    wide_masked = {sem: Scorer(q_wide, EngineConfig(lazy_semantics=sem), device="cuda")
                   for sem in ("reference", "active_only")}
    wide_sparse = {sem: Scorer(q_wide, EngineConfig(lazy_semantics=sem, lazy_mode="block_sparse"),
                               device="cuda") for sem in ("reference", "active_only")}
    for sem in ("reference", "active_only"):
        cpu_sem = Scorer(q_wide, EngineConfig(lazy_semantics=sem), device="cpu")
        for what, m in (("40% masks", masks_host[:1000]), ("band masks", bands_host[:1000])):
            want = cpu_sem.score_masked(frames[:1000], m)
            close(drive(f"wide score_masked {sem} {what}", one_call,
                        lambda: wide_masked[sem].score_masked(frames[:1000], m)),
                  want, f"wide score_masked {sem} {what} n=1000")
            close(drive(f"wide block_sparse {sem} {what}",
                        {"input_layer": 1, "hidden_layer": WIDE_DEPTH - 1,
                         "flash_stats_block_sparse": 1, "normalize_stats": 1},
                        lambda: wide_sparse[sem].score_masked(frames[:1000], m)),
                  want, f"wide block_sparse {sem} {what} n=1000")

    phase(f"16. tensor parallel on the one card: {TP_RANKS} model ranks (gloo), flagship net")
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    spawn = mp.get_context("spawn")
    results = spawn.Queue()
    ranks = [spawn.Process(target=tp_rank, args=(r, port, results)) for r in range(TP_RANKS)]
    for proc in ranks:
        proc.start()
    reports = []
    try:
        deadline = time.monotonic() + TP_TIMEOUT_S
        for _ in ranks:
            reports.append(results.get(timeout=max(deadline - time.monotonic(), 1)))
        for proc in ranks:
            proc.join(max(deadline - time.monotonic(), 1))
    finally:
        for proc in ranks:
            if proc.is_alive():
                proc.kill()
                proc.join()
    errors = [r["error"] for r in reports if "error" in r]
    check(not errors and all(proc.exitcode == 0 for proc in ranks),
          f"{TP_RANKS} ranks finished" + ("" if not errors else ":\n" + "\n".join(errors)))
    # the output pads to 128 x TP_RANKS columns: shards of n_local = 4096
    # (phase 15), valid counts 4096 and 3904
    for rep in sorted(reports, key=lambda r: r["rank"]):
        rank = rep["rank"]
        valid = min(max(SENONES - rank * n_local, 0), n_local)
        check(rep["block_shape"] == [8192, n_local] and rep["valid_count"] == valid,
              f"rank {rank}: score_device block [8192, {n_local}], valid count {valid}")
        for title, run in rep["runs"].items():
            kernel = "flash_stats_block_sparse" if "block_sparse" in title else "flash_stats"
            expect = {"input_layer": 1, "hidden_stack": 1, kernel: 1, "normalize_stats": 1}
            print(f"  rank {rank} launch counts of {title}: {run['counts']}")
            for name, count in run["counts"].items():
                check(count == expect.get(name, 0),
                      f"rank {rank} {title}: {name} launched {count} times "
                      f"(expected {expect.get(name, 0)})")
                path_launches[name] += count
            check(run["shape_ok"] and run["finite"] and run["max_dp"] <= 1e-4
                  and run["agree"] >= 0.999,
                  f"rank {rank} {title} n=8192: max |dp| = {run['max_dp']:.3g} <= 1e-4 against "
                  f"one device, argmax agreement {run['agree']:.4f} >= 0.999")

    phase(f"17. stats and tensor-parallel times (median of {TIMED_REPS} calls; card: {smi})")
    stats8 = kernels.flash_stats(p3, *out, valid_count=SENONES)
    fast8 = kernels.flash_stats(p3, *out, valid_count=SENONES, fast=True)
    stats_cases = {
        "K8 unmasked": ("flash_stats", lambda: kernels.flash_stats(p3, *out, valid_count=SENONES),
                        lambda: plain.flash_stats(p3, *plain_out_padded, valid_count=SENONES)),
        "K8 fast": (None, lambda: kernels.flash_stats(p3, *out, valid_count=SENONES, fast=True),
                    lambda: plain.flash_stats(p3, *plain_out_padded, valid_count=SENONES,
                                              fast=True)),
        "K8 masked ref.": (None, lambda: kernels.flash_stats(p3, *out, masks40, valid_count=SENONES),
                           lambda: plain.flash_stats(p3, *plain_out_padded, masks40,
                                                     valid_count=SENONES)),
        "K8 block-sp. bands": ("flash_stats_block_sparse",
                               lambda: kernels.flash_stats_block_sparse(p3, *out, bands,
                                                                        valid_count=SENONES),
                               lambda: plain.block_sparse_stats(p3, *plain_out_padded, bands,
                                                                valid_count=SENONES)),
        "normalize_stats": ("normalize_stats",
                            lambda: kernels.normalize_stats(*stats8, out_dim=SENONES),
                            lambda: plain.normalize_stats(*stats8, out_dim=SENONES)),
        "normalize_stats fast": (None, lambda: kernels.normalize_stats(
            *fast8[:3], out_dim=SENONES, tile_max=fast8[3]), lambda: plain.normalize_stats(
            *fast8[:3], out_dim=SENONES, tile_max=fast8[3])),
        "K8 + normalize": (None, lambda: cuda_backend.output_posteriors(p3, *out, out_dim=SENONES),
                           lambda: plain.output_posteriors_stats(p3, *plain_out_padded,
                                                                 out_dim=SENONES)),
    }
    for title, (name, kernel_fn, plain_fn) in stats_cases.items():
        ms, plain_ms = time_ms(torch, kernel_fn), time_ms(torch, plain_fn)
        queued_ms = back_to_back_ms(torch, kernel_fn)
        if name is not None:
            report[name]["ms"], report[name]["plain_ms"] = ms, plain_ms
        print(f"  {title:20s} B=8192 K={HIDDEN} N={n_pad} kernel {ms:.4f} ms (20 queued "
              f"{queued_ms:.4f} ms per call), plain {plain_ms:.4f} ms  [{smi}]")
    wide_plain = Scorer(q_wide, EngineConfig(backend="torch"), device="cuda")
    wide_ms = time_ms(torch, lambda: wide.score_device(batch))
    wide_plain_ms = time_ms(torch, lambda: wide_plain.score_device(batch))
    print(f"  wide net score_device B=8192: kernels {wide_ms:.4f} ms/batch, "
          f"{audio_s / wide_ms * 1e3:.1f} audio-s/s; plain {wide_plain_ms:.4f} ms/batch  [{smi}]")
    # the wide net's device work: K9, K2, K8 and the normalize kernel, one
    # launch each per call, and nothing else (no torch elementwise pass)
    window_ms, device = profile_device(torch, lambda: wide.score_device(batch), 10)
    check(bool(device), f"wide score_device B=8192 under torch.profiler: device time recorded "
                        f"({len(device)} kernels)")
    busy = sum(row[1] for row in device) / window_ms
    print(f"  wide score_device B=8192 under torch.profiler (10 calls, host window "
          f"{window_ms:.4f} ms/call): device busy {busy:.1%}, idle {1 - busy:.1%}  [{smi}]")
    for name, ms in sorted(device, key=lambda row: -row[1]):
        print(f"    {ms:.4f} ms/call  {name[:100]}")
    wide_kernels = {"K9": "input_layer_kernel", "K2": "SigmoidEpilogue",
                    "K8": "flash_stats_kernel", "normalize": "normalize_stats_kernel"}
    # (the launch counts per call are phase 15's)
    found = {what: [row for row in device if key in row[0]] for what, key in wide_kernels.items()}
    check(len(device) == len(wide_kernels) and all(len(rows) == 1 for rows in found.values()),
          "wide score_device runs K9, K2, K8 and the normalize kernel on the device and no "
          "other kernel (no torch elementwise pass)")
    tp_ms = [rep["score_device_ms"] for rep in sorted(reports, key=lambda r: r["rank"])]
    one_ms = host_ms(torch, lambda: scorer.score_device(batch))
    print(f"  flagship score_device B=8192 (host clock): {TP_RANKS} model ranks on this one card "
          f"{' / '.join(f'{t:.4f}' for t in tp_ms)} ms per call (each rank); one device "
          f"{one_ms:.4f} ms.  Both ranks share one card, so this shows the cost of the split "
          f"and the collectives, not scaling  [{smi}]")

    phase(f"18. bounds and product-only yardsticks (median of {TIMED_REPS} calls; card: {smi})")
    # each row's work at the shape its time was taken at (phases 6, 9, 13, 17): the
    # operations of its products (int8; K9's three TF32 products; the skipping
    # kernels: only the tiles these band masks leave active) and bytes with each
    # input read once, each output written once; the yardstick is the product
    # alone at the same shape (no epilogue, no softmax), which the port never
    # calls: torch._int_mm, and for K9 the f64 product it replaced
    # (ops.matmul.matmul_f32), with torch.matmul in f32 (TF32 off) printed beside
    k_dim, b_dim, l_dim = HIDDEN, 8192, hstack[0].shape[0]
    w_out = out[0].t().contiguous()  # [K, N] int8, padded
    w_layer, w_int4 = r.weights[0], k2_args[0].t().contiguous()
    out_ops = 2 * b_dim * k_dim * n_pad
    vec_bytes = n_pad * 8  # colsum and bias of the output layer
    layer_bytes = 8320 * k_dim * 2 + k_dim * 8
    input_bytes = b_dim * INPUT_DIM * 4 + 2 * k_dim * INPUT_DIM * 4 + k_dim * 4 + b_dim * k_dim
    work = {
        "bias_sigmoid_i8": (0, b_dim * k_dim * 4 + k_dim * 4 + b_dim * k_dim, None),
        "input_layer": (3 * 2 * b_dim * INPUT_DIM * k_dim, input_bytes,
                        lambda: plain.matmul_f32(batch, r.input_w)),
        "hidden_layer": (2 * 8320 * k_dim * k_dim, layer_bytes + k_dim * k_dim,
                         lambda: torch._int_mm(acts, w_layer)),
        "hidden_stack": (2 * b_dim * k_dim * k_dim * l_dim,
                         2 * b_dim * k_dim + l_dim * (k_dim * k_dim + k_dim * 8 + 4),
                         lambda: [torch._int_mm(a3, w) for w in plain_hstack[0]]),
        "resident_softmax": (out_ops, b_dim * k_dim + n_pad * k_dim + vec_bytes + b_dim * SENONES * 4,
                             lambda: torch._int_mm(p3, w_out)),
        "output_logits": (2 * 64 * k_dim * n_pad, 64 * k_dim + n_pad * k_dim + vec_bytes + 64 * n_pad * 4,
                          lambda: torch._int_mm(p3[:64], w_out)),
        "resident_softmax_block_sparse": (
            (1 - skip_bands) * out_ops,
            b_dim * k_dim + n_pad * k_dim + vec_bytes + b_dim * n_pad + b_dim * SENONES * 4,
            lambda: torch._int_mm(p3, w_out)),
        "hidden_layer_packed": (2 * 8320 * k_dim * k_dim, layer_bytes + k_dim * k_dim // 2,
                                lambda: torch._int_mm(acts4, w_int4)),
        "flash_stats": (out_ops, b_dim * k_dim + n_pad * k_dim + vec_bytes + b_dim * (n_pad * 4 + 8),
                        lambda: torch._int_mm(p3, w_out)),
        "flash_stats_block_sparse": (
            (1 - skip_bands) * out_ops,
            b_dim * k_dim + n_pad * k_dim + vec_bytes + b_dim * n_pad + b_dim * (n_pad * 4 + 8),
            lambda: torch._int_mm(p3, w_out)),
        # z's first out_dim columns and (m, s) read, the posteriors written
        "normalize_stats": (0, b_dim * (SENONES * 4 + 8) + b_dim * SENONES * 4, None),
    }
    for name, (ops, nbytes, product) in work.items():
        peak = "tf32" if name == "input_layer" else "int8"
        report[name]["bound_ms"], report[name]["bound_by"] = bound(ops, peak, nbytes)
        report[name]["product_ms"] = None if product is None else time_ms(torch, product)
        share = report[name]["bound_ms"] / report[name]["ms"]
        product_text = ("no product" if product is None
                        else f"product alone ({'f64 matmul' if peak == 'tf32' else 'torch._int_mm'}) "
                             f"{report[name]['product_ms']:.4f} ms")
        print(f"  {name:29s} {report[name]['ms']:.4f} ms, bound {report[name]['bound_ms']:.4f} ms "
              f"({report[name]['bound_by']}, {ops / 1e9:.1f} G ops, {nbytes / 1e6:.1f} MB), "
              f"{share:.1%} of it; {product_text}  [{smi}]")
    # K5 at B = 8192 (fused_softmax=False), beside the B = 64 row above
    k5_bound, k5_by = bound(2 * b_dim * k_dim * n_pad, "int8",
                            b_dim * k_dim + n_pad * k_dim + vec_bytes + b_dim * n_pad * 4)
    print(f"  output_logits B=8192           {k5_ms[8192]:.4f} ms, bound {k5_bound:.4f} ms ({k5_by}), "
          f"{k5_bound / k5_ms[8192]:.1%} of it  [{smi}]")
    tf32_switch = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32_ms = time_ms(torch, lambda: torch.matmul(batch, r.input_w))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_switch
    print(f"  input_layer yardstick: torch.matmul f32 (TF32 off) [8192, {INPUT_DIM}] x "
          f"[{INPUT_DIM}, {k_dim}] {f32_ms:.4f} ms  [{smi}]")

    phase(f"19. streaming: StreamingScorer on the flagship net, {STREAM_SUBMITTERS} submitter threads")
    from fastdnn_tpu_torch.engine.stream import StreamingScorer
    from fastdnn_tpu_torch.utils import timer

    utt_rng = np.random.default_rng(SEED + 19)
    utts = []
    for i in range(STREAM_UTTERANCES):
        n = int(utt_rng.integers(UTT_MIN, UTT_MAX + 1))
        f = utt_rng.standard_normal((n, INPUT_DIM), dtype=np.float32)
        m = None
        if i % round(1 / MASKED_FRAC) == 0:
            m = (utt_rng.random((n, SENONES), dtype=np.float32) < SERVE_DENSITY).astype(np.uint8)
        utts.append((f, m))
    sent = sum(f.shape[0] for f, _ in utts)
    n_masked = sum(m is not None for _, m in utts)

    def serial_run():
        return [scorer.score(f) if m is None else scorer.score_masked(f, m) for f, m in utts]

    def stream_run(ss):
        """Every utterance submitted from STREAM_SUBMITTERS threads, each
        submitting its share and then waiting on its futures."""
        results, errors = [None] * len(utts), []

        def submitter(t):
            try:
                futs = [(i, ss.submit(*utts[i])) for i in range(t, len(utts), STREAM_SUBMITTERS)]
                for i, fut in futs:
                    results[i] = fut.result(120)
            except Exception as e:  # reported below; the phase fails
                errors.append(e)

        threads = [threading.Thread(target=submitter, args=(t,)) for t in range(STREAM_SUBMITTERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        check(not errors and not any(t.is_alive() for t in threads),
              f"streaming run: every submitter finished without an error ({errors[:1]})")
        return results

    want_s = serial_run()
    with StreamingScorer(scorer, max_batch_frames=8192, max_wait_ms=3.0) as ss:
        per_batch = lambda _: dict.fromkeys(  # noqa: E731
            ("input_layer", "hidden_stack", "resident_softmax"), ss.throughput.batches)
        got_s = drive("the streaming run", per_batch, lambda: stream_run(ss))
        check(ss.throughput.frames == sent,
              f"throughput.frames = {ss.throughput.frames} = the {sent} frames sent "
              f"({STREAM_UTTERANCES} utterances, {n_masked} masked; {ss.throughput.batches} batches, "
              f"mean fill {ss.throughput.mean_batch_fill():.1f})")
        d_s = max(float(np.abs(g - w).max()) for g, w in zip(got_s, want_s))
        check(all(g.shape == w.shape and g.dtype == np.float32 for g, w in zip(got_s, want_s))
              and d_s <= SERVE_BOUND,
              f"every streamed result within {SERVE_BOUND:g} of serial Scorer.score / score_masked "
              f"(max |d| = {d_s:.3g})")

        def timed(fn):
            def run():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                return time.perf_counter() - t0
            return run

        turns = {"serial Scorer loop": timed(serial_run), "stream": timed(lambda: stream_run(ss))}
        secs = {name: [] for name in turns}
        for name in list(turns) + list(turns)[::-1]:
            secs[name].append(turns[name]())
        print(f"  {sent} frames ({sent / FRAMES_PER_AUDIO_SECOND:.1f} audio-s) in turns: " + "; ".join(
            f"{name} " + " / ".join(f"{sent / FRAMES_PER_AUDIO_SECOND / t:.1f}" for t in ts)
            + " audio-s/s" for name, ts in secs.items()) + f"  [{smi}]")

        # one more stream run under torch.profiler (CUPTI), through the
        # port's own trace scope: which CUDA stream the copies and the
        # kernels ran on, the kernels, the busy share
        trace_dir = SMOKE_DIR.parent / "stream_trace"
        with timer.trace(str(trace_dir)):
            window_s = timed(lambda: stream_run(ss))()
        events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    h2d = [e for e in copies if "HtoD" in e.get("name", "")]
    d2h = [e for e in copies if "DtoH" in e.get("name", "")]
    check(bool(kern) and bool(h2d),
          f"the stream's trace recorded device activity ({len(kern)} kernels, {len(h2d)} uploads)")
    kernel_streams = {e["args"].get("stream") for e in kern}
    copy_streams = {e["args"].get("stream") for e in h2d}
    check(not kernel_streams & copy_streams,
          f"the host-to-device copies ran on CUDA stream(s) {sorted(copy_streams)}, the kernels "
          f"on {sorted(kernel_streams)}")
    names = sorted({e["name"] for e in kern})
    busy = sum(e["dur"] for e in kern) / 1e6 / window_s
    copy_s = {what: sum(e["dur"] for e in evs) / 1e6 for what, evs in (("HtoD", h2d), ("DtoH", d2h))}
    print(f"  stream under torch.profiler: window {window_s * 1e3:.1f} ms; kernels busy "
          f"{busy:.1%} of it ({len(kern)} launches); copies HtoD {copy_s['HtoD'] * 1e3:.1f} ms "
          f"({len(h2d)}), DtoH {copy_s['DtoH'] * 1e3:.1f} ms ({len(d2h)})  [{smi}]")
    for name in names:
        rows_k = [e for e in kern if e["name"] == name]
        print(f"    {len(rows_k):4d} x {sum(e['dur'] for e in rows_k) / len(rows_k) / 1e3:.4f} ms  "
              f"{name[:110]}")
    want_k = {"K9": "input_layer_kernel", "K3": "hidden_stack_wgmma_kernel",
              "K4": "resident_softmax_wgmma_kernel<false", "K4 masked": "resident_softmax_wgmma_kernel<true"}
    check(all(any(key in name for name in names) for key in want_k.values())
          and not any(re.search("gemm|cutlass|cublas", name, re.I) for name in names),
          "the stream ran K9, K3, K4 and K4 masked, and no library GEMM")

    # where one 8192-frame batch's time goes: the kernels (phase 6's
    # score_device), the frames' upload from pinned memory, the posteriors'
    # download into pinned memory, the assembly of the frames on the host,
    # and a server's tobytes and sendall over loopback TCP of the same bytes
    pinned_in = torch.empty((8192, INPUT_DIM), dtype=torch.float32, pin_memory=True)
    frames_8192 = frames[:8192]
    posts = scorer.score_device(batch)
    pinned_out = torch.empty(posts.shape, dtype=torch.float32, pin_memory=True)
    masks_pinned = torch.empty((8192, SENONES), dtype=torch.uint8, pin_memory=True)
    split = {
        "kernels (score_device, phase 6)": turn_ms["score_device"]["kernels"],
        "H2D frames, 14.2 MB pinned": time_ms(torch, lambda: pinned_in.to(dev, non_blocking=True)),
        "H2D masks of a masked batch, 65.5 MB pinned": time_ms(
            torch, lambda: masks_pinned.to(dev, non_blocking=True)),
        "D2H posteriors, 262.1 MB pinned": time_ms(
            torch, lambda: pinned_out.copy_(posts, non_blocking=True)),
        "assembly of the frames (host)": host_ms(torch, lambda: pinned_in.numpy().__setitem__(
            slice(None), frames_8192), reps=5),
    }
    array = pinned_out.numpy()
    split["tobytes (host)"] = host_ms(torch, array.tobytes, reps=5)
    payload = array.tobytes()
    with socket.create_server(("127.0.0.1", 0)) as listener:
        sender = socket.create_connection(listener.getsockname())
        receiver, _ = listener.accept()

        def drain(total, received):
            view = memoryview(bytearray(1 << 24))
            while received[0] < total:
                k = receiver.recv_into(view)
                if k == 0:
                    return
                received[0] += k

        sends = []
        for _ in range(4):
            received = [0]
            reader = threading.Thread(target=drain, args=(len(payload), received))
            reader.start()
            t0 = time.perf_counter()
            sender.sendall(payload)
            reader.join(120)
            sends.append((time.perf_counter() - t0) * 1e3)
            check(received[0] == len(payload), f"loopback TCP: all {len(payload)} bytes received")
        sender.close()
        receiver.close()
    split["sendall over loopback TCP (host)"] = statistics.median(sends[1:])
    print(f"  one 8192-frame batch ({INPUT_DIM} -> {SENONES}), ms:  [{smi}]")
    for what, ms in split.items():
        print(f"    {ms:9.4f}  {what}")
    del posts, pinned_out, payload, array

    phase(f"20. serving over TCP: ScoreServer + bench_serve.run_load, {SERVE_CLIENTS} clients, "
          f"{SERVE_SECONDS:g} s")
    from fastdnn_tpu_torch.cli import bench_serve, serve

    ss = StreamingScorer(scorer, max_batch_frames=8192, max_wait_ms=3.0)
    server = serve.ScoreServer(("127.0.0.1", 0), ss)
    server_thread = threading.Thread(target=server.serve_forever, daemon=True)
    server_thread.start()
    try:
        served = drive(
            "the serving run",
            lambda _: dict.fromkeys(("input_layer", "hidden_stack", "resident_softmax"),
                                    ss.throughput.batches),
            lambda: bench_serve.run_load(
                server.server_address[1], clients=SERVE_CLIENTS, duration_s=SERVE_SECONDS,
                min_len=UTT_MIN, max_len=UTT_MAX, masked_frac=MASKED_FRAC,
                mask_density=SERVE_DENSITY, keep=SERVE_KEEP))
    finally:
        server.shutdown()
        server.server_close()
        ss.close()
    server_thread.join(60)
    per_client = served.pop("responses")
    responses = [r for kept in per_client for r in kept]
    check(len(responses) >= 64 and all(per_client),
          f"{len(responses)} responses kept (at least 64), {min(map(len, per_client))} to "
          f"{max(map(len, per_client))} from each of the {SERVE_CLIENTS} clients "
          f"({sum(m is not None for _, m, _ in responses)} masked)")
    d_v, shapes_ok = 0.0, True
    for f, m, out in responses:
        want = scorer.score(f) if m is None else scorer.score_masked(f, m)
        shapes_ok &= out.shape == want.shape and out.dtype == np.float32
        d_v = max(d_v, float(np.abs(out - want).max())) if shapes_ok else float("inf")
    check(shapes_ok and d_v <= SERVE_BOUND,
          f"every kept response f32 [n, {SENONES}] and within {SERVE_BOUND:g} of serial scoring "
          f"(max |d| = {d_v:.3g}); no error response")
    print(f"  bench_serve row: {json.dumps(served)}  [{smi}]")

    phase("21. concurrency on the card: one Scorer shared by 8 threads, 4 LazyContexts at once")
    conc_rng = np.random.default_rng(SEED + 21)
    tasks = [frames[conc_rng.permutation(frames.shape[0])[:int(conc_rng.integers(1, UTT_MAX + 1))]]
             for _ in range(32)]
    want_c = [scorer.score(t) for t in tasks]
    with ThreadPoolExecutor(max_workers=8) as pool:
        got_c = drive("8 threads sharing one Scorer",
                      dict.fromkeys(("input_layer", "hidden_stack", "resident_softmax"), len(tasks)),
                      lambda: list(pool.map(scorer.score, tasks)))
    d_c = max(float(np.abs(g - w).max()) for g, w in zip(got_c, want_c))
    bitwise = all(np.array_equal(g, w) for g, w in zip(got_c, want_c))
    check(d_c <= SERVE_BOUND, f"{len(tasks)} calls from 8 threads: max |d| = {d_c:.3g} <= "
                              f"{SERVE_BOUND:g} against serial calls (bitwise: {bitwise})")
    ctx_frames = 12
    ctx_masks = (conc_rng.random((4, ctx_frames, SENONES)) < LAZY_DENSITY).astype(np.uint8)

    def decode(t):
        ctx = scorer.new_lazy_context(ctx_frames)
        ctx.calculate_until_output(frames[t * ctx_frames:(t + 1) * ctx_frames])
        return np.stack([ctx.calculate_for_output_nodes(m) for m in ctx_masks[t]])

    want_l = [decode(t) for t in range(4)]
    with ThreadPoolExecutor(max_workers=4) as pool:
        got_l = drive("4 LazyContexts at once",
                      {"input_layer": 4, "hidden_stack": 4, "output_logits": 4 * ctx_frames},
                      lambda: list(pool.map(decode, range(4))))
    d_l = max(float(np.abs(g - w).max()) for g, w in zip(got_l, want_l))
    bitwise = all(np.array_equal(g, w) for g, w in zip(got_l, want_l))
    check(d_l <= SERVE_BOUND, f"4 LazyContexts decoding at once: max |d| = {d_l:.3g} <= "
                              f"{SERVE_BOUND:g} against serial decodes (bitwise: {bitwise})")

    phase(f"22. MultiHostScorer: this process coordinates, one worker rank on cuda:0 (gloo), "
          f"mesh 1x{TP_RANKS}, B = 8192")
    import torch.distributed as dist

    from fastdnn_tpu_torch import save_qnet
    from fastdnn_tpu_torch.parallel.mesh import init_multihost, make_mesh
    from fastdnn_tpu_torch.parallel.service import MultiHostScorer

    shutil.rmtree(SERVICE_DIR, ignore_errors=True)
    SERVICE_DIR.mkdir(parents=True)
    ckpt = SERVICE_DIR / "flagship.npz"
    save_qnet(qnet, ckpt)  # every rank builds the net from these bytes
    f8, m8, b8 = frames[:8192], masks_host[:8192], bands_host[:8192]
    np.save(SERVICE_DIR / "frames.npy", f8)
    np.save(SERVICE_DIR / "masks.npy", m8)
    want_score = scorer.score(f8)  # the single device, in this process
    want_masked = {sem: lazy.score_masked(f8, m8) for sem, (lazy, _) in semantics_scorers.items()}
    want_bands = scorer.score_masked(f8, b8)
    want_ctx = scorer.score_masked(f8[:SERVICE_CTX_FRAMES], m8[:SERVICE_CTX_FRAMES])
    per_call = {"input_layer": 1, "hidden_stack": 1, "flash_stats": 1, "normalize_stats": 1}
    per_call_sparse = {"input_layer": 1, "hidden_stack": 1, "flash_stats_block_sparse": 1,
                       "normalize_stats": 1}
    port = free_port()
    procs, results = spawn_ranks({1: "worker"}, port)
    got_mh, mh_ms = {}, {}
    try:
        init_multihost(f"tcp://localhost:{port}", world_size=TP_RANKS, rank=0, backend="gloo")
        mesh = make_mesh(1, TP_RANKS, device_type="cuda")
        for name, fields, scatter in SERVICE_CONFIGS:
            mh = MultiHostScorer(qnet, EngineConfig(**fields), mesh, device=dev, scatter=scatter,
                                 call_timeout_s=SERVICE_CALL_TIMEOUT_S)
            try:
                check(mh.is_coordinator and mh._multi, f"{name}: rank 0 coordinates two processes")
                if name in ("scatter", "broadcast"):
                    got_mh[f"{name} score"] = drive(f"{name}: coordinated score", per_call,
                                                    lambda: mh.score(f8))
                if name != "block_sparse":
                    got_mh[f"{name} masked"] = drive(f"{name}: coordinated score_masked",
                                                     per_call, lambda: mh.score_masked(f8, m8))
                else:
                    got_mh["block_sparse bands"] = drive(
                        "block_sparse: coordinated score_masked, band masks", per_call_sparse,
                        lambda: mh.score_masked(f8, b8))
                if name == "scatter":
                    def decode():
                        ctx = mh.new_lazy_context(SERVICE_CTX_FRAMES)
                        ctx.calculate_until_output(f8[:SERVICE_CTX_FRAMES])
                        return np.stack([ctx.calculate_for_output_nodes(m)
                                         for m in m8[:SERVICE_CTX_FRAMES]])

                    got_mh["lazy"] = drive(
                        f"a {SERVICE_CTX_FRAMES}-frame LazyContext through the coordinator",
                        {k: SERVICE_CTX_FRAMES for k in per_call}, decode)
                    mh_ms = in_turns(torch, {"coordinated score": lambda: mh.score(f8),
                                             "single-device score": lambda: scorer.score(f8)},
                                     timer=lambda t, fn: host_ms(t, fn, reps=5))
                    mh_split = split_coordinated(torch, mh, f8)
            finally:
                mh.close()
            del mh
        reports = collect(procs, results, 1)
    finally:
        for proc in procs.values():
            if proc.is_alive():
                proc.kill()
                proc.join()
        if dist.is_initialized():
            dist.destroy_process_group()
    check(procs[1].exitcode == 0, "the worker rank left its loops at each close() and exited 0")
    close(got_mh["scatter score"], want_score, "coordinated score n=8192")
    for sem in ("reference", "active_only"):
        key = "scatter masked" if sem == "reference" else "active_only masked"
        close(got_mh[key], want_masked[sem], f"coordinated score_masked {sem} n=8192", MASKED_BOUND)
    check(bool((got_mh["active_only masked"][7] == 0).all()),
          "coordinated score_masked active_only: the fully masked row is 0")
    close(got_mh["block_sparse bands"], want_bands, "coordinated block_sparse n=8192 (band masks)",
          MASKED_BOUND)
    close(got_mh["lazy"], want_ctx, f"coordinated LazyContext, {SERVICE_CTX_FRAMES} frames",
          MASKED_BOUND)
    check(np.array_equal(got_mh["broadcast score"], got_mh["scatter score"])
          and np.array_equal(got_mh["broadcast masked"], got_mh["scatter masked"]),
          "scatter=False (the whole batch broadcast) bitwise the scatter's posteriors")
    for name, calls in reports[0]["calls"].items():
        expect = per_call_sparse if name == "block_sparse" else per_call
        bad = [c for c in calls if any(c.get(k, 0) != expect.get(k, 0) for k in set(c) | set(expect))]
        check(calls and not bad, f"worker rank, {name}: each of its {len(calls)} calls launched "
                                 f"{expect} (others 0)" + (f"; first mismatch {bad[0]}" if bad else ""))
    for name, calls in reports[0]["calls"].items():
        if name == "scatter":  # the driven calls, not the timed ones after them
            calls = calls[:2 + SERVICE_CTX_FRAMES]
        for c in calls:
            for k, v in c.items():
                path_launches[k] += v
    print(f"  coordinated score B=8192 against one device, host clock per call (in turns): "
          + "; ".join(f"{k} {' / '.join(f'{t:.2f}' for t in v)} ms" for k, v in mh_ms.items())
          + f"  [{smi}]")
    print(f"  where one coordinated score B=8192 goes on the coordinator, host clock, median of 3 "
          f"(ms):  [{smi}]")
    for what, ms in mh_split.items():
        print(f"    {ms:9.2f}  {what}")

    phase(f"23. TCP serving over two processes: fastdnn_tpu_torch.cli.serve --mesh-model {TP_RANKS} "
          f"--coordinator, bench_serve.run_load, {SERVE_CLIENTS} clients, {SERVE_SECONDS:g} s")
    import signal

    coordinator = f"127.0.0.1:{free_port()}"
    repo = Path(__file__).resolve().parent
    serve_cmd = [sys.executable, "-m", "fastdnn_tpu_torch.cli.serve", str(ckpt), "--port", "0",
                 "--warmup", "--mesh-model", str(TP_RANKS), "--coordinator", coordinator,
                 "--num-processes", str(TP_RANKS), "--process-id"]
    servers = [subprocess.Popen(serve_cmd + [str(r)], cwd=repo, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True) for r in range(TP_RANKS)]
    try:
        served_port, lines = None, []
        for line in servers[0].stdout:  # until the coordinator serves
            lines.append(line)
            found = re.match(r"serving on [\d.]+:(\d+)", line)
            if found:
                served_port = int(found.group(1))
                break
        check(served_port is not None, "rank 0 serves TCP" + ("" if served_port else
                                                            ":\n" + "".join(lines[-30:])))
        t0 = time.perf_counter()
        served2 = bench_serve.run_load(
            served_port, clients=SERVE_CLIENTS, duration_s=SERVE_SECONDS, min_len=UTT_MIN,
            max_len=UTT_MAX, masked_frac=MASKED_FRAC, mask_density=SERVE_DENSITY, keep=SERVE_KEEP)
        load_s = time.perf_counter() - t0
        servers[0].send_signal(signal.SIGTERM)  # shuts rank 0 down, which releases the worker
        outs = ["".join(lines) + servers[0].communicate(timeout=120)[0],
                servers[1].communicate(timeout=120)[0]]
    finally:
        for proc in servers:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    check(servers[0].returncode == 0 and servers[1].returncode == 0
          and re.search(r"worker 1: Network = ", outs[1]) is not None,
          f"shut down by SIGTERM: rank 0 exit {servers[0].returncode}, the worker (which printed "
          f"its role) exit {servers[1].returncode}" + ("" if servers[1].returncode == 0 else
                                                      ":\n" + outs[1][-3000:] + outs[0][-3000:]))
    per_client = served2.pop("responses")
    responses = [r for kept in per_client for r in kept]
    n_masked = sum(m is not None for _, m, _ in responses)
    check(len(responses) >= 32 and 0 < n_masked < len(responses),
          f"{len(responses)} responses kept (at least 32), {n_masked} of them masked, "
          f"{min(map(len, per_client))} to {max(map(len, per_client))} from each client")
    d_un, d_m, shapes_ok = 0.0, 0.0, True
    for f, m, out in responses:
        want = scorer.score(f) if m is None else scorer.score_masked(f, m)
        shapes_ok &= out.shape == want.shape and out.dtype == np.float32
        agree = float((out.argmax(1) == want.argmax(1)).mean())
        shapes_ok &= agree >= 0.999
        d = float(np.abs(out - want).max())
        d_un, d_m = (max(d_un, d), d_m) if m is None else (d_un, max(d_m, d))
    check(shapes_ok and d_un <= 1e-4 and d_m <= MASKED_BOUND,
          f"every kept response against the single device: unmasked max |d| = {d_un:.3g} <= 1e-4, "
          f"masked {d_m:.3g} <= {MASKED_BOUND:g}, argmax agreement >= 0.999 each; no error response")
    print(f"  two-process bench_serve row ({load_s:.1f} s with its set-up): {json.dumps(served2)}  "
          f"[{smi}]")

    phase(f"24. a worker dies mid-stream: call_timeout_s = {DEATH_TIMEOUT_S:g} s")
    procs, results = spawn_ranks({0: "death-coordinator", 1: "death-worker"}, free_port())
    death = collect(procs, results, 1)[0]
    check(procs[1].exitcode == 17 and procs[0].exitcode == 0,
          f"the worker crashed (exit {procs[1].exitcode}), the coordinator exited "
          f"{procs[0].exitcode}")
    check(death["first_shape"] == [UTT_MAX, SENONES], "the stream's first utterance scored")
    print(f"  the next utterance: {death['dead'][0]} after {death['dead_s']:.3f} s: {death['dead'][1]}")
    check(death["dead"][0] == "RuntimeError" and death["dead_s"] <= DEATH_TIMEOUT_S + 10,
          f"the dead worker surfaced as RuntimeError in {death['dead_s']:.3f} s <= "
          f"call_timeout_s + 10 = {DEATH_TIMEOUT_S + 10:g} s")
    check(death["after"][0] == "RuntimeError" and "closed" in death["after"][1]
          and death["after_s"] < 1.0 and death["closed"],
          f"the scorer ended closed and the next call failed fast ({death['after_s']:.4f} s: "
          f"{death['after'][1][:80]})")

    phase("25. front doors: torchrun score CLI, make_gspmd_scorer on two ranks, the native reader")
    from fastdnn_tpu_torch import read_features, to_raw, write_features, write_model
    from fastdnn_tpu_torch.formats import binary as binfmt
    from fastdnn_tpu_torch.formats import native
    from fastdnn_tpu_torch.parallel.sharded import make_gspmd_scorer

    feats = SERVICE_DIR / "frames.bin"
    write_features(f8, feats)
    score_cmd = ["-m", "fastdnn_tpu_torch.cli.score", str(ckpt), str(feats)]
    runs = {
        "torchrun --mesh-model 2": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                                    "--nproc-per-node", str(TP_RANKS), *score_cmd,
                                    str(SERVICE_DIR / "mesh.bin"), "BIN",
                                    "--mesh-model", str(TP_RANKS), "--iterations", "3"],
        "--device cuda": [sys.executable, *score_cmd, str(SERVICE_DIR / "single.bin"), "BIN",
                          "--iterations", "3"],
    }
    cli_procs = {k: subprocess.Popen(cmd, cwd=repo, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
                 for k, cmd in runs.items()}
    cli_out = {}
    try:
        for k, proc in cli_procs.items():
            cli_out[k] = proc.communicate(timeout=TP_TIMEOUT_S)[0]
    finally:
        for proc in cli_procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for k, proc in cli_procs.items():
        check(proc.returncode == 0, f"score {k} exit 0" + ("" if proc.returncode == 0 else
                                                           ":\n" + cli_out[k][-3000:]))
        for line in cli_out[k].splitlines():
            if line.startswith(("Mesh", "Dnn calculation time")):
                print(f"  {k}: {line.strip()}  [{smi}]")
    check(cli_out["torchrun --mesh-model 2"].count("Network     =") == 1,
          "under torchrun, rank 0 alone printed")
    close(read_features(SERVICE_DIR / "mesh.bin"), read_features(SERVICE_DIR / "single.bin"),
          "torchrun score --mesh-model 2 against the --device cuda output")

    port = free_port()
    procs, results = spawn_ranks({1: "gspmd"}, port)
    try:
        init_multihost(f"tcp://localhost:{port}", world_size=TP_RANKS, rank=0, backend="gloo")
        mesh = make_mesh(1, TP_RANKS, device_type="cuda")
        g_score, g_masked = make_gspmd_scorer(mesh)
        f_dev, m_dev = torch.from_numpy(f8).to(dev), torch.from_numpy(m8).to(dev)
        got_g = drive("make_gspmd_scorer score + score_masked (rank 0)",
                      {k: 2 for k in per_call},
                      lambda: (g_score(qnet, f_dev).cpu().numpy(),
                               g_masked(qnet, f_dev, m_dev).cpu().numpy()))
        g_rank1 = collect(procs, results, 1)[0]
    finally:
        for proc in procs.values():
            if proc.is_alive():
                proc.kill()
                proc.join()
        if dist.is_initialized():
            dist.destroy_process_group()
    check(g_rank1["counts"] == {**dict.fromkeys(kernels.KERNELS, 0), **{k: 2 for k in per_call}}
          and g_rank1["shapes"] == [[8192, SENONES]] * 2,
          f"make_gspmd_scorer rank 1: the whole [8192, {SENONES}] posteriors twice, launches "
          f"{ {k: v for k, v in g_rank1['counts'].items() if v} }")
    for k, v in g_rank1["counts"].items():
        path_launches[k] += v
    close(got_g[0], want_score, "make_gspmd_scorer score n=8192 (rank 0)")
    close(got_g[1], want_masked["reference"], "make_gspmd_scorer score_masked n=8192 (rank 0)",
          MASKED_BOUND)

    t0 = time.perf_counter()
    native_lib = native.build()
    print(f"  native reader: {native_lib.name} ready in {time.perf_counter() - t0:.1f} s "
          f"(g++ at its first use)")
    model_bin = SERVICE_DIR / "flagship.bin"
    write_model(to_raw(net), model_bin)

    def numpy_model():
        with open(model_bin, "rb") as fh:  # a file object takes the numpy parser
            return binfmt.read_model(fh)

    def numpy_features():
        with open(feats, "rb") as fh:
            return binfmt.read_features(fh)

    nat_m, np_m = binfmt.read_model(model_bin), numpy_model()
    check(all(np.array_equal(a.weights.view(np.uint32), b.weights.view(np.uint32))
              and np.array_equal(a.bias.view(np.uint32), b.bias.view(np.uint32))
              for a, b in zip(nat_m.layers, np_m.layers, strict=True))
          and np.array_equal(nat_m.shift, np_m.shift) and np.array_equal(nat_m.scale, np_m.scale),
          f"the native reader's flagship model ({model_bin.stat().st_size / 1e6:.1f} MB) bitwise "
          f"the numpy parser's")
    check(np.array_equal(binfmt.read_features(feats).view(np.uint32),
                         numpy_features().view(np.uint32)),
          f"the native reader's {f8.shape[0]} x {INPUT_DIM} features bitwise the numpy parser's")
    io_ms = {}
    for what, fns in (("model", (lambda: binfmt.read_model(model_bin), numpy_model)),
                      ("features", (lambda: binfmt.read_features(feats), numpy_features))):
        for who, fn in zip(("native", "numpy"), fns):
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            io_ms[f"{what} {who}"] = statistics.median(times)
    print("  host reads, median of 5 (ms): " + "; ".join(f"{k} {v:.2f}" for k, v in io_ms.items())
          + f"  [{smi}]")
    shutil.rmtree(SERVICE_DIR, ignore_errors=True)

    rows = [
        {
            "name": name,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": path_launches[name],
            "max_abs_err": report[name]["max_abs_err"],
            "ms": report[name]["ms"],
            "plain_ms": report[name]["plain_ms"],
            "bound_ms": report[name]["bound_ms"],
            "bound_by": report[name]["bound_by"],
            "product_ms": report[name]["product_ms"],
            # no single PyTorch call computes any of these functions: each fuses a
            # quantized sigmoid or a softmax into an int8 product, and the
            # normalize takes its softmax from given (z, m, s)
            "library_ms": None,
        }
        for name, k in kernels.KERNELS.items()
    ]
    print()
    print(smi)  # the card, as nvidia-smi names it and its power limit
    print(json.dumps({"kernels": rows}))
    print(json.dumps(
        {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
