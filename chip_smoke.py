#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fastdnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, checks each against its plain
PyTorch version on the card at the shapes the main path gives it, drives the
main path (`Scorer.score` on the 432 -> 7x2048 -> 8000 net, seeded random
weights) at three batch sizes, shows through the launch counters that the
path went through every kernel, and times kernels and path beside their
plain versions.  Any failed check raises and the script exits non-zero.
The last line of standard output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

It needs the repository around it and a CUDA device; without either it
fails before printing any result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
INPUT_DIM, HIDDEN, DEPTH, SENONES = 432, 2048, 7, 8000
FRAMES_PER_AUDIO_SECOND = 100  # 10 ms frame shift
TIMED_REPS = 12


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from fastdnn_tpu_torch import EngineConfig, Scorer, quantize_net, random_net
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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    report = {name: {"max_abs_err": None, "ms": None, "plain_ms": None} for name in kernels.KERNELS}

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
    report["bias_sigmoid_i8"]["max_abs_err"] = 0.0

    acts = plain.input_layer_step(frames_dev, r.input_w, r.input_b)
    layer = (q.weights[0], q.colsum128[0], q.inv_scales[0], q.biases[0])
    plain_layer = (r.weights[0], r.colsum128[0], r.inv_scales[0], r.biases[0])
    k2 = kernels.hidden_layer(acts, *layer)
    p2 = plain.hidden_layer_step(acts, *plain_layer)
    d2 = int((k2.int() - p2.int()).abs().max())
    check(d2 == 0, f"K2 hidden_layer B=8320 K=N={HIDDEN} bitwise (max |d| = {d2})")
    report["hidden_layer"]["max_abs_err"] = float(d2)

    hstack, plain_hstack = scorer._hstack, reference._hstack
    k3 = kernels.hidden_stack(acts[:8192], *hstack)
    p3 = plain.hidden_stack_step(acts[:8192], plain_hstack)
    d3 = int((k3.int() - p3.int()).abs().max())
    check(d3 == 0, f"K3 hidden_stack B=8192 L={hstack[0].shape[0]} H={HIDDEN} bitwise (max |d| = {d3})")
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
    report["resident_softmax"]["max_abs_err"] = d4

    phase("5. main path: Scorer.score on the 432-7x2048-8000 net")
    sizes = (1000, 8192, 8300)  # 8300 buckets to 8320 > 8192: per-layer trunk
    want_p = {n: reference.score(frames[:n]) for n in sizes}
    kernels.reset_launch_counts()
    got_p = {n: scorer.score(frames[:n]) for n in sizes}
    launches = kernels.launch_counts()
    print(f"  launch counts of the main-path run: {launches}")
    for n in sizes:
        got, want = got_p[n], want_p[n]
        check(got.shape == (n, SENONES) and got.dtype == np.float32 and bool(np.isfinite(got).all()),
              f"n={n}: finite f32 [{n}, {SENONES}]")
        dp = float(np.abs(got - want).max())
        agree = float((got.argmax(1) == want.argmax(1)).mean())
        check(dp <= 1e-4 and agree >= 0.999,
              f"n={n}: max |dp| = {dp:.3g} <= 1e-4, argmax agreement {agree:.4f} >= 0.999")
        check(float(np.abs(got.astype(np.float64).sum(1) - 1).max()) <= 1e-5, f"n={n}: row sums 1 +- 1e-5")
    expect = {"bias_sigmoid_i8": 3, "hidden_stack": 2, "hidden_layer": DEPTH - 1, "resident_softmax": 3}
    for name, count in expect.items():
        check(launches[name] == count, f"{name} launched {launches[name]} times (expected {count})")

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_p = scorer.score(frames[:1000])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(np.array_equal(tf32_p, got_p[1000]), "the input layer ignores the TF32 switch (bitwise)")

    phase(f"6. times (median of {TIMED_REPS} CUDA-event-timed calls; card: {smi})")
    batch = frames_dev[:8192].contiguous()
    path_ms = time_ms(torch, lambda: scorer.score_device(batch))
    plain_path_ms = time_ms(torch, lambda: reference.score_device(batch))
    audio_s = 8192 / FRAMES_PER_AUDIO_SECOND
    print(f"  score_device B=8192 kernels: {path_ms:.4f} ms/batch, {audio_s / path_ms * 1e3:.1f} audio-s/s  [{smi}]")
    print(f"  score_device B=8192 plain:   {plain_path_ms:.4f} ms/batch, {audio_s / plain_path_ms * 1e3:.1f} audio-s/s  [{smi}]")
    cases = {
        "bias_sigmoid_i8": (lambda: kernels.bias_sigmoid_i8(lin, r.input_b),
                            lambda: plain.bias_sigmoid_i8(lin, r.input_b), "[8192, 2048]"),
        "hidden_layer": (lambda: kernels.hidden_layer(acts, *layer),
                         lambda: plain.hidden_layer_step(acts, *plain_layer), "B=8320 K=N=2048"),
        "hidden_stack": (lambda: kernels.hidden_stack(acts[:8192], *hstack),
                         lambda: plain.hidden_stack_step(acts[:8192], plain_hstack),
                         "B=8192 L=6 H=2048"),
        "resident_softmax": (lambda: kernels.resident_softmax(p3, *out, out_dim=SENONES),
                             lambda: plain.output_posteriors(p3, *plain_out, out_dim=SENONES),
                             "B=8192 K=2048 N=8064"),
    }
    for name, (kernel_fn, plain_fn, shape) in cases.items():
        report[name]["ms"] = time_ms(torch, kernel_fn)
        report[name]["plain_ms"] = time_ms(torch, plain_fn)
        print(f"  {name:17s} {shape:18s} kernel {report[name]['ms']:.4f} ms, "
              f"plain {report[name]['plain_ms']:.4f} ms  [{smi}]")

    rows = [
        {
            "name": name,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": launches[name],
            "max_abs_err": report[name]["max_abs_err"],
            "ms": report[name]["ms"],
            "plain_ms": report[name]["plain_ms"],
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
