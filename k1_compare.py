#!/usr/bin/env python3
"""K1 (bias_sigmoid_i8) built from several kernel sources, timed side by side
on one CUDA card.

    python3 k1_compare.py [CSRC_DIR ...]

Each CSRC_DIR holds a `bias_sigmoid.cu` with the C entry
`fdn_bias_sigmoid_i8` and the `common.cuh` it includes, for example the
`fastdnn_tpu_torch/csrc` of an earlier commit unpacked with `git archive`;
this tree's own csrc is always timed too.  Each source is built alone with
the port's nvcc flags and called through ctypes by one shared wrapper, so
the builds differ only in their kernel and C entry.  At [8192, 2048] each
must equal the plain version bitwise; then, in turns (a, b, ..., b, a),
each is timed as a single call (CUDA events, the host time included), 20
calls queued back to back, under torch.profiler, and by the host time per
call (200 unsynchronized calls, median of 5 runs).  chip_smoke.py's timing
helpers do the timing.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import chip_smoke as cs

ROWS, COLS = 8192, 2048


def build(csrc: Path, out_dir: Path):
    """csrc/bias_sigmoid.cu alone -> its fdn_bias_sigmoid_i8 through ctypes."""
    from fastdnn_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    obj, lib = out_dir / "k1.o", out_dir / "libk1.so"
    for cmd in (_build.nvcc_command(nvcc, csrc / "bias_sigmoid.cu", obj),
                _build.link_command(nvcc, [obj], lib)):
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).fdn_bias_sigmoid_i8
    fn.restype, fn.argtypes = _build._SIGNATURES["fdn_bias_sigmoid_i8"]
    return fn


def main(argv: list[str]) -> int:
    import torch

    from fastdnn_tpu_torch.ops import matmul as plain

    if not torch.cuda.is_available():
        print("k1_compare: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    dirs = [Path(d) for d in argv] + [Path(__file__).resolve().parent / "fastdnn_tpu_torch" / "csrc"]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED)
    lin = torch.from_numpy(rng.normal(0, 8, (ROWS, COLS)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(0, 1, COLS).astype(np.float32)).to(dev)
    want = plain.bias_sigmoid_i8(lin, bias)
    stream = torch.cuda.current_stream(dev).cuda_stream

    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, d in enumerate(dirs):
            out_dir = Path(tmp) / str(i)
            out_dir.mkdir()
            entry = build(d, out_dir)

            def call(entry=entry):
                out = torch.empty((ROWS, COLS), dtype=torch.int8, device=dev)
                status = entry(lin.data_ptr(), bias.data_ptr(), out.data_ptr(), lin.numel(), COLS,
                               dev.index, stream)
                if status != 0:
                    raise RuntimeError(f"fdn_bias_sigmoid_i8 failed with cudaError {status}")
                return out

            cs.check(torch.equal(call(), want), f"{d}: K1 [{ROWS}, {COLS}] equals its plain version")
            fns[str(d)] = call

        def profiled(torch, fn):
            _, device = cs.profile_device(torch, fn, 20)
            cs.check(bool(device), "the profiler recorded device time")
            return sum(ms for _, ms in device)

        def host_us(torch, fn, calls: int = 200, reps: int = 5):
            """Median over `reps` of the host time per call of `calls`
            unsynchronized calls: too few to fill the launch queue, so the
            host never waits for the card."""
            per_call = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                per_call.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
            return statistics.median(per_call)

        bound = ROWS * COLS * 5 / cs.HBM_BYTES_PER_S * 1e3
        print(f"K1 [{ROWS}, {COLS}], bound {bound:.4f} ms (bytes), in turns  [{smi}]")
        for what, timer in (("single ms", cs.time_ms), ("20 queued ms per call", cs.back_to_back_ms),
                            ("profiler ms", profiled), ("host us per call", host_us)):
            times = cs.in_turns(torch, fns, timer)
            for name, ts in times.items():
                print(f"  {what:22s} {ts[0]:.4f} / {ts[1]:.4f}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
