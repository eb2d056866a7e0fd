"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (fastdnn_tpu_torch).
The run draws the net's weights and the cell's traffic from the seed,
builds the program's system through the configuration's net module
(spec.net), warms every shape the traffic uses, then
drives the cell's entry in a closed loop for `--seconds`.  Once the window
has closed it frees the program and judges the answers it kept against the
net's plain reference, and prints, as the last line of standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics, read
from a torch.profiler trace of the window), `device`, with `--trace 1`
`breakdown`, and last `checks`, each compared number with its limit; the
same numbers are the last lines of standard error.

It exits non-zero, printing no result, without enough CUDA devices, when
the program cannot be imported, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

from . import spec as specs


# every cache a run could fill stays in the checkout, at a fixed path
_CACHE = specs.ROOT / "_bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "cuda")

import torch  # noqa: E402

from . import generate, timeline  # noqa: E402
from .record import Run  # noqa: E402
from .reference import compare  # noqa: E402

#: top-level modules that no run may load (compared whole)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fastdnn_tpu"})


def process_age_s() -> float:
    """Seconds since this process started (its start as the kernel records
    it, to a clock tick)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def _leaked() -> bool:
    """Whether a forbidden module is loaded; names it on standard error."""
    leaked = forbidden_modules()
    if leaked:
        print(f"forbidden modules loaded: {', '.join(leaked)}", file=sys.stderr)
    return bool(leaked)


def power_limit() -> str | None:
    """The card's power limit as nvidia-smi states it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def run_cell(spec: dict, cell: dict, seed: int, seconds: float, trace: bool, device, *,
             build=None, config_overrides: dict | None = None,
             traffic_overrides: dict | None = None):
    """One run of `cell` on `device` -> the result object, or None when a
    forbidden module was loaded: when the window closed, or by the time the
    result is made (the net's reference and work run after the window).
    `build(config, net, device)` makes the system under test (the net
    module's `build`, the program, by default; the controls put other
    things in its place); the overrides (tests only) replace keys of the
    configuration and the parameters of the traffic mix's input parts."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    config = dict(specs.config(spec, cell), **(config_overrides or {}))
    net_module = specs.net(config)
    if build is None:
        build = net_module.build  # the system under test
    params = specs.traffic(cell)
    for part, values in (traffic_overrides or {}).items():
        params["inputs"][part] = dict(params["inputs"][part], **values)
    limits = specs.limits(cell)

    marks = [("start", process_age_s())]
    net = net_module.draw(config, seed, device)
    marks.append(("weights", process_age_s()))
    scorer = build(config, net, device)
    marks.append(("system", process_age_s()))
    traffic = generate.make(params, seed, config, device)
    marks.append(("traffic", process_age_s()))
    caller = specs.caller(traffic.entry)(scorer, traffic, device, config["output_dim"])
    caller.warm()
    setup_s = process_age_s()
    marks.append(("warm-up", setup_s))
    print("set-up s: " + ", ".join(f"{name} {t - marks[i - 1][1]:.3f}" if i else f"{name} {t:.3f}"
                                   for i, (name, t) in enumerate(marks)), file=sys.stderr)

    prof = None
    span = contextlib.nullcontext
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities)
        prof.start()
        span = lambda: record_function(timeline.REQUEST_SPAN)
    requests = caller.run(seconds, span)
    tl = None
    if prof is not None:
        prof.stop()
        tl = timeline.from_profiler(prof, [r.counts for r in requests])
        if tl is None:
            print("the trace's request spans do not match the requests", file=sys.stderr)
        del prof
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    if _leaked():
        return None

    caller.release()
    del scorer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    with torch.inference_mode():
        reference = net_module.reference(config, net, device)
        readings = compare.numbers(caller.distances(reference))
    print(f"reference s: {time.perf_counter() - t_ref:.3f}", file=sys.stderr)
    correct, checks = compare.judge(readings, limits)
    failed = sum(not r.ok for r in requests)

    run = Run(cell, config, params, setup_s, requests, tl)
    metrics = {}
    for entry in specs.metrics(spec, cell, trace):
        value = specs.reader(entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": cell["chips"],
        "memory_peak_bytes": memory_peak,
    }
    if cuda:
        dev["power_limit"] = power_limit()
    result = {"correct": correct and failed == 0, "attempted": len(requests), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and tl is not None:
        dev["busy_s"] = tl.busy_s()
        dev["window_s"] = tl.window_s
        result["breakdown"] = timeline.breakdown(tl)
    result["checks"] = checks
    if _leaked():  # again: the net's reference and work ran since
        return None
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = specs.load()
    cell = specs.workload(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    if result is None:
        return 1
    for name, check in result["checks"].items():
        print(f"check {name} = {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
