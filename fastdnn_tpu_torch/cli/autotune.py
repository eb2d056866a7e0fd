"""Launch-knob autotuner of the PyTorch/CUDA port, after tools/autotune.py:
find the fastest value of each registry knob (tuning.TUNED_KEYS) for a net
shape and batch on the card, and optionally commit it to the registry.

    python -m fastdnn_tpu_torch.cli.autotune                  # flagship, B = 8192
    python -m fastdnn_tpu_torch.cli.autotune --hidden 1024 --layers 5 --out-dim 4000
    python -m fastdnn_tpu_torch.cli.autotune --batch 1024 --commit
                                                              # fastdnn-torch-autotune

The knob is `stack_hidden_max_frames`: batches of at most that many frames
run the trunk as one K3 launch, larger ones as one K2 launch per layer.
The sweep runs the profiler's `stack` ladder up to --batch: at each B the
full pass (`Scorer.score_device`) with the stack always on against the
stack off, timed in turns by device time (cli/profile.py), and the knob
takes the largest B at which the stack still wins, 0 if it never does.
Every Scorer is built with autotuned=False, so that a committed entry
cannot move what the sweep says it measures.

Correctness gate, set outside the sweep: on a 256-frame probe each
candidate's posteriors must be bitwise the default Scorer's (the knob is a
schedule only) and within 3e-5 of the plain path (backend="torch"); a
candidate that fails is disqualified with its reason and timed as inf.

Output: a table, then ONE JSON line (the registry entry): net, batch,
platform ("cuda"), device_kind, default_ms, best_ms, speedup_vs_default,
knobs.  --commit merges it into the registry (tuning.merge_entry) and is
refused off the card.  `--device cpu` runs the plain versions as a smoke
path (device times 0).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from .. import tuning
from ..config import EngineConfig
from . import profile

#: the plain path's bound on every candidate's posteriors (CLAUDE.md's
#: kernel-against-reference bound)
GATE_ATOL = 3e-5
PROBE_FRAMES = 256


def _build(qnet, device, **fields):
    """A candidate Scorer: the config's defaults with `fields`, never
    consulting the registry."""
    from ..engine.scorer import Scorer

    return Scorer(qnet, EngineConfig(autotuned=False, **fields), device=device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fastdnn-torch-autotune",
                                description="Sweep the registry's launch knobs on the card")
    p.add_argument("--hidden", type=int, default=2048)
    p.add_argument("--layers", type=int, default=7)
    p.add_argument("--out-dim", type=int, default=8000)
    p.add_argument("--input-dim", type=int, default=432)
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--reps", type=int, default=5, help="profiled calls per measurement")
    p.add_argument("--out", default=None, help="also write the JSON entry to a file")
    p.add_argument(
        "--commit", action="store_true",
        help="merge the entry into the registry (fastdnn_tpu_torch/tuned.json, or the "
        "user state file, or $FASTDNN_TUNED) so that a Scorer on this card picks it up; "
        "refused off the card",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the kernels (fails without a GPU); cpu: the plain versions")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available; pass --device cpu")
    if args.batch < 1 or args.reps < 1:
        raise ValueError("--batch and --reps must be >= 1")
    if device.type == "cuda" and args.batch % EngineConfig.frame_bucket:
        raise ValueError(f"--batch must be a multiple of the frame bucket "
                         f"{EngineConfig.frame_bucket} on the card, got {args.batch}")
    if device.type != "cuda":
        print("WARNING: no card: a smoke run of the plain versions, times meaningless",
              flush=True)

    from ..models.feedforward import random_net
    from ..quant.quantize import quantize_net

    net = random_net(np.random.default_rng(0), args.input_dim, [args.hidden] * args.layers,
                     args.out_dim)
    qnet = quantize_net(net, cutoff=3.0)
    frames = np.random.default_rng(0).standard_normal((args.batch, qnet.input_dim),
                                                      dtype=np.float32)
    probe = frames[:min(PROBE_FRAMES, args.batch)]
    frames_dev = torch.from_numpy(frames).to(device)
    ctx = profile.Context(device, args.batch, args.reps)

    # the yardsticks, established outside the sweep: the plain path bounds
    # every posterior and the default Scorer is the bitwise reference
    try:
        want_plain = _build(qnet, device, backend="torch").score(probe)
        default = _build(qnet, device)
        want_default = default.score(probe)
        d = float(np.abs(want_default - want_plain).max())
        if d > GATE_ATOL:
            raise ValueError(f"the default Scorer is {d:.3g} from the plain path")
    except Exception as e:
        print(f"FATAL: the yardsticks could not be established: {type(e).__name__}: {e}",
              flush=True)
        return 2

    ladder = [b for b in profile.STACK_LADDER if b < args.batch] + [args.batch]
    candidates = {"stack": {"stack_hidden_max_frames": args.batch},
                  "per_layer": {"stack_hidden_max_frames": 0}}

    def gate(name, fields):
        """The candidate Scorer, or None when it is disqualified."""
        try:
            sc = _build(qnet, device, **fields)
            got = sc.score(probe)
        except Exception as e:  # e.g. a shape a kernel refuses
            print(f"  {name} {fields} disqualified: {type(e).__name__}: {e}", flush=True)
            return None
        if not np.array_equal(got, want_default):
            d = float(np.abs(got - want_default).max())
            print(f"  {name} {fields} disqualified: posteriors differ from the default "
                  f"Scorer's by up to {d:.3g} (a schedule must be bitwise)", flush=True)
            return None
        d = float(np.abs(got - want_plain).max())
        if d > GATE_ATOL:
            print(f"  {name} {fields} disqualified: {d:.3g} from the plain path "
                  f"(> {GATE_ATOL})", flush=True)
            return None
        print(f"  {name} {fields}: bitwise the default, {d:.3g} from the plain path",
              flush=True)
        return sc

    print(f"gate on a {probe.shape[0]}-frame probe:", flush=True)
    scorers = {name: gate(name, fields) for name, fields in candidates.items()}
    if not any(scorers.values()):
        print("FATAL: every candidate was disqualified", flush=True)
        return 2

    def call(name, b):
        sc = scorers[name]
        return None if sc is None else (lambda: sc.score_device(frames_dev[:b]))

    print("\nsweep of stack_hidden_max_frames (device ms per call, in turns):", flush=True)
    rows = {}
    for b in ladder:
        s, p = call("stack", b), call("per_layer", b)
        if s is not None and p is not None:
            rows.update(profile.stack_rows(ctx, lambda _: s, lambda _: p, [b]))
            continue
        # a disqualified candidate is timed as inf
        rows[b] = {"stack_ms": ctx.ms(s) if s else math.inf,
                   "per_layer_ms": ctx.ms(p) if p else math.inf}
        print(f"B={b:5d}  per-layer {rows[b]['per_layer_ms']:8.4f} ms  stack "
              f"{rows[b]['stack_ms']:8.4f} ms", flush=True)
    threshold = profile.stack_threshold(rows)
    knobs = {"stack_hidden_max_frames": threshold}
    best_ms = rows[args.batch]["stack_ms" if threshold >= args.batch else "per_layer_ms"]
    default_ms = ctx.ms(lambda: default.score_device(frames_dev))
    print(f"defaults {EngineConfig.stack_hidden_max_frames}: {default_ms:8.4f} ms; best "
          f"{knobs}: {best_ms:8.4f} ms per {args.batch} frames", flush=True)

    entry = {
        "net": tuning.net_key(qnet),
        "batch": args.batch,
        "platform": device.type,
        "device_kind": tuning.device_kind(device) if device.type == "cuda" else "cpu",
        "default_ms": default_ms,
        "best_ms": best_ms,
        "speedup_vs_default": default_ms / best_ms if best_ms > 0 else 1.0,
        "knobs": knobs,
    }
    line = json.dumps(entry)
    print("\n" + line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if args.commit:
        if entry["platform"] != "cuda":
            print("--commit refused: the plain versions' times are meaningless", flush=True)
            return 1
        tuning.merge_entry(entry)
        print(f"committed to {tuning.registry_path()}", flush=True)
    return 0


def _cli(argv=None) -> int:
    """Entry point with one-line error reporting for expected failures
    (no GPU, bad parameters)."""
    try:
        return main(argv)
    except (OSError, ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(_cli())
