"""The readings the comparison's limits are set from, on the card, at a
cell's own size: the compared numbers of the program over many seeds (the
lower reading), and of the controls over a few (the upper reading):

  * "tf32": the reference put in the program's place with its input
    layer's product one precision below the configured f32 (operands
    rounded to TF32);
  * "bf16": the program's own lower-precision input path
    (input_precision "default", both operands rounded to bf16);
  * "int4": the program's own int4 hidden trunk (hidden_bits 4).

    python3 -m benchmark.controls --workload <cell> --seconds <s> \\
        --seeds 11 12 ... --control-seeds 21 22 23 [--out <file.jsonl>]

One JSON line per run (cell, variant, seed, numbers, correct), then a
summary line: the largest program reading and the smallest of each
control.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import spec as specs
from .reference.net import softmax
from .run import run_cell


class ReferenceScorer:
    """A net's reference (its module's `reference`) with the entry points
    that the callers (entries/) call."""

    def __init__(self, ref):
        self.ref = ref

    def score_device(self, frames: torch.Tensor) -> torch.Tensor:
        return self.ref.posteriors(frames)

    def score(self, frames) -> np.ndarray:
        return self.ref.posteriors(torch.from_numpy(np.asarray(frames, np.float32))).cpu().numpy()

    def new_lazy_context(self, n: int) -> "_ReferenceLazy":
        return _ReferenceLazy(self.ref)


class _ReferenceLazy:
    def __init__(self, ref):
        self.ref = ref

    def calculate_until_output(self, frames) -> None:
        self.counts = self.ref.hidden(torch.from_numpy(np.asarray(frames, np.float32)))
        self.i = 0

    def calculate_for_output_nodes(self, mask) -> np.ndarray:
        z = self.ref.logits(self.counts[self.i : self.i + 1])
        active = torch.from_numpy(np.asarray(mask)).to(z.device)[None] != 0
        self.i += 1
        return softmax(torch.where(active, z, 0.0))[0].cpu().numpy()


def system_for(variant: str):
    """The system under test for a variant, from the configuration's net
    (spec.net): the program, one of its lower-precision paths, or the
    reference one precision below."""
    if variant == "program":
        return lambda config, net, device: specs.net(config).build(config, net, device)
    if variant == "bf16":
        return lambda config, net, device: specs.net(config).build(
            config, net, device, engine={"input_precision": "default"})
    if variant == "int4":
        return lambda config, net, device: specs.net(config).build(config, net, device,
                                                                   hidden_bits=4)
    if variant == "tf32":
        return lambda config, net, device: ReferenceScorer(
            specs.net(config).reference(config, net, device, input_rounding="tf32"))
    raise ValueError(f"unknown variant {variant!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--variants", nargs="*", default=["tf32", "bf16", "int4"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the controls are read on a CUDA device", file=sys.stderr)
        return 2
    spec = specs.load()
    cell = specs.workload(spec, args.workload)
    runs = [("program", s) for s in args.seeds]
    runs += [(v, s) for v in args.variants for s in args.control_seeds]
    summary: dict = {}
    out = open(args.out, "a") if args.out else None
    try:
        for variant, seed in runs:
            result = run_cell(spec, cell, seed, args.seconds, False, "cuda:0",
                              build=system_for(variant))
            numbers = {k: v["value"] for k, v in result["checks"].items()}
            line = {"workload": cell["name"], "variant": variant, "seed": seed,
                    "numbers": numbers, "correct": result["correct"],
                    "attempted": result["attempted"]}
            print(json.dumps(line), flush=True)
            if out:
                print(json.dumps(line), file=out, flush=True)
            for name, value in numbers.items():
                value = float("inf") if value is None else value
                pick = max if variant == "program" else min
                key = f"{variant}.{name}"
                summary[key] = value if key not in summary else pick(summary[key], value)
    finally:
        if out:
            out.close()
    print(json.dumps({"workload": cell["name"], "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
