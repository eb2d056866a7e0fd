"""Decoder-loop emulation on the PyTorch/CUDA port: realistic lazy (masked)
acoustic scoring, as the JAX package's examples/lazy_decoder.py shows it.

An ASR beam-search decoder keeps 30-50% of the senones active and churns
~3% of them per frame as beams evolve.  Two ways to consume the engine:

  1. BATCH (recommended): the decoder runs one frame behind and hands the
     engine the whole utterance's mask matrix at once: one
     `Scorer.score_masked` call (the fused masked kernel, K4, on the card).
  2. STREAMING (the reference's API shape): `LazyContext` scores frame by
     frame, one launch (K5) and one host round trip per frame.

The two agree bitwise on the plain versions (--device cpu).  On the card
they take different kernels whose softmax sums in different orders, and
agree within 3e-5 (CLAUDE.md's bound, chip_smoke phase 21); the demo
asserts the bound that holds where it runs.

    python -m fastdnn_tpu_torch.examples.lazy_decoder [--device cuda|cpu]
        [--features F] [--model model.bin] [--density 0.4]
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from . import _common

#: the kernels' batch against frame-by-frame posteriors
KERNEL_ATOL = 3e-5


def evolving_masks(rng, frames, senones, density, churn=0.03):
    """Initial random active set, then +/-churn per frame (the reference's
    functional test's mask shape)."""
    masks = np.zeros((frames, senones), np.uint8)
    active = max(1, int(senones * density))
    masks[0, rng.choice(senones, active, replace=False)] = 1
    flip = max(1, int(senones * churn))
    for t in range(1, frames):
        masks[t] = masks[t - 1]
        off = np.flatnonzero(masks[t] == 0)
        on = np.flatnonzero(masks[t] == 1)
        masks[t, rng.choice(off, min(flip, off.size), replace=False)] = 1
        if on.size > flip:
            masks[t, rng.choice(on, flip, replace=False)] = 0
    return masks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m fastdnn_tpu_torch.examples.lazy_decoder")
    _common.add_flags(p)
    p.add_argument("--model", default=None,
                   help="reference-format binary model (default: random 5x1024/4000)")
    p.add_argument("--density", type=float, default=0.4)
    args = p.parse_args(argv)
    device = _common.device_of(args)

    import fastdnn_tpu_torch as fdt

    with tempfile.TemporaryDirectory(prefix="fastdnn_torch_demo_") as td:
        frames = _common.load_frames(args.features, td)
    if args.model:
        net = fdt.load_model(args.model)
    else:
        net = fdt.align(fdt.random_net(np.random.default_rng(0), _common.FEATURE_DIM,
                                       [1024] * 5, 4000), 4, 16)
    scorer = fdt.Scorer(fdt.quantize_net(net, cutoff=3.0), device=device)
    masks = evolving_masks(np.random.default_rng(1), len(frames), scorer.output_dim,
                           args.density)

    # -- pattern 1: whole-utterance masked scoring (one call) ---------------
    scorer.score_masked(frames, masks)  # warm-up (the first CUDA call builds the kernels)
    t0 = time.perf_counter()
    post = scorer.score_masked(frames, masks)
    dt = time.perf_counter() - t0
    print(f"batch lazy: {len(frames)} frames in {dt * 1e3:.1f} ms "
          f"({len(frames) / dt / 100:.1f} audio-s/s incl. host I/O)")
    print(f"  posteriors {post.shape}, rowsum [{post.sum(1).min():.5f}, {post.sum(1).max():.5f}]")

    # -- pattern 2: frame-by-frame LazyContext (the reference's API shape) --
    ctx = scorer.new_lazy_context(len(frames))
    t0 = time.perf_counter()
    ctx.calculate_until_output(frames)
    per_frame = [ctx.calculate_for_output_nodes(masks[t]) for t in range(len(frames))]
    dt = time.perf_counter() - t0
    print(f"streaming lazy: {len(frames)} frames in {dt * 1e3:.1f} ms "
          f"(one launch per frame, like the reference's JNI loop)")

    drift = max(float(np.abs(a - b).max()) for a, b in zip(per_frame, post))
    print(f"  max |batch - streaming| = {drift:.2e}")
    bound = KERNEL_ATOL if scorer.backend == "cuda" else 0.0
    _common.check(drift <= bound, f"batch and streaming differ by {drift} > {bound} on "
                                  f"{scorer.backend}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
