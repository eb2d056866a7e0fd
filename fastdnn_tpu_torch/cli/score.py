"""Scorer CLI of the PyTorch/CUDA port, the single-device path of
fastdnn_tpu/cli/score.py:

    python -m fastdnn_tpu_torch.cli.score MODEL INPUT [OUT] [BIN|TXT]
        [--cutoff F] [--hidden-bits 8|4] [--int4-packed] [--device cuda|cpu]
        [--mask-density F] [--lazy-mode auto|dense|gathered|block_sparse]
        [--seed N] [--text-input]

Loads a reference-format binary model (quantized on load, with an int4
hidden trunk under --hidden-bits 4) or a `.npz` checkpoint and a binary
feature matrix, scores it (lazily, with synthetic evolving masks, under
--mask-density), prints topology and timing, and dumps posteriors to stdout
or to a file in BIN or TXT format.  --text-input reads a Kaldi text feature
file instead, scores every utterance in one pass and writes the posteriors
as Kaldi text under the utterance ids.  --int4-packed stores an int4 trunk
two nibbles per byte (EngineConfig.int4_packed), a port option the JAX CLI
does not have.  `--device cuda` (the default) runs the hand-written
kernels and fails when no GPU is present; `--device cpu` runs their plain
PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..config import EngineConfig
from ..engine.scorer import Scorer
from ..formats.binary import read_features, write_features, write_features_text
from ..formats.kaldi_text import load_features_text, write_features_text_kaldi
from ..quant.serialize import load_quantized


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fastdnn-torch-score",
        description="Score acoustic features with a quantized DNN (PyTorch/CUDA)",
    )
    p.add_argument("model", help="reference-format binary model, or a .npz checkpoint")
    p.add_argument("input", help="feature file: binary matrix, or Kaldi text with --text-input")
    p.add_argument("out", nargs="?", default=None, help="output file (default: stdout)")
    p.add_argument(
        "out_type", nargs="?", default="TXT", choices=["BIN", "TXT"], help="output format"
    )
    p.add_argument("--cutoff", type=float, default=3.0, help="weight quantization cutoff")
    p.add_argument(
        "--hidden-bits", type=int, default=None, choices=[8, 4],
        help="hidden-trunk weight width: 4 halves the weight bytes (the output "
        "layer stays int8); a checkpoint's stored width must match",
    )
    p.add_argument(
        "--int4-packed", action="store_true",
        help="store an int4 trunk two nibbles per byte and run the packed "
        "hidden-layer kernel (config.EngineConfig.int4_packed)",
    )
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="cuda: hand-written kernels (fails without a GPU); cpu: plain versions",
    )
    p.add_argument(
        "--mask-density",
        type=float,
        default=None,
        help="if set, score lazily with synthetic evolving masks at this active density",
    )
    p.add_argument(
        "--lazy-mode",
        default="auto",
        choices=["auto", "dense", "gathered", "block_sparse"],
        help="masked-scoring strategy (config.EngineConfig.lazy_mode); block_sparse "
        "skips all-inactive tiles (cuda only; pair with clustered senone ids, "
        "engine.cluster)",
    )
    p.add_argument("--seed", type=int, default=1, help="seed of the synthetic masks")
    p.add_argument(
        "--text-input", action="store_true",
        help="input is a Kaldi text feature file; every utterance is scored in "
        "one pass and the output keeps utterance ids (text format)",
    )
    return p


def generate_masks(rng, count, dim, density, churn_frac=0.03):
    """Evolving decoder-style masks, as the reference's functional test
    makes them: a random active set at `density`, then each frame turns
    `churn_frac` of the senones on and as many off."""
    active = max(1, int(dim * density))
    churn = max(1, int(dim * churn_frac))
    masks = np.zeros((count, dim), dtype=np.uint8)
    masks[0, rng.choice(dim, size=active, replace=False)] = 1
    for i in range(1, count):
        masks[i] = masks[i - 1]
        off = np.flatnonzero(masks[i] == 0)
        on = np.flatnonzero(masks[i] == 1)
        if off.size:
            masks[i, rng.choice(off, size=min(churn, off.size), replace=False)] = 1
        if on.size > churn:
            masks[i, rng.choice(on, size=churn, replace=False)] = 0
    return masks


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.text_input and args.mask_density is not None:
        raise ValueError(
            "--text-input scores all utterances in one pass and does not combine "
            "with --mask-density"
        )
    qnet, topology = load_quantized(args.model, cutoff=args.cutoff, hidden_bits=args.hidden_bits)
    print(f"Model File  = {args.model}")
    print(f"Network     = {topology}")
    config = EngineConfig(lazy_mode=args.lazy_mode, int4_packed=args.int4_packed)
    if args.text_input:
        utts = load_features_text(args.input)
        n = sum(m.shape[0] for m in utts.values())
        print(f"Input       = {len(utts)} utterances, {n}x{next(iter(utts.values())).shape[1]}")
        scorer = Scorer(qnet, config, device=args.device)
        t0 = time.perf_counter()
        scored = scorer.score_utterances(utts)
        print(f"Dnn calculation time = {(time.perf_counter() - t0) * 1000:.2f} ms.")
        write_features_text_kaldi(scored, args.out if args.out else sys.stdout)
        return 0
    frames = read_features(args.input)
    print(f"Input       = {frames.shape[0]}x{frames.shape[1]}")
    scorer = Scorer(qnet, config, device=args.device)

    masks = None
    if args.mask_density is not None:
        rng = np.random.default_rng(args.seed)
        masks = generate_masks(rng, frames.shape[0], scorer.output_dim, args.mask_density)

    def run(n: int) -> np.ndarray:
        if masks is None:
            return scorer.score(frames[:n])
        return scorer.score_masked(frames[:n], masks[:n])

    run(1)  # warm-up: the first CUDA call builds the kernels
    t0 = time.perf_counter()
    output = run(frames.shape[0])  # returns host numpy, so the device is done
    elapsed_ms = (time.perf_counter() - t0) * 1000
    device = torch.cuda.get_device_name(scorer.device) if scorer.device.type == "cuda" else "cpu"
    print(f"Dnn calculation time = {elapsed_ms:.2f} ms. ({device})")

    if args.out is None:
        np.savetxt(sys.stdout, output, fmt="%f", delimiter=" ")
    elif args.out_type == "BIN":
        write_features(output, args.out)
    else:
        write_features_text(output, args.out)
    return 0


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
