"""What the demos share: the device and feature flags, and their frames.

The JAX package's demos read the reference's bundled feature file.  Here
the frames come from --features PATH (a reference-format feature file),
or else are drawn from a seed, written with `write_features` into a
temporary directory and read back with `read_features`, so that the file
path is exercised either way.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..formats.binary import read_features, write_features

#: the synthetic utterance: spliced features of the reference's width
FRAMES, FEATURE_DIM = 300, 429


def add_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the hand-written kernels (fails without a GPU); "
                   "cpu: their plain versions")
    p.add_argument("--features", default=None,
                   help="reference-format feature file (default: seeded synthetic frames)")


def check(ok: bool, what: str) -> None:
    """A demo's claim: raise when it does not hold (an assert would vanish
    under python -O)."""
    if not ok:
        raise AssertionError(what)


def device_of(args) -> torch.device:
    """The demo's device; --device cuda without a card raises."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available; pass --device cpu")
    return torch.device(args.device)


def synthetic_frames(seed: int = 0, count: int = FRAMES, dim: int = FEATURE_DIM) -> np.ndarray:
    """Piecewise-stationary frames, as speech is: segments of 5-15 frames,
    each a noisy copy of one of 40 prototype vectors (a phone-like unit)."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((40, dim), dtype=np.float32)
    segments, n = [], 0
    while n < count:
        length = int(rng.integers(5, 16))
        noise = rng.standard_normal((length, dim), dtype=np.float32) * np.float32(0.3)
        segments.append(protos[rng.integers(len(protos))] + noise)
        n += length
    return np.concatenate(segments)[:count]


def frames_file(features: Optional[str], workdir, seed: int = 0) -> Path:
    """The feature file to read: `features`, or `synthetic_frames` written
    to `workdir`/frames.bin."""
    if features is not None:
        return Path(features)
    path = Path(workdir) / "frames.bin"
    write_features(synthetic_frames(seed), path)
    return path


def load_frames(features: Optional[str], workdir, seed: int = 0) -> np.ndarray:
    """f32 [frames, dim] read by path from `frames_file`."""
    return read_features(frames_file(features, workdir, seed))
