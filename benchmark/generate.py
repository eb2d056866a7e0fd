"""The one traffic generator: it reads a traffic mix's data file
(traffic/<mix>.json) and makes the mix's inputs from the run's seed.

A mix holds:

  * "entry": the public entry of the program its caller drives, the
    module entries/<entry>.py;
  * "inputs": named parts, made in the file's order, each by the module
    inputs/<part>.py (`make(params, seed, config, device, traffic)`, which
    sets fields of the Traffic), from the parameters under its name;
  * "assumed" (optional): what its parameters take for granted.

A new mix is a data file; a new entry or input part is a new module.  The
yardsticks the parts share live here: the seeds of a run's streams, the
features (standard normal in the configuration's `feature_dim` columns, the
spliced features), the lognormal lengths and the decoder-style masks.
"""

from __future__ import annotations

import statistics
import zlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


def stream_seed(seed: int, name: str) -> int:
    """A 64-bit seed for the named stream of a run's seed (any integer)."""
    seq = np.random.SeedSequence([abs(seed), int(seed < 0), zlib.crc32(name.encode())])
    lo, hi = seq.generate_state(2, np.uint32)
    return int(hi) << 32 | int(lo)


def torch_generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, name))


def numpy_rng(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, name))


def lengths(spec: dict, count: int, rng: np.random.Generator) -> np.ndarray:
    """`count` utterance lengths: the lognormal quantiles at (i + 0.5) /
    count (median spec["median"], log-sd spec["sigma"]), clipped to
    [min, max], shuffled."""
    unit = statistics.NormalDist()
    quantiles = [unit.inv_cdf((i + 0.5) / count) for i in range(count)]
    raw = np.exp(np.log(spec["median"]) + spec["sigma"] * np.asarray(quantiles))
    out = np.clip(np.rint(raw), spec["min"], spec["max"]).astype(np.int64)
    return rng.permutation(out)


def generate_masks(rng, count, dim, density, churn_frac=0.03):
    """Evolving decoder-style masks, as the reference's functional test
    makes them: a random active set at `density`, then each frame turns
    `churn_frac` of the senones on and as many off.  (A frozen copy of the
    program's cli/score.py generate_masks.)"""
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


def features(shape: tuple, seed: int, config: dict, device) -> torch.Tensor:
    """Standard-normal spliced features [*shape, feature_dim], in one draw
    on `device`."""
    gen = torch_generator(seed, "features", device)
    return torch.randn((*shape, config["feature_dim"]), generator=gen, device=device)


@dataclass
class Traffic:
    """A mix's inputs.  The parts of this repository set the fields below;
    a new part may set fields of its own for its entry's caller."""

    entry: str
    #: device-resident batches [frames, input_dim] (the ring)
    batches: list = field(default_factory=list)
    #: host utterances [n, feature_dim] f32 (the pool)
    utterances: list = field(default_factory=list)
    #: each utterance's masks [n, output_dim] u8, or None
    masks: Optional[list] = None
    #: pool indices whose answers are kept for the comparison
    kept: frozenset = frozenset()


def make(params: dict, seed: int, config: dict, device) -> Traffic:
    """The mix's inputs for `seed`: each part of params["inputs"] in turn."""
    from . import spec

    traffic = Traffic(entry=params["entry"])
    for part, part_params in params["inputs"].items():
        spec.module("inputs", part).make(part_params, seed, config, torch.device(device), traffic)
    return traffic
