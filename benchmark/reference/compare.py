"""The comparison that decides `correct`: the program's posteriors against
the reference's, answer group by answer group.

An answer group is what one kept request returned (a device batch, an
utterance's posteriors, or the frames of one lazily scored utterance).  For
each row the distance is the L1 norm of the difference of the two posterior
rows; a group reads the mean of its rows' distances, and the run reads its
worst group.  A single rounding of the input layer's product that moves one
sigmoid count cascades through the trunk to every senone of its row, so
the worst single row reads alike for any precision; the mean over a
group's rows counts how many rows such flips reach, which is what a lower
precision changes.  NaN reads as failing.
"""

from __future__ import annotations

import math
from typing import Iterable, Mapping

import torch

#: the numbers compared, by name, as the checks files give their limits
NUMBERS = ("worst_mean_row_l1",)


def row_l1(program: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """Per-row L1 distance (float64) of two [n, senones] posterior blocks;
    an answer of another shape is infinitely far from every row."""
    if program.shape != reference.shape:
        return torch.full((reference.shape[0],), math.inf, dtype=torch.float64)
    return (program.to(reference.device).double() - reference.double()).abs().sum(dim=1)


def numbers(group_distances: Iterable[torch.Tensor]) -> dict:
    """Per-row distances of each group -> the compared numbers."""
    worst = 0.0
    for d in group_distances:
        m = float(d.mean()) if d.numel() else 0.0
        worst = m if math.isnan(m) or math.isnan(worst) else max(worst, m)
    return {"worst_mean_row_l1": worst}


def judge(readings: Mapping[str, float], limits: Mapping[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value": reading, "limit": limit}}) with every
    number at or under its limit; NaN or a missing reading fails (and
    reads None)."""
    out = {}
    ok = True
    for name in NUMBERS:
        value = readings.get(name, float("nan"))
        limit = float(limits[name])
        good = not math.isnan(value) and value <= limit
        out[name] = {"value": None if math.isnan(value) else value, "limit": limit}
        ok = ok and good
    return ok, out
