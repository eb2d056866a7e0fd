"""Alignment / padding helpers (numpy only).

`aligned_size` reproduces the reference's x4 / x16 alignment semantics;
`pad_axis_to` zero-pads arrays to the kernels' tile multiples.
"""

from __future__ import annotations

import numpy as np


def aligned_size(size: int, alignment: int) -> int:
    """Round `size` up to a multiple of `alignment`."""
    if alignment <= 0:
        raise ValueError(f"alignment must be positive, got {alignment}")
    rem = size % alignment
    return size if rem == 0 else size + alignment - rem


def pad_axis_to(arr: np.ndarray, axis: int, target: int) -> np.ndarray:
    """Zero-pad `arr` along `axis` up to length `target` (no-op if equal)."""
    cur = arr.shape[axis]
    if cur == target:
        return arr
    if cur > target:
        raise ValueError(f"axis {axis} has size {cur} > target {target}")
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - cur)
    return np.pad(arr, widths)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
