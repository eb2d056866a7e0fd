"""The yardstick of a low-rank output layer's bottleneck kernel alone
(`lowrank_bottleneck`: the first product of the output layer, its signed
codes and each frame's scale), as stats_route.py keeps K8's: what the
kernel has to move, so that bottleneck_roofline shows its share apart from
the expand product's (K4's) in the output layer's roofline.

Counted once, at the peaks of roofline.py: 2 n H k int8 operations; the
last hidden counts [n, H] and the int8 factor [H, k] in, its int32
zero-point sums (4 k), the codes [n, k] and each frame's f32 scale (4 n)
out.  The configuration gives H (its last hidden width) and k (`rank`).
"""

from __future__ import annotations

from .roofline import Work


def bottleneck(config: dict, frames: int) -> Work:
    h, k = config["hidden_widths"][-1], config["rank"]
    return Work(2.0 * frames * h * k, frames * h + h * k + 4.0 * k + frames * k + 4.0 * frames,
                "int8")
