"""The yardsticks of the stats route's two kernels, each alone: K8
(`flash_stats`: the output layer's logits and each row's (max, sum-exp))
and its normalize (`normalize_stats`: exp(z - m) / s), which the program
runs in place of the resident softmax when the output layer's input is
wider than that kernel holds.  roofline.output_dense counts the layer's
work once, whatever kernels compute it; these count what each of the two
kernels has to move, so that the readers show which one pays for the
logits' round trip through device memory.

Counted over the true senones (the configuration's `output_dim`), each
byte once, at the peaks of roofline.py:

  * K8: 2 n K N int8 operations; the activations [n, K] and the weight
    [K, N] int8, the zero-point sums and biases (8 N), z written as f32
    [n, N] and each row's (max, sum-exp) (8 n);
  * the normalize: z read and the posteriors written as f32 (4 n N each)
    and the row stats read (8 n), by bytes alone: its exponentials run
    outside the tensor cores, and no peak of them is counted.
"""

from __future__ import annotations

from . import kernel_table
from .roofline import Work, shapes


def flash_stats(config: dict, frames: int) -> Work:
    _, hidden, n_out = shapes(config)
    k = hidden[-1]
    return Work(2.0 * frames * k * n_out,
                frames * k + k * n_out + 8.0 * n_out + 4.0 * frames * n_out + 8.0 * frames,
                "int8")


def normalize(config: dict, frames: int) -> Work:
    _, _, n_out = shapes(config)
    return Work(0.0, 8.0 * frames * n_out + 8.0 * frames, "int8")


def kernel_share(run, kernel: str, work) -> float | None:
    """`kernel`'s roofline share in a traced run, in %: the least time of
    the work (`work(config, frames)`) of every request's dense output
    frames, over the device time of the kernels kernel_table names
    `kernel`, in the window.  None without a trace, such a request or such
    a kernel."""
    tl = run.timeline
    if tl is None:
        return None
    a, b = tl.window
    rows = [(sym, min(e, b) - max(s, a)) for s, e, sym in tl.device if e > a and s < b]
    device_s = kernel_table.by_kernel(rows)[0].get(kernel, 0.0)
    bound_s = sum(work(run.config, c["output_frames"]).bound_s
                  for _, _, c in tl.requests if c.get("output_frames"))
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s
