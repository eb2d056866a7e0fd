"""The yardstick of the per-layer rooflines and of the step's share of the
peak: the work each layer of the net does for a request, counted from the
configuration's shapes by the net's module (spec.net: its `work`; the
feed-forward net's counts are below), and the card's published peaks.

A layer's own work is counted once, whatever kernel computes it: each input
byte read once and each output byte written once, the operations of its
product (2 per multiply-add) at the precision the configuration states.
The input layer's f32 product counts once at the TF32 peak (the kernel that
computes it may take several passes); the int8 layers at the int8 peak.
The lazy output layer counts what the frame's mask needs: the active
senones' weight rows, bias and zero-point sums and products, the mask, and
the posterior row written out (inactive senones too, as the reference's
semantics give them a posterior).

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import kernel_table
from . import spec as specs

PEAK_OPS_PER_S = {"tf32": 495e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12

@dataclass(frozen=True)
class Work:
    ops: float
    bytes: float
    precision: str

    @property
    def peak_s(self) -> float:
        """Seconds at the peak rate of the layer's precision."""
        return self.ops / PEAK_OPS_PER_S[self.precision]

    @property
    def bound_s(self) -> float:
        """The least time the card could take: operations over the peak or
        bytes over the memory bandwidth, whichever is longer."""
        return max(self.peak_s, self.bytes / HBM_BYTES_PER_S)


def shapes(config: dict) -> tuple[int, list[int], int]:
    """(input width, hidden widths, senones) of a configuration file."""
    return config["input_dim"], list(config["hidden_widths"]), config["output_dim"]


def input_layer(config: dict, frames: int) -> Work:
    """f32 frames [n, in] @ f32 [in, h0] + bias -> int8 counts [n, h0]."""
    k, hidden, _ = shapes(config)
    h = hidden[0]
    return Work(2.0 * frames * k * h, 4.0 * frames * k + 4.0 * k * h + 4.0 * h + frames * h,
                "tf32")


def trunk(config: dict, frames: int) -> Work:
    """The int8 hidden layers after the input layer: int8 counts in, each
    layer's int8 weights, int32 zero-point sums and f32 biases, int8 counts
    out."""
    _, hidden, _ = shapes(config)
    ops = sum(2.0 * frames * a * b for a, b in zip(hidden, hidden[1:]))
    params = sum(a * b + 8.0 * b for a, b in zip(hidden, hidden[1:]))
    return Work(ops, frames * hidden[0] + params + frames * hidden[-1], "int8")


def output_dense(config: dict, frames: int) -> Work:
    """int8 counts [n, h] @ int8 [h, N], softmax -> f32 posteriors [n, N]."""
    _, hidden, n_out = shapes(config)
    h = hidden[-1]
    return Work(2.0 * frames * h * n_out,
                frames * h + h * n_out + 8.0 * n_out + 4.0 * frames * n_out, "int8")


def output_lazy(config: dict, active: int) -> Work:
    """One frame under a mask with `active` senones: its activation row, the
    active senones' weight rows, zero-point sums and biases, the mask, and
    the f32 posterior row."""
    _, hidden, n_out = shapes(config)
    h = hidden[-1]
    return Work(2.0 * h * active, h + active * h + 8.0 * active + n_out + 4.0 * n_out, "int8")


def request_work(config: dict, counts: dict) -> dict:
    """A request's counters (see caller.py) -> {layer: Work} for the
    layers it ran: the feed-forward net's `work` (nets/feedforward.py)."""
    work = {}
    if counts.get("hidden_frames"):
        work["input_layer"] = input_layer(config, counts["hidden_frames"])
        work["trunk"] = trunk(config, counts["hidden_frames"])
    if counts.get("output_frames"):
        work["output_dense"] = output_dense(config, counts["output_frames"])
    if "lazy_active" in counts:
        work["output_lazy"] = output_lazy(config, counts["lazy_active"])
    return work


def _requests_work(run):
    work = specs.net(run.config).work
    return [work(run.config, counts) for _, _, counts in run.timeline.requests]


def layer_share(run, layer: str):
    """The layer's roofline share in a traced run, in %: the least time of
    the work its requests asked for, over the device time of the kernels
    that kernel_table assigns to it, in the window.  The lazy output layer
    also takes every PyTorch kernel of the window, as it has since its
    masked softmax ran in torch ops; a lazily scored frame now runs
    `lazy_output` alone, so the lazy cells' traces hold none.  None where
    the layer did no work or ran no kernel."""
    tl = run.timeline
    if tl is None:
        return None
    a, b = tl.window
    rows = [(sym, min(e, b) - max(s, a)) for s, e, sym in tl.device if e > a and s < b]
    ours, other = kernel_table.by_kernel(rows)
    device_s = sum(t for name, t in ours.items() if kernel_table.layer_of(name) == layer)
    if layer == "output_lazy":
        device_s += sum(t for sym, t in other.items() if not kernel_table.is_copy(sym))
    bound_s = sum(w[layer].bound_s for w in _requests_work(run) if layer in w)
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s


def step_share(run, layers) -> float | None:
    """The share of the card's peak that the requests' work in `layers`
    makes of the traced window, in %: each layer's operations at its
    precision's peak, summed, over the window.  None without work."""
    tl = run.timeline
    if tl is None or tl.window_s <= 0:
        return None
    peak_s = sum(w[layer].peak_s for w in _requests_work(run) for layer in layers if layer in w)
    return 100.0 * peak_s / tl.window_s if peak_s > 0 else None
