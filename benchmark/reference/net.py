"""The plain reference of the scored net: a Kaldi nnet1 feed-forward net
with a float input layer, int8 sigmoid hidden layers and an int8 softmax
output layer, quantized as fast-dnn quantizes it.

It is written from the reference engine's description, in plain PyTorch,
and imports nothing of the program.  It takes the float weights that the
benchmark drew and works out everything else itself:

  * the feature transform `(x + shift) * scale`, folded into the input
    layer: w0' = scale[:, None] * w0, b0' = b0 + (shift * scale) @ w0;
  * per-layer quantization: clamp |w| to the cutoff, multiplier =
    max(round(127 / absmax), 1), w_q = clip(round(w * multiplier)),
    rounding half away from zero, all in f32;
  * the quantized sigmoid through the reference's 1280-entry table at 0.01
    input resolution, built in float64 as its C++ constructor builds it;
  * every integer product exactly, in float64 (|sum| < 2**53), then
    `f32(sum) * (1 / (multiplier * 255)) + bias`, each op rounded on its own;
  * the softmax over the true senones, and the lazy softmax with the
    reference's semantics: an inactive senone keeps logit 0 and still adds
    exp(0 - max) to the denominator.

The input layer's product is taken in float64 and rounded once to f32,
which no TF32 switch reaches.  `input_rounding="tf32"` rounds both of its
operands to TF32 first: the reference one precision below the configured
one, the control that the comparison has to fail.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

WEIGHT_SCALE = 127.0
ACTIVATION_SCALE = 255.0
LUT_HALF = 640  # the table covers k = round(x * 100) in [-640, 640)
#: rows per block of the reference's products, so that it fits beside the
#: answers it judges
BLOCK_ROWS = 8192


@dataclass(frozen=True)
class FloatNet:
    """Float weights as the benchmark draws them: weights[i] f32 [in, out],
    biases[i] f32 [out], and the feature transform's shift and scale."""

    weights: Sequence[torch.Tensor]
    biases: Sequence[torch.Tensor]
    shift: torch.Tensor
    scale: torch.Tensor


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def sigmoid_table(device) -> torch.Tensor:
    """The reference's table: entry k + 640 = round(sigmoid(k / 100) * 255)
    for k in [-640, 640), in float64."""
    k = torch.arange(-LUT_HALF, LUT_HALF, dtype=torch.float64, device=device) / 100.0
    return torch.floor(torch.sigmoid(k) * ACTIVATION_SCALE + 0.5)


def quantized_sigmoid(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """f32 -> sigmoid counts in [0, 255] (as float64): k = round(x * 100)
    half away from zero, 0 at or below -640, 255 at or above 640, else the
    table."""
    k = round_half_away(x * 100.0)
    mid = table[(k.clamp(-LUT_HALF, LUT_HALF - 1) + LUT_HALF).long()]
    return torch.where(k >= LUT_HALF, ACTIVATION_SCALE, torch.where(k <= -LUT_HALF, 0.0, mid))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def quantize(w: torch.Tensor, cutoff: float):
    """f32 [in, out] -> (int8 values as float64, f32 1 / (multiplier * 255))."""
    clamped = torch.clamp(w.float(), -cutoff, cutoff)
    absmax = torch.amax(torch.abs(clamped))
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    multiplier = torch.clamp(round_half_away(WEIGHT_SCALE / absmax), min=1.0)
    w_q = torch.clamp(round_half_away(clamped * multiplier), -128, 127)
    inv_scale = (1.0 / (multiplier * ACTIVATION_SCALE)).float()
    return w_q.double(), inv_scale


class ReferenceNet:
    """The reference's own copy of the net on `device`, made from the float
    weights: the folded input layer in f32, every other layer quantized."""

    def __init__(self, net: FloatNet, cutoff: float, device, input_rounding: Optional[str] = None):
        if input_rounding not in (None, "tf32"):
            raise ValueError(f"input_rounding must be None or 'tf32', got {input_rounding!r}")
        self.device = torch.device(device)
        mv = lambda t: t.to(self.device, torch.float32)
        w0, b0, shift, scale = mv(net.weights[0]), mv(net.biases[0]), mv(net.shift), mv(net.scale)
        self.w0 = scale[:, None] * w0
        self.b0 = b0 + (((shift * scale)[None, :].double() @ w0.double()).float())[0]
        if input_rounding == "tf32":
            self.w0 = tf32_round(self.w0)
        self.input_rounding = input_rounding
        self.layers = []
        for w, b in zip(net.weights[1:], net.biases[1:]):
            w_q, inv_scale = quantize(mv(w), cutoff)
            self.layers.append((w_q, inv_scale, mv(b)))
        self.table = sigmoid_table(self.device)
        self.input_dim = self.w0.shape[0]
        self.output_dim = self.layers[-1][0].shape[1]

    def _frames(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames.to(self.device, torch.float32)
        if x.shape[1] < self.input_dim:  # features past the net's width are zero
            x = torch.nn.functional.pad(x, (0, self.input_dim - x.shape[1]))
        return tf32_round(x) if self.input_rounding == "tf32" else x

    def _dequantize(self, counts: torch.Tensor, layer) -> torch.Tensor:
        w_q, inv_scale, b = layer
        return (counts @ w_q).float() * inv_scale + b

    def hidden(self, frames: torch.Tensor) -> torch.Tensor:
        """Frames [n, <= input_dim] -> last hidden sigmoid counts [n, H]
        (float64 holding integers)."""
        x = self._frames(frames)
        lin = (x.double() @ self.w0.double()).float() + self.b0
        counts = quantized_sigmoid(lin, self.table)
        for layer in self.layers[:-1]:
            counts = quantized_sigmoid(self._dequantize(counts, layer), self.table)
        return counts

    def logits(self, counts: torch.Tensor) -> torch.Tensor:
        return self._dequantize(counts, self.layers[-1])

    def posteriors(self, frames: torch.Tensor) -> torch.Tensor:
        """Frames -> f32 [n, senones], block by block."""
        out = []
        for i in range(0, frames.shape[0], BLOCK_ROWS):
            out.append(softmax(self.logits(self.hidden(frames[i : i + BLOCK_ROWS]))))
        return torch.cat(out)

    def masked_posteriors(self, frames: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """Frames [n, .] and masks [n, senones] (nonzero = active) -> f32
        [n, senones] under the reference's lazy semantics."""
        out = []
        for i in range(0, frames.shape[0], BLOCK_ROWS):
            z = self.logits(self.hidden(frames[i : i + BLOCK_ROWS]))
            active = masks[i : i + BLOCK_ROWS].to(self.device) != 0
            out.append(softmax(torch.where(active, z, 0.0)))
        return torch.cat(out)


def softmax(z: torch.Tensor) -> torch.Tensor:
    """Row softmax in f32, the stable form."""
    e = torch.exp(z - z.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)
