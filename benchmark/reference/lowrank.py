"""The plain reference of the SVD-restructured net (Xue, Li, Gong,
Interspeech 2013): a float input layer, then layers each restructured as a
rank-k product, f(E (P x) + b) with the bottleneck P x linear and bias-free,
sigmoid hidden layers and a softmax output layer.

Written from the architecture's description and the quantized contract the
scored system states, in plain PyTorch; it imports nothing of the program.
It holds two forwards of the same float weights:

  * `float_posteriors`: the architecture itself in f32, TF32 off for every
    product;
  * the quantized mirror (`posteriors`, `masked_posteriors`, `hidden`,
    `logits`), which reuses reference/net.py's sigmoid table, rounding,
    quantization rule and input layer: per frame r of a low-rank layer,
    with the previous layer's sigmoid counts h (0..255),

        z_r     = f32(h_r @ P_q) * (1 / (mult_P * 255))
        s_r     = max|z_r| / 127                (an all-zero row: s_r = 0)
        q_r     = clip(round_half_away(z_r / s_r), -127, 127)   (0 where s_r = 0)
        scale_r = f32(s_r * f32(1 / mult_E))
        pre_r   = f32(f32(q_r @ E_q) * scale_r) + b

    then the sigmoid table or the softmax, every integer product exact in
    float64.  `code_bits=4` makes the codes 4-bit ([-7, 7], s_r = max / 7):
    a bottleneck one precision below the contract's, for the tests.

Both compute in blocks of BLOCK_ROWS rows.  `input_rounding="tf32"` rounds
the input layer's operands to TF32, as reference/net.py's control does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from .net import (
    ACTIVATION_SCALE,
    BLOCK_ROWS,
    WEIGHT_SCALE,
    quantized_sigmoid,
    round_half_away,
    sigmoid_table,
    softmax,
    tf32_round,
)


@dataclass(frozen=True)
class LowRankFloatNet:
    """Float weights as the benchmark draws them: the input layer f32
    [in, h0], each later layer's factors (project [a, k], expand [k, b]),
    every layer's bias, and the feature transform's shift and scale."""

    input_w: torch.Tensor
    factors: Sequence[Tuple[torch.Tensor, torch.Tensor]]
    biases: Sequence[torch.Tensor]
    shift: torch.Tensor
    scale: torch.Tensor


def quantize_factor(w: torch.Tensor, cutoff: float):
    """reference/net.py's quantization rule -> (int8 values as float64, the
    f32 multiplier)."""
    clamped = torch.clamp(w.float(), -cutoff, cutoff)
    absmax = torch.amax(torch.abs(clamped))
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    multiplier = torch.clamp(round_half_away(WEIGHT_SCALE / absmax), min=1.0)
    w_q = torch.clamp(round_half_away(clamped * multiplier), -128, 127)
    return w_q.double(), multiplier.float()


class LowRankReference:
    """The reference's own copy of the net on `device`: the folded input
    layer in f32, both factors of every later layer quantized."""

    def __init__(self, net: LowRankFloatNet, cutoff: float, device,
                 input_rounding: Optional[str] = None, code_bits: int = 8):
        if input_rounding not in (None, "tf32"):
            raise ValueError(f"input_rounding must be None or 'tf32', got {input_rounding!r}")
        if code_bits not in (8, 4):
            raise ValueError(f"code_bits must be 8 or 4, got {code_bits}")
        self.device = torch.device(device)
        self.net = net
        self.input_rounding = input_rounding
        self.code_max = 127.0 if code_bits == 8 else 7.0
        mv = lambda t: t.to(self.device, torch.float32)
        w0, b0, shift, scale = mv(net.input_w), mv(net.biases[0]), mv(net.shift), mv(net.scale)
        # the feature transform folded into the input layer, as reference/net.py folds it
        self.w0 = scale[:, None] * w0
        self.b0 = b0 + (((shift * scale)[None, :].double() @ w0.double()).float())[0]
        if input_rounding == "tf32":
            self.w0 = tf32_round(self.w0)
        self.layers = []
        for (p, e), b in zip(net.factors, net.biases[1:]):
            p_q, p_mult = quantize_factor(mv(p), cutoff)
            e_q, e_mult = quantize_factor(mv(e), cutoff)
            self.layers.append((p_q, (1.0 / (p_mult * ACTIVATION_SCALE)).float(), e_q,
                                (1.0 / e_mult).float(), mv(b)))
        self.table = sigmoid_table(self.device)
        self.input_dim = self.w0.shape[0]
        self.output_dim = self.layers[-1][2].shape[1]

    def _frames(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames.to(self.device, torch.float32)
        if x.shape[1] < self.input_dim:  # features past the net's width are zero
            x = torch.nn.functional.pad(x, (0, self.input_dim - x.shape[1]))
        return tf32_round(x) if self.input_rounding == "tf32" else x

    def _pre(self, counts: torch.Tensor, layer) -> torch.Tensor:
        """Sigmoid counts [n, a] -> the layer's pre-activations f32 [n, b]."""
        p_q, p_inv, e_q, e_inv, b = layer
        z = (counts @ p_q).float() * p_inv
        s = z.abs().amax(dim=1) / self.code_max
        live = s[:, None] > 0
        q = torch.clamp(round_half_away(z / torch.where(live, s[:, None], 1.0)),
                        -self.code_max, self.code_max)
        q = torch.where(live, q, 0.0)
        return (q.double() @ e_q).float() * (s * e_inv)[:, None] + b

    def hidden(self, frames: torch.Tensor) -> torch.Tensor:
        """Frames [n, <= input_dim] -> last hidden sigmoid counts [n, H]
        (float64 holding integers)."""
        x = self._frames(frames)
        lin = (x.double() @ self.w0.double()).float() + self.b0
        counts = quantized_sigmoid(lin, self.table)
        for layer in self.layers[:-1]:
            counts = quantized_sigmoid(self._pre(counts, layer), self.table)
        return counts

    def logits(self, counts: torch.Tensor) -> torch.Tensor:
        """Last hidden counts -> the output layer's logits, its bottleneck
        included."""
        return self._pre(counts, self.layers[-1])

    def posteriors(self, frames: torch.Tensor) -> torch.Tensor:
        """Frames -> f32 [n, senones], block by block."""
        out = []
        for i in range(0, frames.shape[0], BLOCK_ROWS):
            out.append(softmax(self.logits(self.hidden(frames[i : i + BLOCK_ROWS]))))
        return torch.cat(out)

    def masked_posteriors(self, frames: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """Frames [n, .] and masks [n, senones] (nonzero = active) -> f32
        [n, senones] under the reference's lazy semantics (an inactive
        senone keeps logit 0 and joins the denominator)."""
        out = []
        for i in range(0, frames.shape[0], BLOCK_ROWS):
            z = self.logits(self.hidden(frames[i : i + BLOCK_ROWS]))
            active = masks[i : i + BLOCK_ROWS].to(self.device) != 0
            out.append(softmax(torch.where(active, z, 0.0)))
        return torch.cat(out)

    def float_posteriors(self, frames: torch.Tensor) -> torch.Tensor:
        """The architecture in f32, unquantized: sigmoid(x W0 + b0), then
        sigmoid((h P) E + b) per layer and the softmax, with TF32 off for
        matmul and cuDNN while it runs."""
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            mv = lambda t: t.to(self.device, torch.float32)
            net = self.net
            out = []
            for i in range(0, frames.shape[0], BLOCK_ROWS):
                x = self._frames(frames[i : i + BLOCK_ROWS])
                h = torch.sigmoid(((x + mv(net.shift)) * mv(net.scale)) @ mv(net.input_w)
                                  + mv(net.biases[0]))
                for j, (p, e) in enumerate(net.factors):
                    pre = (h @ mv(p)) @ mv(e) + mv(net.biases[j + 1])
                    h = torch.sigmoid(pre) if j < len(net.factors) - 1 else pre
                out.append(torch.softmax(h, dim=1))
            return torch.cat(out)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
