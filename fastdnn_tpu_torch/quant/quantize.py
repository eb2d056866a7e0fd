"""Per-layer symmetric int8 weight quantization -> QuantizedNet.

The scheme of fastdnn_tpu/quant/quantize.py (the reference's
QuantizedSimdLayer), computed with the same f32 elementwise ops, so both
packages produce identical weights, colsum128, inverse scales and
multipliers from identical float weights:
  * clamp weights to [-cutoff, +cutoff]
  * layer multiplier = max(round(127 / absmax(clamped)), 1)
  * w_q = clip(round(w_clamped * multiplier), -128, 127) as int8
  * biases and the input layer stay float
  * dequantization divides by (multiplier * 255)

For every quantized layer `colsum128 = 128 * sum_k(w_q[k, n])` (int32) lets
uint8 activations ride an s8 x s8 product:

    sum_k a_u8[k] * w[k, n] = sum_k (a_u8[k] - 128) * w[k, n] + colsum128[n]

Only the int8 trunk is ported; the int4 trunk waits for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import ACTIVATION_SCALE, WEIGHT_SCALE, EngineConfig
from ..models.feedforward import FeedForwardNet, fuse_transform


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


@dataclasses.dataclass(frozen=True)
class QuantizedNet:
    """Quantized network.

    input_w/input_b: float first layer (f32 [in, h0], [h0]) with the feature
        transform fused in.
    weights[i]: int8 [in_i, out_i] for hidden layers 1..n-1 and the output
        layer (the last entry).
    colsum128[i]: int32 [out_i] zero-point correction.
    biases[i]: f32 [out_i].
    inv_scales[i]: 0-d f32, 1 / (multiplier_i * 255).
    multipliers[i]: 0-d f32, kept for introspection and tests.
    true_output_dim: the real senone count when the output width carries
        padding columns (set by pad_qnet; None = the width is the count).
    """

    input_w: torch.Tensor
    input_b: torch.Tensor
    weights: Tuple[torch.Tensor, ...]
    colsum128: Tuple[torch.Tensor, ...]
    biases: Tuple[torch.Tensor, ...]
    inv_scales: Tuple[torch.Tensor, ...]
    multipliers: Tuple[torch.Tensor, ...]
    true_output_dim: Optional[int] = None

    @property
    def input_dim(self) -> int:
        return self.input_w.shape[0]

    @property
    def output_dim(self) -> int:
        """True senone count (excludes padding columns)."""
        if self.true_output_dim is not None:
            return self.true_output_dim
        return self.weights[-1].shape[1]

    @property
    def padded_output_dim(self) -> int:
        return self.weights[-1].shape[1]

    @property
    def layer_count(self) -> int:
        """Total layer count including the input layer."""
        return len(self.weights) + 1

    def layer_dims(self):
        return [self.input_w.shape[1]] + [w.shape[1] for w in self.weights]

    def to(self, device) -> "QuantizedNet":
        """The same net with its arrays on `device`.  The 0-d scales and
        multipliers stay on the host: kernels take them by value, and a
        plain op on the device combines with a 0-d host tensor as with a
        scalar, so reading one never waits on the device."""

        def mv(ts):
            return tuple(t.to(device) for t in ts)

        return dataclasses.replace(
            self,
            input_w=self.input_w.to(device),
            input_b=self.input_b.to(device),
            weights=mv(self.weights),
            colsum128=mv(self.colsum128),
            biases=mv(self.biases),
        )


def quantize_layer(w: torch.Tensor, cutoff: float, bits: int = 8):
    """Quantize one layer's [in, out] float weights -> (w_q int8, 0-d f32
    multiplier)."""
    if bits != 8:
        raise ValueError(f"only the int8 trunk is ported, got bits={bits}")
    clamped = torch.clamp(w.to(torch.float32), -cutoff, cutoff)
    absmax = torch.amax(torch.abs(clamped))
    # an all-zero layer is exactly representable by any multiplier
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    # floor at 1: a huge cutoff must not round the multiplier to 0
    multiplier = torch.clamp(_round_half_away(WEIGHT_SCALE / absmax), min=1.0)
    w_q = torch.clamp(_round_half_away(clamped * multiplier), -128, 127)
    return w_q.to(torch.int8), multiplier.to(torch.float32)


def quantize_net(
    net: FeedForwardNet,
    cutoff: float = EngineConfig.cutoff,
    *,
    fuse_input_transform: bool = True,
    hidden_bits: int = 8,
) -> QuantizedNet:
    """FeedForwardNet -> QuantizedNet.  The input layer stays float; its
    shift/scale are fused into it unless the net is already fused."""
    if cutoff <= 0:
        raise ValueError(f"weight cutoff must be positive, got {cutoff}")
    if net.layer_count < 2:
        raise ValueError("need at least an input layer and an output layer")
    if hidden_bits != 8:
        raise ValueError(f"only the int8 trunk is ported, got hidden_bits={hidden_bits}")
    if fuse_input_transform:
        net = fuse_transform(net)
    weights, colsums, biases, inv_scales, multipliers = [], [], [], [], []
    for w, b in zip(net.weights[1:], net.biases[1:]):
        w_q, mult = quantize_layer(w, cutoff)
        weights.append(w_q)
        colsums.append(128 * torch.sum(w_q.to(torch.int32), dim=0, dtype=torch.int32))
        inv_scales.append((1.0 / (mult * ACTIVATION_SCALE)).to(torch.float32))
        biases.append(b.to(torch.float32))
        multipliers.append(mult)
    return QuantizedNet(
        input_w=net.weights[0].to(torch.float32),
        input_b=net.biases[0].to(torch.float32),
        weights=tuple(weights),
        colsum128=tuple(colsums),
        biases=tuple(biases),
        inv_scales=tuple(inv_scales),
        multipliers=tuple(multipliers),
    )


def _pad2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def pad_qnet(qnet: QuantizedNet, lanes: int = 128, out_lanes: int = 128) -> QuantizedNet:
    """Zero-pad every node dimension up to a multiple of `lanes`, and the
    output layer's node dimension to a multiple of `out_lanes`, so the CUDA
    kernels' tiles divide every shape (ops.kernels.TILE_N is 128; it is also
    a multiple of their K stage, TILE_K).

    Padding is inert end to end: padded weight columns carry zero weights
    and zero bias, so a padded hidden unit sees a linear value of exactly 0,
    which quantizes to sigmoid(0) = 128, shifted int8 0, and its outgoing
    weight rows are zero anyway; padded output logits are excluded from the
    softmax (capped at -1e30) and sliced away.
    """

    def up(n: int, m: int) -> int:
        return -(-n // m) * m

    last = len(qnet.weights) - 1
    h0 = up(qnet.input_w.shape[1], lanes)
    weights, colsums, biases = [], [], []
    for i, (w, cs, b) in enumerate(zip(qnet.weights, qnet.colsum128, qnet.biases)):
        k = up(w.shape[0], lanes)
        n = up(w.shape[1], out_lanes if i == last else lanes)
        weights.append(_pad2(w, k, n))
        colsums.append(torch.nn.functional.pad(cs, (0, n - cs.shape[0])))
        biases.append(torch.nn.functional.pad(b, (0, n - b.shape[0])))
    return QuantizedNet(
        input_w=_pad2(qnet.input_w, qnet.input_w.shape[0], h0),
        input_b=torch.nn.functional.pad(qnet.input_b, (0, h0 - qnet.input_b.shape[0])),
        weights=tuple(weights),
        colsum128=tuple(colsums),
        biases=tuple(biases),
        inv_scales=qnet.inv_scales,
        multipliers=qnet.multipliers,
        true_output_dim=qnet.output_dim,
    )
