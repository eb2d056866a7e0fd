"""Per-layer symmetric weight quantization -> QuantizedNet.

The scheme of fastdnn_tpu/quant/quantize.py (the reference's
QuantizedSimdLayer), computed with the same f32 elementwise ops, so both
packages produce identical weights, colsum128, inverse scales and
multipliers from identical float weights:
  * clamp weights to [-cutoff, +cutoff]
  * layer multiplier = max(round(scale / absmax(clamped)), 1), scale 127
    for int8 layers and 7 for the int4 hidden trunk (`hidden_bits=4`)
  * w_q = clip(round(w_clamped * multiplier)) to [-128, 127] or [-8, 7]
  * biases and the input layer stay float; the output layer is always int8
  * dequantization divides by (multiplier * 255)

int4 values ride as int8 tensors (the port has no 4-bit dtype);
`QuantizedNet.hidden_bits` records that the hidden layers hold them, and
`pack_int4_trunk` stores them two nibbles per byte (`packed_int4`).

For every quantized layer `colsum128 = 128 * sum_k(w_q[k, n])` (int32) lets
uint8 activations ride an s8 x s8 product:

    sum_k a_u8[k] * w[k, n] = sum_k (a_u8[k] - 128) * w[k, n] + colsum128[n]
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import ACTIVATION_SCALE, WEIGHT_SCALE, EngineConfig
from ..models.feedforward import FeedForwardNet, fuse_transform

#: int4 weight scale and code range (one code point below -scale, as int8's -128)
INT4_SCALE = 7.0
INT4_MIN, INT4_MAX = -8, 7


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _round_half_away_np(x: np.ndarray) -> np.ndarray:
    return np.sign(x) * np.floor(np.abs(x) + np.float32(0.5))


@dataclasses.dataclass(frozen=True)
class QuantizedNet:
    """Quantized network.

    input_w/input_b: float first layer (f32 [in, h0], [h0]) with the feature
        transform fused in.
    weights[i]: int8 [in_i, out_i] for hidden layers 1..n-1 and the output
        layer (the last entry); with packed_int4 the hidden entries are
        [in_i / 2, out_i] (pack_int4_trunk).
    colsum128[i]: int32 [out_i] zero-point correction.
    biases[i]: f32 [out_i].
    inv_scales[i]: 0-d f32, 1 / (multiplier_i * 255).
    multipliers[i]: 0-d f32, kept for introspection and tests.
    true_output_dim: the real senone count when the output width carries
        padding columns (set by pad_qnet; None = the width is the count).
    hidden_bits: 8, or 4 when the hidden layers (weights[:-1]) hold int4
        values in [-8, 7]; the output layer is int8 either way.
    packed_int4: the int4 hidden weights are stored two nibbles per byte.
    input_operand: the input weight as the input-layer kernel reads it
        (ops.kernels.input_layer_operand), set by engine.cuda_backend.prepare;
        None otherwise.
    """

    input_w: torch.Tensor
    input_b: torch.Tensor
    weights: Tuple[torch.Tensor, ...]
    colsum128: Tuple[torch.Tensor, ...]
    biases: Tuple[torch.Tensor, ...]
    inv_scales: Tuple[torch.Tensor, ...]
    multipliers: Tuple[torch.Tensor, ...]
    true_output_dim: Optional[int] = None
    hidden_bits: int = 8
    packed_int4: bool = False
    input_operand: Optional[torch.Tensor] = None

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
            input_operand=None if self.input_operand is None else self.input_operand.to(device),
        )


def quantize_layer(w: torch.Tensor, cutoff: float, bits: int = 8):
    """Quantize one layer's [in, out] float weights -> (w_q int8, 0-d f32
    multiplier).  bits=4 gives values in [-8, 7], still as int8, computed
    with the numpy f32 ops of the JAX package's int4 branch."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if bits == 4:
        clamped = np.clip(
            np.asarray(w, np.float32), np.float32(-cutoff), np.float32(cutoff)
        )
        absmax = np.float32(np.max(np.abs(clamped)))
        if absmax == 0:  # same guards as the int8 branch
            absmax = np.float32(1.0)
        multiplier = np.maximum(
            _round_half_away_np(np.float32(INT4_SCALE) / absmax), np.float32(1.0)
        )
        w_q = np.clip(_round_half_away_np(clamped * multiplier), INT4_MIN, INT4_MAX)
        return torch.from_numpy(w_q.astype(np.int8)), torch.tensor(np.float32(multiplier))
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
    shift/scale are fused into it unless the net is already fused.

    hidden_bits=4 stores the hidden trunk as int4 (scale 7); the output
    layer stays int8, because 4-bit logit steps would visibly move the
    posteriors."""
    if cutoff <= 0:
        raise ValueError(f"weight cutoff must be positive, got {cutoff}")
    if net.layer_count < 2:
        raise ValueError("need at least an input layer and an output layer")
    if hidden_bits not in (8, 4):
        raise ValueError(f"hidden_bits must be 8 or 4, got {hidden_bits}")
    if fuse_input_transform:
        net = fuse_transform(net)
    weights, colsums, biases, inv_scales, multipliers = [], [], [], [], []
    n_quant = net.layer_count - 1
    for i, (w, b) in enumerate(zip(net.weights[1:], net.biases[1:])):
        bits = hidden_bits if i < n_quant - 1 else 8
        w_q, mult = quantize_layer(w, cutoff, bits=bits)
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
        hidden_bits=hidden_bits,
    )


def pack_int4_trunk(qnet: QuantizedNet) -> QuantizedNet:
    """Store the int4 hidden weights two nibbles per byte, int8 [K/2, N]:
    the low nibble of row k is weight row k, the high nibble weight row
    K/2 + k, so a consumer runs two s8 products over the activation halves

        acc = x[:, :K/2] @ lo + x[:, K/2:] @ hi

    (ops.matmul.hidden_layer_step_packed), with half the weight bytes.
    Apply after pad_qnet (the Scorer does, under EngineConfig.int4_packed):
    padding a packed matrix would split the halves at the wrong K.  The
    output layer (int8) is untouched; an int8 net passes through unchanged.
    """
    if qnet.packed_int4 or qnet.hidden_bits != 4 or len(qnet.weights) < 2:
        return qnet
    weights = []
    for w in qnet.weights[:-1]:
        k = w.shape[0]
        if k % 2:
            raise ValueError(f"packed int4 needs an even K, got {k}")
        lo, hi = w[: k // 2].to(torch.int32), w[k // 2 :].to(torch.int32)
        # hi * 16 has a zero low nibble, so the sum is (hi << 4) | (lo & 0xF)
        weights.append((hi * 16 + (lo & 0xF)).to(torch.int8).contiguous())
    return dataclasses.replace(
        qnet, weights=tuple(weights) + (qnet.weights[-1],), packed_int4=True
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
    softmax (capped at -1e30) and sliced away.  A packed net is refused:
    pad first, then pack (pack_int4_trunk).
    """
    if qnet.packed_int4:
        raise ValueError(
            "pad before packing: zero-padding a packed-nibble weight matrix "
            "would split the low/high halves at the wrong K (the Scorer "
            "applies pack_int4_trunk after pad_qnet)"
        )

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
    return dataclasses.replace(
        qnet,
        input_w=_pad2(qnet.input_w, qnet.input_w.shape[0], h0),
        input_b=torch.nn.functional.pad(qnet.input_b, (0, h0 - qnet.input_b.shape[0])),
        weights=tuple(weights),
        colsum128=tuple(colsums),
        biases=tuple(biases),
        true_output_dim=qnet.output_dim,
    )
