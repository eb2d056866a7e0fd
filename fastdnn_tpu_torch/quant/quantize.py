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

A low-rank layer (models.feedforward.LowRank) quantizes each factor by the
same rule.  Its first product, the bottleneck z = h @ project, takes the
previous sigmoid's shifted codes as every layer does; z is signed and
unbounded, so it travels as int8 codes with a scale per frame, which keeps
each frame's posteriors independent of its batch companions.  Per frame r:

    z_r     = f32(h_r @ project_q + colsum128) * (1 / (mult_p * 255))
    s_r     = max|z_r| / 127                     (an all-zero row: s_r = 0)
    q_r     = clip(round_half_away(z_r / s_r), -127, 127)   (0 where s_r = 0)
    scale_r = f32(s_r * (1 / mult_e))
    pre_r   = f32(f32(q_r @ expand_q) * scale_r) + b

then the sigmoid table (a hidden layer) or the softmax (the output layer).
The codes have no zero point, so the expand factor's colsum128 is zero and
`inv_scales[i]` is 1 / mult_e, not 1 / (mult_e * 255).

A TDNN-F chain net (models.tdnnf.TdnnfNet) quantizes to a QuantizedTdnnf
(`quantize_tdnnf`).  Every matrix is int8 by the same per-layer rule (a
layer's two time offsets are two matrices, each with its own multiplier);
biases, batchnorms and tdnn1 stay float; each batchnorm folds to gamma and
beta (models.tdnnf.BatchNorm.fold), and prefinal-chain's second one into
its linear: L2' = f32(L2 * gamma_b) by columns, then quantized, and the
bias beta_b.  Every activation after tdnn1 is signed, so each travels as
int8 codes with a scale per row, as the bottleneck above: requant(v) gives
s = max|v| / 127 and q = clip(round_half_away(v / s), -127, 127) (0 where
s is 0), f32 ops throughout.  With a row's codes q, its scale s and a
matrix W of multiplier m, one term of a product is

    T(q, s, W) = f32(f32(q @ W) * f32(s * (1 / m)))     q @ W exact in int32

(a row outside the batch reads codes 0 and scale 0), and, per row r, with
the layer's stride in rows of its rate (r - s, r + s):

    tdnn1     v = f32(y + b1), y = f32(sum over k = 0, 1, ... of f64(x_k) *
                                   f64(W1_k)), each sum rounded in f64
                                   (bf16 operands under "default")
              h = requant(f32(f32(max(v, 0) * gamma) + beta))
    tdnnf     c = requant(f32(T(h[r - s], P_a) + T(h[r], P_b)))
              u = f32(f32(T(c[r], E_a) + T(c[r + s], E_b)) + e)
              h' = requant(f32(f32(f32(q_h[r] * s_h[r]) * 0.66) +
                               f32(f32(max(u, 0) * gamma) + beta)))
              (stride 0: c = requant(T(h[r], P)), u = f32(T(c[r], E) + e))
    prefinal  g = requant(T(h, L))
              v = requant(f32(f32(max(f32(T(g, F) + f), 0) * gamma_a) + beta_a))
              p = requant(f32(T(v, L2') + beta_b))
    output    y = f32(T(p, O) + o)

the sums in the order written.  The bypass scale 0.66 is its f32 value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import ACTIVATION_SCALE, WEIGHT_SCALE, EngineConfig
from ..models.feedforward import FeedForwardNet, LowRank, fuse_transform
from ..models.tdnnf import TdnnfNet, chunk_rows, context, drop_layer

#: int4 weight scale and code range (one code point below -scale, as int8's -128)
INT4_SCALE = 7.0
INT4_MIN, INT4_MAX = -8, 7


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _round_half_away_np(x: np.ndarray) -> np.ndarray:
    return np.sign(x) * np.floor(np.abs(x) + np.float32(0.5))


@dataclasses.dataclass(frozen=True)
class Bottleneck:
    """A low-rank layer's first product: the quantized projection int8
    [in, k] (the kernels' layout [k, in] once laid out), its colsum128 int32
    [k], and 1 / (multiplier * 255), 0-d f32 on the host."""

    weight: torch.Tensor
    colsum128: torch.Tensor
    inv_scale: torch.Tensor

    def to(self, device) -> "Bottleneck":
        return dataclasses.replace(self, weight=self.weight.to(device),
                                   colsum128=self.colsum128.to(device))


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
        (ops.kernels.input_layer_operand), set by engine.backend.KERNELS.prepare;
        None otherwise.
    bottlenecks: empty for a net of dense layers; otherwise one entry per
        quantized layer, a Bottleneck for a low-rank layer, whose weights[i]
        is then its expand factor int8 [k, out] (colsum128 zero, inv_scales
        1 / multiplier), or None for a dense one.
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
    bottlenecks: Tuple[Optional[Bottleneck], ...] = ()

    @property
    def input_dim(self) -> int:
        return self.input_w.shape[0]

    @property
    def output_dim(self) -> int:
        """True senone count (excludes padding columns)."""
        if self.true_output_dim is not None:
            return self.true_output_dim
        return self.padded_output_dim

    # the widths below read the biases, which every layout and packing of
    # the weights leaves as they are

    @property
    def padded_output_dim(self) -> int:
        return self.biases[-1].shape[0]

    @property
    def layer_count(self) -> int:
        """Total layer count including the input layer."""
        return len(self.weights) + 1

    def layer_dims(self):
        return [self.input_b.shape[0]] + [b.shape[0] for b in self.biases]

    def bottleneck(self, i: int) -> Optional[Bottleneck]:
        """Quantized layer i's first product when it is low-rank, else None."""
        return self.bottlenecks[i] if self.bottlenecks else None

    @property
    def has_lowrank(self) -> bool:
        return any(b is not None for b in self.bottlenecks)

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
            bottlenecks=tuple(None if b is None else b.to(device) for b in self.bottlenecks),
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
    posteriors.  A low-rank layer (LowRank) quantizes both factors at int8
    (the module's docstring has its contract); it has no int4 form.  A
    TDNN-F net (models.tdnnf.TdnnfNet) gives a QuantizedTdnnf
    (quantize_tdnnf); it has no int4 form either."""
    if cutoff <= 0:
        raise ValueError(f"weight cutoff must be positive, got {cutoff}")
    if isinstance(net, TdnnfNet):
        if hidden_bits != 8:
            raise ValueError("a TDNN-F net has no int4 form: quantize it at hidden_bits=8")
        return quantize_tdnnf(net, cutoff)
    if net.layer_count < 2:
        raise ValueError("need at least an input layer and an output layer")
    if hidden_bits not in (8, 4):
        raise ValueError(f"hidden_bits must be 8 or 4, got {hidden_bits}")
    lowrank = any(isinstance(w, LowRank) for w in net.weights[1:])
    if lowrank and hidden_bits != 8:
        raise ValueError("a low-rank layer has no int4 form: quantize a net with low-rank "
                         "layers at hidden_bits=8")
    if fuse_input_transform:
        net = fuse_transform(net)
    weights, colsums, biases, inv_scales, multipliers, bottlenecks = [], [], [], [], [], []
    n_quant = net.layer_count - 1
    for i, (w, b) in enumerate(zip(net.weights[1:], net.biases[1:])):
        bits = hidden_bits if i < n_quant - 1 else 8
        if isinstance(w, LowRank):
            p_q, p_mult = quantize_layer(w.project, cutoff)
            bottlenecks.append(Bottleneck(p_q, _colsum128(p_q),
                                          (1.0 / (p_mult * ACTIVATION_SCALE)).to(torch.float32)))
            w_q, mult = quantize_layer(w.expand, cutoff)
            colsums.append(torch.zeros(w_q.shape[1], dtype=torch.int32))
            inv_scales.append((1.0 / mult).to(torch.float32))
        else:
            bottlenecks.append(None)
            w_q, mult = quantize_layer(w, cutoff, bits=bits)
            colsums.append(_colsum128(w_q))
            inv_scales.append((1.0 / (mult * ACTIVATION_SCALE)).to(torch.float32))
        weights.append(w_q)
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
        bottlenecks=tuple(bottlenecks) if lowrank else (),
    )


@dataclasses.dataclass(frozen=True)
class Matrix:
    """An int8 matrix [in, out] (the kernels' layout [out, in] once laid
    out) and 1 / its multiplier, 0-d f32 on the host."""

    weight: torch.Tensor
    inv_scale: torch.Tensor

    def to(self, device) -> "Matrix":
        return dataclasses.replace(self, weight=self.weight.to(device))


def _matrix(w: torch.Tensor, cutoff: float) -> Matrix:
    w_q, mult = quantize_layer(w, cutoff)
    return Matrix(w_q, (1.0 / mult).to(torch.float32))


@dataclasses.dataclass(frozen=True)
class QuantizedTdnnfLayer:
    """One factorized layer: `linear` P per time offset (read at r - s, then
    r), `affine` E per offset (r, then r + s), each a Matrix; the affine's
    bias and the folded batchnorm, f32 [out]."""

    stride: int
    linear: Tuple[Matrix, ...]
    affine: Tuple[Matrix, ...]
    bias: torch.Tensor
    gamma: torch.Tensor
    beta: torch.Tensor

    def to(self, device) -> "QuantizedTdnnfLayer":
        mv = lambda ms: tuple(m.to(device) for m in ms)
        return dataclasses.replace(self, linear=mv(self.linear), affine=mv(self.affine),
                                   bias=self.bias.to(device), gamma=self.gamma.to(device),
                                   beta=self.beta.to(device))


@dataclasses.dataclass(frozen=True)
class QuantizedTdnnf:
    """A quantized TDNN-F chain net (the contract in the module docstring).

    input_w/input_b, input_gamma/input_beta: tdnn1 in float, its batchnorm
        folded
    layers: QuantizedTdnnfLayer per factorized layer
    prefinal_l: Matrix (no bias); prefinal_w, prefinal_b, prefinal_gamma,
        prefinal_beta: prefinal-chain's affine and first batchnorm;
        prefinal_small (L2', its batchnorm folded in) and prefinal_small_b
    output: Matrix, output_b: the chain output's bias f32 [N]
    bypass_scale: 0-d f32; subsampling: the frame-subsampling factor
    """

    input_w: torch.Tensor
    input_b: torch.Tensor
    input_gamma: torch.Tensor
    input_beta: torch.Tensor
    layers: Tuple[QuantizedTdnnfLayer, ...]
    prefinal_l: Matrix
    prefinal_w: Matrix
    prefinal_b: torch.Tensor
    prefinal_gamma: torch.Tensor
    prefinal_beta: torch.Tensor
    prefinal_small: Matrix
    prefinal_small_b: torch.Tensor
    output: Matrix
    output_b: torch.Tensor
    bypass_scale: torch.Tensor
    subsampling: int

    @property
    def input_dim(self) -> int:
        return self.input_w.shape[0]

    @property
    def output_dim(self) -> int:
        return self.output_b.shape[0]

    @property
    def strides(self) -> Tuple[int, ...]:
        return tuple(layer.stride for layer in self.layers)

    def context(self) -> Tuple[int, int]:
        """(left, right) rows of context (models.tdnnf.context)."""
        return context(self.strides)

    def plan(self, chunk_frames: int) -> dict:
        """models.tdnnf.chunk_rows for a chunk of this net, with the index
        of the layer that reads every `subsampling`-th row ("drop")."""
        return dict(chunk_rows(chunk_frames, self.strides, self.subsampling),
                    drop=drop_layer(self.strides, self.subsampling))

    def to(self, device) -> "QuantizedTdnnf":
        t = lambda x: x.to(device)
        return dataclasses.replace(
            self, input_w=t(self.input_w), input_b=t(self.input_b),
            input_gamma=t(self.input_gamma), input_beta=t(self.input_beta),
            layers=tuple(layer.to(device) for layer in self.layers),
            prefinal_l=self.prefinal_l.to(device), prefinal_w=self.prefinal_w.to(device),
            prefinal_b=t(self.prefinal_b), prefinal_gamma=t(self.prefinal_gamma),
            prefinal_beta=t(self.prefinal_beta), prefinal_small=self.prefinal_small.to(device),
            prefinal_small_b=t(self.prefinal_small_b), output=self.output.to(device),
            output_b=t(self.output_b))


def quantize_tdnnf(net: TdnnfNet, cutoff: float = EngineConfig.cutoff) -> QuantizedTdnnf:
    """TdnnfNet -> QuantizedTdnnf: every matrix int8 at `cutoff` (the
    per-layer rule of quantize_layer), each batchnorm folded, prefinal-chain's
    second one into its linear (module docstring)."""
    if cutoff <= 0:
        raise ValueError(f"weight cutoff must be positive, got {cutoff}")
    f32 = lambda t: t.to(torch.float32)
    layers = []
    for layer in net.layers:
        gamma, beta = layer.bn.fold()
        layers.append(QuantizedTdnnfLayer(
            layer.stride, tuple(_matrix(w, cutoff) for w in layer.linear),
            tuple(_matrix(w, cutoff) for w in layer.affine), f32(layer.bias), gamma, beta))
    in_gamma, in_beta = net.input_bn.fold()
    pre_gamma, pre_beta = net.prefinal_bn.fold()
    small_gamma, small_beta = net.prefinal_small_bn.fold()
    return QuantizedTdnnf(
        f32(net.input_w), f32(net.input_b), in_gamma, in_beta, tuple(layers),
        _matrix(net.prefinal_l, cutoff), _matrix(net.prefinal_w, cutoff), f32(net.prefinal_b),
        pre_gamma, pre_beta, _matrix(f32(net.prefinal_small) * small_gamma, cutoff), small_beta,
        _matrix(net.output_w, cutoff), f32(net.output_b),
        torch.tensor(net.bypass_scale, dtype=torch.float32), net.subsampling)


def _colsum128(w_q: torch.Tensor) -> torch.Tensor:
    return 128 * torch.sum(w_q.to(torch.int32), dim=0, dtype=torch.int32)


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
    softmax (capped at -1e30) and sliced away.  A low-rank layer's rank
    pads the same way: a padded bottleneck column is 0 in every frame, so its
    code is 0 and its expand row zero.  A packed net is refused: pad first,
    then pack (pack_int4_trunk).
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
    bottlenecks = tuple(
        None if bn is None else dataclasses.replace(
            bn, weight=_pad2(bn.weight, up(bn.weight.shape[0], lanes), up(bn.weight.shape[1], lanes)),
            colsum128=torch.nn.functional.pad(
                bn.colsum128, (0, up(bn.weight.shape[1], lanes) - bn.colsum128.shape[0])))
        for bn in qnet.bottlenecks)
    return dataclasses.replace(
        qnet,
        bottlenecks=bottlenecks,
        input_w=_pad2(qnet.input_w, qnet.input_w.shape[0], h0),
        input_b=torch.nn.functional.pad(qnet.input_b, (0, h0 - qnet.input_b.shape[0])),
        weights=tuple(weights),
        colsum128=tuple(colsums),
        biases=tuple(biases),
        true_output_dim=qnet.output_dim,
    )
