"""Kaldi's factorized TDNN (TDNN-F) chain acoustic model, held in PyTorch tensors.

The net of Povey et al., "Semi-Orthogonal Low-Rank Matrix Factorization for
Deep Neural Networks" (Interspeech 2018), as Kaldi's LibriSpeech recipe
`run_tdnn_1d.sh` builds it.  Unlike the feed-forward nets of
models/feedforward.py its layers look across time, so a frame is not scored
alone: a chunk of frames is, with the context its outputs need on either
side.  At inference (dropout the identity) with BN(v) = (v - mean) * gamma,
gamma = 1 / sqrt(var + 1e-3) (Kaldi's BatchNormComponent at target-rms 1):

    tdnn1      h_t  = BN(ReLU(x_t W1 + b1))                x_t the spliced row
    tdnnf_i    c_t  = h_{t-s} P_a + h_t P_b                 linear, no bias
               u_t  = c_t E_a + c_{t+s} E_b + e
               h'_t = bypass * h_t + BN(ReLU(u_t))          bypass 0.66
               (stride s = 0: c_t = h_t P, u_t = c_t E + e)
    prefinal   g_t  = h_t L                                 linear, no bias
               p_t  = BN_b(BN_a(ReLU(g_t F + f)) L2)
    output     y_t  = p_t O + o                             no softmax

Weights are stored [in, out], as the feed-forward net's are.  Each input
row x_t is already spliced ([m_{t-1}, m_t, m_{t+1}, ivector]) and the LDA
affine is folded into W1, so the net's own context is the layers' strides:
left and right `context()` rows (39 each for run_tdnn_1d's strides; Kaldi's
compiler counts 40 frames of MFCCs, the splice's one being inside each
row).  Outputs exist at every `subsampling`-th frame only (t = 0, 3, ...):
from the first layer whose stride and every later one's are multiples of
it, only every third row is needed.  `forward` computes a batch of chunks
[C, L + T + R, in] -> [C, T / subsampling, out] in float.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

#: Kaldi's BatchNormComponent epsilon
BN_EPSILON = 1e-3
#: run_tdnn_1d.sh's bypass-scale and frame-subsampling-factor
BYPASS_SCALE = 0.66
SUBSAMPLING = 3
#: run_tdnn_1d.sh's time strides of tdnnf2 .. tdnnf17
LIBRISPEECH_STRIDES = (1, 1, 1, 0) + (3,) * 12


@dataclasses.dataclass(frozen=True)
class BatchNorm:
    """A BatchNormComponent's stored statistics, f32 [dim]."""

    mean: torch.Tensor
    var: torch.Tensor

    def fold(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(gamma, beta), f32 [dim], with BN(v) = v * gamma + beta:
        gamma = f32(1 / sqrt(var + 1e-3)) and beta = f32(-mean * gamma),
        each computed in float64 and rounded once (gamma's f32 value taken
        for beta)."""
        gamma = (1.0 / torch.sqrt(self.var.double() + BN_EPSILON)).float()
        beta = (-(self.mean.double() * gamma.double())).float()
        return gamma, beta

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.fold()
        return v * gamma + beta


@dataclasses.dataclass(frozen=True)
class TdnnfLayer:
    """One factorized layer: `linear` holds P per time offset (P_a read at
    t - stride, then P_b at t; P alone at stride 0), [in, k] each, and
    `affine` E per offset (E_a at t, then E_b at t + stride), [k, out]
    each, with the affine's bias and the layer's batchnorm."""

    stride: int
    linear: Tuple[torch.Tensor, ...]
    affine: Tuple[torch.Tensor, ...]
    bias: torch.Tensor
    bn: BatchNorm

    @property
    def bottleneck(self) -> int:
        return self.linear[0].shape[1]


@dataclasses.dataclass(frozen=True)
class TdnnfNet:
    """Float TDNN-F chain net (module docstring).

    input_w/input_b: tdnn1, f32 [in, H] and [H], the LDA folded in
    input_bn: tdnn1's batchnorm
    layers: the TdnnfLayers tdnnf2 .. in order
    prefinal_l: prefinal-l's linear f32 [H, P]
    prefinal_w/prefinal_b: prefinal-chain's affine f32 [P, H], [H]
    prefinal_bn: its first batchnorm (BN_a)
    prefinal_small: its linear f32 [H, P]
    prefinal_small_bn: its second batchnorm (BN_b)
    output_w/output_b: the chain output f32 [P, N], [N]
    """

    input_w: torch.Tensor
    input_b: torch.Tensor
    input_bn: BatchNorm
    layers: Tuple[TdnnfLayer, ...]
    prefinal_l: torch.Tensor
    prefinal_w: torch.Tensor
    prefinal_b: torch.Tensor
    prefinal_bn: BatchNorm
    prefinal_small: torch.Tensor
    prefinal_small_bn: BatchNorm
    output_w: torch.Tensor
    output_b: torch.Tensor
    bypass_scale: float = BYPASS_SCALE
    subsampling: int = SUBSAMPLING

    @property
    def input_dim(self) -> int:
        return self.input_w.shape[0]

    @property
    def output_dim(self) -> int:
        return self.output_w.shape[1]

    @property
    def strides(self) -> Tuple[int, ...]:
        return tuple(layer.stride for layer in self.layers)

    def context(self) -> Tuple[int, int]:
        """(left, right) rows of context an output row needs: each layer
        reads `stride` rows back (its linear) and `stride` ahead (its
        affine)."""
        return context(self.strides)


def context(strides: Sequence[int]) -> Tuple[int, int]:
    """(left, right) context in rows of a TDNN-F stack of these strides."""
    total = sum(strides)
    return total, total


def drop_layer(strides: Sequence[int], subsampling: int) -> int:
    """The index of the layer that reads every `subsampling`-th row: the
    first from which its stride and every later one's are multiples of the
    factor (run_tdnn_1d's stride-0 tdnnf5, index 3)."""
    for i in range(len(strides)):
        if all(s % subsampling == 0 for s in strides[i:]):
            return i
    return len(strides)


def chunk_rows(chunk_frames: int, strides: Sequence[int], subsampling: int) -> dict:
    """The rows of one chunk of `chunk_frames` output-covered frames at each
    rate: `rows` = L + T + R input rows; past the rate drop the rows
    `first`, first + subsampling, ... of the chunk (`rows_low` of them);
    the outputs are rows [out_first, out_first + T / subsampling) of those.
    T must be a multiple of the factor and L + T + R of it too, so that the
    kept rows are the outputs' own frames (t = 0, 3, ...)."""
    left, right = context(strides)
    if chunk_frames <= 0 or chunk_frames % subsampling:
        raise ValueError(f"a chunk covers a positive multiple of {subsampling} frames, "
                         f"got {chunk_frames}")
    rows = left + chunk_frames + right
    first = left % subsampling
    if (rows - first) % subsampling:
        raise ValueError(f"{rows} rows a chunk do not subsample by {subsampling} from row "
                         f"{first}")
    return {"rows": rows, "first": first, "rows_low": (rows - first) // subsampling,
            "out_first": (left - first) // subsampling, "outputs": chunk_frames // subsampling}


def _shift(x: torch.Tensor, offset: int) -> torch.Tensor:
    """x [C, T, D] -> y with y[:, t] = x[:, t + offset], zero past either end."""
    if offset == 0:
        return x
    t = x.shape[1]
    y = torch.zeros_like(x)
    if offset > 0:
        y[:, : max(t - offset, 0)] = x[:, offset:]
    else:
        y[:, -offset:] = x[:, : t + offset]
    return y


def forward(net: TdnnfNet, chunks: torch.Tensor) -> torch.Tensor:
    """The float equations on chunks [C, L + T + R, in] -> [C, T / 3, out],
    in f32 (every product at the device's default f32 precision)."""
    left, right = net.context()
    plan = chunk_rows(chunks.shape[1] - left - right, net.strides, net.subsampling)
    drop = drop_layer(net.strides, net.subsampling)
    f = net.subsampling
    relu = torch.relu
    h = net.input_bn(relu(chunks.float() @ net.input_w + net.input_b))
    rate = 1
    for i, layer in enumerate(net.layers):
        if i == drop:
            h_in, h = h, h[:, plan["first"]:: f]
            rate = f
        else:
            h_in = h
        s = layer.stride // rate
        if layer.stride == 0:
            c = h @ layer.linear[0]
            u = c @ layer.affine[0] + layer.bias
        elif i == drop:  # the drop layer reads its input rows at the full rate
            c = (_shift(h_in, -layer.stride)[:, plan["first"]:: f] @ layer.linear[0]
                 + h @ layer.linear[1])
            u = c @ layer.affine[0] + _shift(c, s) @ layer.affine[1] + layer.bias
        else:
            c = _shift(h, -s) @ layer.linear[0] + h @ layer.linear[1]
            u = c @ layer.affine[0] + _shift(c, s) @ layer.affine[1] + layer.bias
        h = net.bypass_scale * h + layer.bn(relu(u))
    if rate == 1:
        h = h[:, plan["first"]:: f]
    h = h[:, plan["out_first"]: plan["out_first"] + plan["outputs"]]
    g = h @ net.prefinal_l
    v = net.prefinal_bn(relu(g @ net.prefinal_w + net.prefinal_b))
    p = net.prefinal_small_bn(v @ net.prefinal_small)
    return p @ net.output_w + net.output_b


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def semi_orthogonal(rng: np.random.Generator, rows: int, cols: int) -> np.ndarray:
    """[rows, cols] with orthonormal columns (rows >= cols): the Q of a
    Gaussian's QR, stored [in, out] so that x @ M keeps x's scale."""
    q, r = np.linalg.qr(rng.standard_normal((rows, cols)))
    return (q * np.sign(np.diag(r))).astype(np.float32)


def _relu_bn(rng: np.random.Generator, dim: int, rms: float) -> BatchNorm:
    """Statistics near a ReLU's of an input of this rms (mean 0.399 rms,
    variance 0.341 rms^2), each jittered, so the batchnorm's output keeps
    about unit rms."""
    mean = 0.3989 * rms * rng.uniform(0.9, 1.1, dim)
    var = 0.3408 * rms * rms * rng.uniform(0.8, 1.25, dim)
    return BatchNorm(_f32(mean), _f32(var))


def random_tdnnf_net(
    rng: np.random.Generator,
    input_dim: int,
    hidden: int,
    bottleneck: int,
    strides: Sequence[int],
    prefinal: int,
    output_dim: int,
) -> TdnnfNet:
    """A seeded TDNN-F net: each layer's linear pair a semi-orthogonal [2 H,
    k] split at H (one [H, k] at stride 0), affines ~ N(0, 1 / fan_in),
    biases ~ N(0, 0.01), and batchnorm statistics drawn for the rms each
    layer's input has (1 after tdnn1, then sqrt(0.66^2 r^2 + 1)), so that
    no layer's output drifts in scale."""
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    rms = 1.0
    input_w = n(input_dim, hidden) * input_dim ** -0.5
    layers = []
    for s in strides:
        offsets = 1 if s == 0 else 2
        m = semi_orthogonal(rng, offsets * hidden, bottleneck)
        linear = tuple(_f32(m[i * hidden: (i + 1) * hidden]) for i in range(offsets))
        affine = tuple(_f32(n(bottleneck, hidden) * (offsets * bottleneck) ** -0.5)
                       for _ in range(offsets))
        layers.append(TdnnfLayer(s, linear, affine, _f32(n(hidden) * 0.1),
                                 _relu_bn(rng, hidden, rms)))
        rms = float(np.sqrt(BYPASS_SCALE ** 2 * rms * rms + 1.0))
    small_bn = BatchNorm(_f32(n(prefinal) * 0.1), _f32(rng.uniform(0.8, 1.25, prefinal)))
    return TdnnfNet(
        _f32(input_w), _f32(n(hidden) * 0.1), _relu_bn(rng, hidden, 1.0), tuple(layers),
        _f32(semi_orthogonal(rng, hidden, prefinal)), _f32(n(prefinal, hidden) * prefinal ** -0.5),
        _f32(n(hidden) * 0.1), _relu_bn(rng, hidden, rms),
        _f32(semi_orthogonal(rng, hidden, prefinal)), small_bn,
        _f32(n(prefinal, output_dim) * prefinal ** -0.5), _f32(n(output_dim) * 0.1),
    )
