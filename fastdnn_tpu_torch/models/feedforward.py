"""Float feed-forward acoustic model, held in PyTorch tensors.

Topology as in fastdnn_tpu/models/feedforward.py: an input layer (float),
N sigmoid hidden layers and a softmax output layer, with a per-frame feature
transform `(x + shift) * scale` before the first layer.  Weights are stored
[input_dim, output_dim], so a frame batch is scored as `x @ W + b`.

A layer after the input layer may instead be low-rank (`LowRank`), the
restructured layer of Xue, Li and Gong (Interspeech 2013): W [m, n] of a
trained net replaced by its rank-k truncated SVD, W ~ A B with A [m, k]
and B [k, n], so the layer computes f(A (B x) + b), its bottleneck B x
linear and bias-free.  Stored [in, out] as the dense weights are, that is
`x @ project @ expand + b` with project = B^T [in, k] and expand = A^T
[k, out] (`restructure` makes them from a dense net).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..formats.binary import RawLayer, RawNetwork
from ..ops.matmul import matmul_f32
from ..utils.align import aligned_size


@dataclasses.dataclass(frozen=True)
class LowRank:
    """A low-rank layer's two factors: x @ project [in, k] @ expand [k, out].
    `shape` is (in, out), the shape of the dense weight it stands for."""

    project: torch.Tensor
    expand: torch.Tensor

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.project.shape[0], self.expand.shape[1])

    @property
    def rank(self) -> int:
        return self.project.shape[1]


@dataclasses.dataclass(frozen=True)
class FeedForwardNet:
    """Float network.

    weights[i]: f32 [in_dim_i, out_dim_i]  (transposed from file layout),
        or a LowRank for a restructured layer after the input layer
    biases[i]:  f32 [out_dim_i]
    shift/scale: f32 [input_dim]
    """

    weights: Tuple[torch.Tensor, ...]
    biases: Tuple[torch.Tensor, ...]
    shift: torch.Tensor
    scale: torch.Tensor

    @property
    def input_dim(self) -> int:
        return self.weights[0].shape[0]

    @property
    def output_dim(self) -> int:
        return self.weights[-1].shape[1]

    @property
    def layer_count(self) -> int:
        return len(self.weights)

    def layer_dims(self) -> List[int]:
        return [w.shape[1] for w in self.weights]


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _t(a: np.ndarray) -> torch.Tensor:
    return _f32(np.ascontiguousarray(a.T))


def from_raw(raw: RawNetwork) -> FeedForwardNet:
    """Build the net from a parsed model file (transposes weights); a raw
    layer with a bottleneck becomes a LowRank (the JAX package's raw layers
    have none)."""
    return FeedForwardNet(
        tuple(_t(l.weights) if getattr(l, "bottleneck", None) is None
              else LowRank(_t(l.bottleneck), _t(l.weights)) for l in raw.layers),
        tuple(_f32(l.bias) for l in raw.layers),
        _f32(raw.shift),
        _f32(raw.scale),
    )


def to_raw(net: FeedForwardNet) -> RawNetwork:
    """Inverse of `from_raw`, for writing reference-format files."""
    layers = [
        RawLayer(w.numpy().T.copy(), b.numpy().copy()) if not isinstance(w, LowRank)
        else RawLayer(w.expand.numpy().T.copy(), b.numpy().copy(), w.project.numpy().T.copy())
        for w, b in zip(net.weights, net.biases)
    ]
    return RawNetwork(layers, net.shift.numpy().copy(), net.scale.numpy().copy())


def _pad_to(t, *shape: int):
    """Zero-pad a weight to `shape` (in, out); a LowRank pads its project's
    rows and its expand's columns."""
    if isinstance(t, LowRank):
        return LowRank(_pad_to(t.project, shape[0], t.rank), _pad_to(t.expand, t.rank, shape[1]))
    out = torch.zeros(shape, dtype=t.dtype)
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


def align(
    net: FeedForwardNet, input_alignment: int = 4, hidden_alignment: int = 16
) -> FeedForwardNet:
    """Zero-pad dims: input dim to a multiple of `input_alignment`, hidden
    widths to `hidden_alignment`; the output layer is aligned on its input
    side only (the reference's FeedForwardNetwork.align)."""
    n = net.layer_count
    ws, bs = [], []
    for i, (w, b) in enumerate(zip(net.weights, net.biases)):
        in_a = input_alignment if i == 0 else hidden_alignment
        out_a = 1 if i == n - 1 else hidden_alignment
        out_dim = aligned_size(w.shape[1], out_a)
        ws.append(_pad_to(w, aligned_size(w.shape[0], in_a), out_dim))
        bs.append(_pad_to(b, out_dim))
    pad_in = ws[0].shape[0]
    return FeedForwardNet(
        tuple(ws), tuple(bs), _pad_to(net.shift, pad_in), _pad_to(net.scale, pad_in)
    )


def extend(net: FeedForwardNet, hidden_width: int, output_count: int) -> FeedForwardNet:
    """Grow a net to `hidden_width`-wide hidden layers and `output_count`
    outputs (the reference's FeedForwardNetwork.extend, used to make the
    large benchmark net from a small trained one): hidden layers are tiled
    circularly along both dims (the input layer along its nodes only); the
    output layer is zero-padded, so the added senones have zero weights and
    bias.  A net with low-rank layers is refused."""
    if any(isinstance(w, LowRank) for w in net.weights):
        raise ValueError("extend tiles dense layers; this net has low-rank layers")
    n = net.layer_count
    ws, bs = [], []
    for i, (w, b) in enumerate(zip(net.weights, net.biases)):
        if i == n - 1:
            ws.append(_pad_to(w, hidden_width, output_count))
            bs.append(_pad_to(b, output_count))
        else:
            rows = torch.arange(w.shape[0] if i == 0 else hidden_width) % w.shape[0]
            cols = torch.arange(hidden_width) % w.shape[1]
            ws.append(w[rows][:, cols].contiguous())
            bs.append(b[cols].contiguous())
    return FeedForwardNet(tuple(ws), tuple(bs), net.shift, net.scale)


def fuse_transform(net: FeedForwardNet) -> FeedForwardNet:
    """Fold `(x + shift) * scale` into the first layer:

    (x + shift) * scale @ W1 + b1 == x @ (scale[:, None] * W1)
                                     + (b1 + (shift * scale) @ W1)
    """
    w0, b0 = net.weights[0], net.biases[0]
    if isinstance(w0, LowRank):
        raise ValueError("the input layer must be dense: it stays float and unfactorized")
    fused_w0 = net.scale[:, None] * w0
    fused_b0 = b0 + matmul_f32((net.shift * net.scale)[None, :], w0)[0]
    return FeedForwardNet(
        (fused_w0,) + tuple(net.weights[1:]),
        (fused_b0,) + tuple(net.biases[1:]),
        torch.zeros_like(net.shift),
        torch.ones_like(net.scale),
    )


def apply_transform(net: FeedForwardNet, frames: torch.Tensor) -> torch.Tensor:
    """(x + shift) * scale."""
    return (frames + net.shift) * net.scale


def forward(
    net: FeedForwardNet, frames: torch.Tensor, *, apply_input_transform: bool = True
) -> torch.Tensor:
    """Float forward pass: posteriors f32 [frames, output_dim].

    The float oracle the quantized engine is measured against; products run
    free of TF32 (ops.matmul.matmul_f32), softmax is the stable form.
    """
    x = apply_transform(net, frames) if apply_input_transform else frames
    n = net.layer_count
    for i in range(n):
        w = net.weights[i]
        x = (matmul_f32(matmul_f32(x, w.project), w.expand) if isinstance(w, LowRank)
             else matmul_f32(x, w)) + net.biases[i]
        if i < n - 1:
            x = torch.sigmoid(x)
    return torch.softmax(x, dim=-1)


def random_net(
    rng: np.random.Generator,
    input_dim: int,
    hidden_widths: Sequence[int],
    output_dim: int,
    w_std: float | None = None,
) -> FeedForwardNet:
    """Random test/benchmark net with the reference topology family, drawn
    from a numpy Generator.

    Weights default to 1/sqrt(fan_in) scaling so pre-activations land in the
    sigmoid's useful range, like a trained net.
    """
    dims = [input_dim, *hidden_widths, output_dim]
    ws, bs = [], []
    for i in range(len(dims) - 1):
        std = w_std if w_std is not None else dims[i] ** -0.5
        ws.append(_f32(rng.standard_normal((dims[i], dims[i + 1]), dtype=np.float32) * std))
        bs.append(_f32(rng.standard_normal(dims[i + 1], dtype=np.float32) * 0.1))
    shift = _f32(rng.standard_normal(input_dim, dtype=np.float32))
    scale = _f32(rng.uniform(0.5, 1.5, input_dim))
    return FeedForwardNet(tuple(ws), tuple(bs), shift, scale)


def restructure(net: FeedForwardNet, rank: int, layers: Sequence[int] | None = None
                ) -> FeedForwardNet:
    """The paper's SVD split: each listed layer's W [in, out] (every layer
    after the input layer by default) replaced by its rank-`rank` truncated
    SVD, W = U S V^T ~ project @ expand with project = U_k S_k [in, k] and
    expand = V_k^T [k, out]: the bottleneck, applied first, carries the
    singular values, as the paper's N = S V^T does.  At rank min(in, out)
    the product is W to float rounding.  The SVD runs in float64."""
    if layers is None:
        layers = range(1, net.layer_count)
    ws = list(net.weights)
    for i in layers:
        if i == 0:
            raise ValueError("the input layer stays dense")
        w = ws[i]
        if isinstance(w, LowRank):
            raise ValueError(f"layer {i} is already low-rank")
        if not 0 < rank <= min(w.shape):
            raise ValueError(f"rank {rank} must be in [1, {min(w.shape)}] for layer {i}")
        u, sv, vh = torch.linalg.svd(w.to(torch.float64), full_matrices=False)
        ws[i] = LowRank((u[:, :rank] * sv[:rank]).to(torch.float32).contiguous(),
                        vh[:rank].to(torch.float32).contiguous())
    return dataclasses.replace(net, weights=tuple(ws))


def random_lowrank_net(
    rng: np.random.Generator,
    input_dim: int,
    hidden_widths: Sequence[int],
    output_dim: int,
    rank: int,
) -> FeedForwardNet:
    """`random_net`'s topology with every layer after the input layer low-rank
    at `rank`, its factors drawn directly (a random matrix has no low-rank
    structure to truncate): project ~ N(0, 1 / in), expand ~ N(0, 1 / rank),
    so that each factor keeps its output in the sigmoid's useful range."""
    base = random_net(rng, input_dim, hidden_widths, output_dim)
    dims = [input_dim, *hidden_widths, output_dim]
    ws = [base.weights[0]]
    for a, b in zip(dims[1:], dims[2:]):
        ws.append(LowRank(
            _f32(rng.standard_normal((a, rank), dtype=np.float32) * a ** -0.5),
            _f32(rng.standard_normal((rank, b), dtype=np.float32) * rank ** -0.5)))
    return dataclasses.replace(base, weights=tuple(ws))
