"""The net's float weights, drawn from the run's seed on the device.

As the program's `random_net` draws them (weights ~ N(0, 1 / fan_in),
biases ~ N(0, 0.01), shift ~ N(0, 1), scale ~ U(0.5, 1.5)), for a net of
`feature_dim` inputs, then aligned as the reference aligns it: the input
layer's rows, shift and scale zero-padded to `input_dim`.  One normal and
one uniform draw on the device make the whole net.
"""

from __future__ import annotations

import torch

from .generate import torch_generator
from .reference.net import FloatNet


def draw(config: dict, seed: int, device) -> FloatNet:
    n_feat, n_in = config["feature_dim"], config["input_dim"]
    dims = [n_feat, *config["hidden_widths"], config["output_dim"]]
    gen = torch_generator(seed, "weights", device)
    total = sum(a * b + b for a, b in zip(dims, dims[1:])) + n_feat
    flat = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(n_feat, generator=gen, device=device)
    weights, biases = [], []
    at = 0
    for a, b in zip(dims, dims[1:]):
        weights.append(flat[at : at + a * b].view(a, b) * a ** -0.5)
        biases.append(flat[at + a * b : at + a * b + b] * 0.1)
        at += a * b + b
    weights[0] = torch.nn.functional.pad(weights[0], (0, 0, 0, n_in - n_feat))
    pad = lambda t: torch.nn.functional.pad(t, (0, n_in - n_feat))
    return FloatNet(tuple(weights), tuple(biases), pad(flat[at:]), pad(uniform + 0.5))
