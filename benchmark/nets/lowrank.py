"""The SVD-restructured DNN of Xue, Li and Gong (Interspeech 2013): a float
input layer, then every layer restructured as a rank-`rank` product,
f(E (P x) + b), sigmoid hidden layers of `hidden_widths` and a softmax
output layer of `output_dim` senones (spec.net lists the hooks).

`draw` makes the factors directly from the seed (a random matrix has no
low-rank structure to truncate); `build` hands them to the program as its
low-rank layers (fastdnn_tpu_torch.LowRank) through its public set-up path;
`reference` is reference/lowrank.py; `work` counts each product once."""

from __future__ import annotations

import torch

from benchmark.generate import torch_generator
from benchmark.lowrank_route import bottleneck
from benchmark.reference.lowrank import LowRankFloatNet, LowRankReference
from benchmark.roofline import Work, input_layer

TINY = {"hidden_widths": [256, 256, 256], "rank": 128, "output_dim": 1000}


def draw(config: dict, seed: int, device) -> LowRankFloatNet:
    """As random_net draws a dense net (weights ~ N(0, 1 / fan_in), biases
    ~ N(0, 0.01), shift ~ N(0, 1), scale ~ U(0.5, 1.5)), each low-rank
    layer's factors with the fan-in of each: P ~ N(0, 1 / a), E ~ N(0, 1 /
    rank).  One normal and one uniform draw on the device make the net; the
    input layer's rows, shift and scale are zero past `feature_dim`."""
    n_feat, n_in, k = config["feature_dim"], config["input_dim"], config["rank"]
    widths = [*config["hidden_widths"], config["output_dim"]]
    gen = torch_generator(seed, "weights", device)
    total = (n_feat * widths[0] + widths[0]
             + sum(a * k + k * b + b for a, b in zip(widths, widths[1:])) + n_feat)
    flat = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(n_feat, generator=gen, device=device)
    at = 0

    def take(n):
        nonlocal at
        at += n
        return flat[at - n : at]

    w0 = take(n_feat * widths[0]).view(n_feat, widths[0]) * n_feat ** -0.5
    biases = [take(widths[0]) * 0.1]
    factors = []
    for a, b in zip(widths, widths[1:]):
        p = take(a * k).view(a, k) * a ** -0.5
        e = take(k * b).view(k, b) * k ** -0.5
        factors.append((p, e))
        biases.append(take(b) * 0.1)
    pad = lambda t: torch.nn.functional.pad(t, (0, n_in - n_feat))
    return LowRankFloatNet(torch.nn.functional.pad(w0, (0, 0, 0, n_in - n_feat)), tuple(factors),
                           tuple(biases), pad(take(n_feat)), pad(uniform + 0.5))


def build(config: dict, net: LowRankFloatNet, device, engine: dict | None = None,
          hidden_bits: int | None = None):
    """A Scorer on `device` from the float weights (handed over on the
    host): FeedForwardNet with LowRank layers -> quantize_net -> Scorer.
    `engine` and `hidden_bits` override the configuration's (the program
    refuses hidden_bits 4 for a low-rank layer, so benchmark.controls runs
    here with `--variants tf32 bf16`)."""
    import fastdnn_tpu_torch as fdt

    host = lambda t: t.cpu()
    weights = (host(net.input_w),) + tuple(fdt.LowRank(host(p), host(e)) for p, e in net.factors)
    ff = fdt.FeedForwardNet(weights, tuple(host(b) for b in net.biases), host(net.shift),
                            host(net.scale))
    qnet = fdt.quantize_net(
        ff, cutoff=config["cutoff"],
        hidden_bits=config["hidden_bits"] if hidden_bits is None else hidden_bits,
    )
    knobs = dict(config.get("engine", {}), **(engine or {}))
    return fdt.Scorer(qnet, fdt.EngineConfig(**knobs), device=device)


def reference(config: dict, net: LowRankFloatNet, device, input_rounding=None,
              code_bits: int = 8) -> LowRankReference:
    return LowRankReference(net, config["cutoff"], device, input_rounding, code_bits)


def lowrank_layer(a: int, b: int, k: int, frames: int, out_bytes: float) -> Work:
    """One low-rank layer over `frames` frames: int8 counts [n, a] in, the
    int8 factors [a, k] and [k, b], the bottleneck's int32 zero-point sums
    (4 k) and the layer's f32 bias (4 b), out_bytes out; 2 k (a + b)
    operations a frame, each product once."""
    return Work(2.0 * frames * k * (a + b),
                frames * a + a * k + k * b + 4.0 * k + 4.0 * b + out_bytes, "int8")


def trunk(config: dict, frames: int) -> Work:
    """The low-rank hidden layers after the input layer, int8 counts in and
    out of each."""
    hidden, k = config["hidden_widths"], config["rank"]
    parts = [lowrank_layer(a, b, k, frames, frames * b) for a, b in zip(hidden, hidden[1:])]
    return Work(sum(w.ops for w in parts), sum(w.bytes for w in parts), "int8")


def output_dense(config: dict, frames: int) -> Work:
    """The output layer's expand product and softmax on the bottleneck's
    codes: codes [n, k] and scales in, the int8 factor [k, N] and its f32
    bias, f32 posteriors [n, N] out."""
    k, n_out = config["rank"], config["output_dim"]
    return Work(2.0 * frames * k * n_out,
                frames * k + 4.0 * frames + k * n_out + 4.0 * n_out + 4.0 * frames * n_out, "int8")


def output_lazy(config: dict, active: int) -> Work:
    """One frame under a mask with `active` senones: its codes and scale,
    the active senones' expand rows and biases, the mask, and the f32
    posterior row."""
    k, n_out = config["rank"], config["output_dim"]
    return Work(2.0 * k * active, k + 4.0 + active * k + 4.0 * active + n_out + 4.0 * n_out,
                "int8")


def _plus(a: Work, b: Work) -> Work:
    return Work(a.ops + b.ops, a.bytes + b.bytes, a.precision)


def work(config: dict, counts: dict) -> dict:
    """A request's counters -> {layer: Work}.  The bottleneck runs for every
    frame sent through the trunk (its codes are what a lazy frame reads)
    and counts under output_dense, beside the expand product of the frames
    scored densely."""
    out = {}
    if counts.get("hidden_frames"):
        n = counts["hidden_frames"]
        out["input_layer"] = input_layer(config, n)
        out["trunk"] = trunk(config, n)
        out["output_dense"] = bottleneck(config, n)
    if counts.get("output_frames"):
        dense = output_dense(config, counts["output_frames"])
        out["output_dense"] = _plus(out["output_dense"], dense) if "output_dense" in out else dense
    if "lazy_active" in counts:
        out["output_lazy"] = output_lazy(config, counts["lazy_active"])
    return out
