"""Kaldi's TDNN-F chain net (Povey et al., Interspeech 2018; LibriSpeech's
run_tdnn_1d.sh): tdnn1, factorized layers of `hidden_dim` with a
`bottleneck_dim` linear part at `time_strides`, the bypass, ReLU-batchnorm,
frame subsampling by `frame_subsampling_factor`, prefinal-l and
prefinal-chain at `prefinal_dim`, and the chain output of `output_dim`
with no softmax (spec.net lists the hooks).

`draw` makes the weights and batchnorm statistics from the seed; `build`
hands them to the program (fastdnn_tpu_torch.TdnnfNet) through its public
set-up path; `reference` is reference/tdnnf.py; `work` counts each product
once over the rows Kaldi's compiler needs (`needed_rows`)."""

from __future__ import annotations

import math

import torch

from benchmark.generate import torch_generator
from benchmark.reference.tdnnf import (
    TdnnfFloatLayer,
    TdnnfFloatNet,
    TdnnfReference,
    context as strides_context,
)
from benchmark.roofline import Work

TINY = {"hidden_dim": 256, "bottleneck_dim": 32, "prefinal_dim": 64, "output_dim": 1000}

#: a ReLU's output of a unit normal input: mean 1 / sqrt(2 pi), variance
#: 1 / 2 - 1 / (2 pi)
RELU_MEAN = 1.0 / math.sqrt(2.0 * math.pi)
RELU_VAR = 0.5 - 1.0 / (2.0 * math.pi)


def context(config: dict) -> tuple:
    """(left, right) rows of context an output row needs."""
    return strides_context(config["time_strides"])


def draw(config: dict, seed: int, device) -> TdnnfFloatNet:
    """The weights, from the seed, on the device.  Each factorized layer's
    linear pair is semi-orthogonal, as Kaldi's training constrains it: the Q
    of a Gaussian [2 H, k]'s QR (one [H, k] at stride 0), split at H, so that
    c keeps h's scale; the affines N(0, 1 / fan_in) over both offsets, tdnn1
    N(0, 1 / in), prefinal-l and prefinal-chain's linear semi-orthogonal,
    its affine and the output N(0, 1 / fan_in), biases N(0, 0.01).  Each
    batchnorm's statistics are a ReLU's of a normal input of the rms its
    layer's input has (1 after tdnn1, then sqrt(0.66^2 r^2 + 1) after each
    layer), mean U(0.9, 1.1) and variance U(0.8, 1.25) times those, so each
    layer's output keeps about tdnn1's rms; prefinal-chain's second one mean
    N(0, 0.01), variance U(0.8, 1.25)."""
    d, h, k = config["input_dim"], config["hidden_dim"], config["bottleneck_dim"]
    p, n_out = config["prefinal_dim"], config["output_dim"]
    gen = torch_generator(seed, "weights", device)
    normal = lambda *shape: torch.randn(shape, generator=gen, device=device)
    uniform = lambda lo, hi, n: lo + (hi - lo) * torch.rand(n, generator=gen, device=device)

    def semi_orthogonal(rows, cols):
        q, r = torch.linalg.qr(normal(rows, cols))
        return q * torch.sign(torch.diagonal(r))

    def relu_bn(rms, n=h):
        return (RELU_MEAN * rms * uniform(0.9, 1.1, n),
                RELU_VAR * rms * rms * uniform(0.8, 1.25, n))

    input_w, input_b, input_bn = normal(d, h) * d ** -0.5, normal(h) * 0.1, relu_bn(1.0)
    rms, layers = 1.0, []
    for s in config["time_strides"]:
        offsets = 1 if s == 0 else 2
        m = semi_orthogonal(offsets * h, k)
        layers.append(TdnnfFloatLayer(
            s, tuple(m[i * h: (i + 1) * h].contiguous() for i in range(offsets)),
            tuple(normal(k, h) * (offsets * k) ** -0.5 for _ in range(offsets)), normal(h) * 0.1,
            relu_bn(rms)))
        rms = math.sqrt(config["bypass_scale"] ** 2 * rms * rms + 1.0)
    prefinal_l = semi_orthogonal(h, p)
    prefinal_w, prefinal_b, prefinal_bn = normal(p, h) * p ** -0.5, normal(h) * 0.1, relu_bn(rms)
    prefinal_small = semi_orthogonal(h, p)
    small_bn = (normal(p) * 0.1, uniform(0.8, 1.25, p))
    return TdnnfFloatNet(input_w, input_b, input_bn, tuple(layers), prefinal_l, prefinal_w,
                         prefinal_b, prefinal_bn, prefinal_small, small_bn,
                         normal(p, n_out) * p ** -0.5, normal(n_out) * 0.1)


def build(config: dict, net: TdnnfFloatNet, device, engine: dict | None = None,
          hidden_bits: int | None = None):
    """A Scorer on `device` from the float weights (handed over on the
    host): TdnnfNet -> quantize_net -> Scorer.  `engine` and `hidden_bits`
    override the configuration's (the program refuses hidden_bits 4 for a
    TDNN-F net, so benchmark.controls runs here with `--variants tf32
    bf16`).  The program has no bf16 input layer for this net (it refuses
    input_precision "default" at set-up), so the bf16 control, which asks
    for one, gets the reference with tdnn1's operands rounded to bf16."""
    import fastdnn_tpu_torch as fdt

    if (engine or {}).get("input_precision") == "default":
        from benchmark.controls import ReferenceScorer

        return ReferenceScorer(reference(config, net, device, input_rounding="bf16"))

    host = lambda t: t.cpu()
    bn = lambda stats: fdt.BatchNorm(host(stats[0]), host(stats[1]))
    layers = tuple(fdt.TdnnfLayer(layer.stride, tuple(map(host, layer.linear)),
                                  tuple(map(host, layer.affine)), host(layer.bias), bn(layer.bn))
                   for layer in net.layers)
    tnet = fdt.TdnnfNet(host(net.input_w), host(net.input_b), bn(net.input_bn), layers,
                        host(net.prefinal_l), host(net.prefinal_w), host(net.prefinal_b),
                        bn(net.prefinal_bn), host(net.prefinal_small), bn(net.prefinal_small_bn),
                        host(net.output_w), host(net.output_b),
                        bypass_scale=config["bypass_scale"],
                        subsampling=config["frame_subsampling_factor"])
    qnet = fdt.quantize_net(tnet, cutoff=config["cutoff"],
                            hidden_bits=config["hidden_bits"] if hidden_bits is None else hidden_bits)
    knobs = dict(config.get("engine", {}), **(engine or {}))
    return fdt.Scorer(qnet, fdt.EngineConfig(**knobs), device=device)


def reference(config: dict, net: TdnnfFloatNet, device, input_rounding=None) -> TdnnfReference:
    return TdnnfReference(net, config, device, input_rounding)


def needed_rows(config: dict, frames: int) -> dict:
    """The rows of one chunk of `frames` output-covered frames that Kaldi's
    compiler computes, walking back from the outputs (t = 0, f, 2 f, ... <
    frames): for each factorized layer, in order, (stride, output rows,
    linear rows c), where the output at t reads c at t and t + s and c at t
    reads the input at t - s and t; then `input_rows`, the rows tdnn1
    computes, and `outputs`."""
    f = config["frame_subsampling_factor"]
    need = set(range(0, frames, f))
    layers = []
    for s in reversed(config["time_strides"]):
        c = need | {t + s for t in need}
        layers.append((s, len(need), len(c)))
        need = c | {t - s for t in c}
    return {"layers": layers[::-1], "input_rows": len(need), "outputs": len(range(0, frames, f))}


def _chunk_work(config: dict, frames: int) -> dict:
    """{layer: (ops, bytes)} of one chunk."""
    rows = needed_rows(config, frames)
    d, h, k = config["input_dim"], config["hidden_dim"], config["bottleneck_dim"]
    p, n_out = config["prefinal_dim"], config["output_dim"]
    n1, outputs = rows["input_rows"], rows["outputs"]
    out = {"input_layer": (2.0 * n1 * d * h,
                           4.0 * n1 * d + 4.0 * d * h + 12.0 * h + n1 * (h + 4.0))}
    ops = byts = 0.0
    need_in = n1
    for s, n_out_rows, n_c in rows["layers"]:
        offsets = 1 if s == 0 else 2
        ops += offsets * (2.0 * n_c * h * k + 2.0 * n_out_rows * k * h)
        byts += need_in * (h + 4.0) + n_out_rows * (h + 4.0) + offsets * 2.0 * h * k + 12.0 * h
        need_in = n_out_rows
    out["trunk"] = (ops, byts)
    out["output_dense"] = (
        outputs * (2.0 * h * p * 3 + 2.0 * p * n_out),
        outputs * (h + 4.0) + 3.0 * h * p + p * n_out + 12.0 * h + 4.0 * p + 4.0 * n_out
        + 4.0 * outputs * n_out)
    return out


def work(config: dict, counts: dict) -> dict:
    """A request's counters -> {layer: Work}: its `chunks` of the
    configuration's `chunk_frames` (frames / chunks), each layer's work of
    one chunk times the chunks, the weights' bytes once a request."""
    chunks = counts.get("chunks")
    if not chunks:
        return {}
    per = _chunk_work(config, counts["frames"] // chunks)
    d, h, k = config["input_dim"], config["hidden_dim"], config["bottleneck_dim"]
    p, n_out = config["prefinal_dim"], config["output_dim"]
    weights = {
        "input_layer": 4.0 * d * h + 12.0 * h,
        "trunk": sum((1 if s == 0 else 2) * 2.0 * h * k + 12.0 * h
                     for s in config["time_strides"]),
        "output_dense": 3.0 * h * p + p * n_out + 12.0 * h + 4.0 * p + 4.0 * n_out,
    }
    precision = {"input_layer": "tf32", "trunk": "int8", "output_dense": "int8"}
    return {name: Work(chunks * ops, chunks * (byts - weights[name]) + weights[name],
                       precision[name])
            for name, (ops, byts) in per.items()}

