"""The system under test: the PyTorch and CUDA package, built from the
benchmark's float weights through its public set-up path
(FeedForwardNet -> quantize_net -> Scorer).  The only module of the
benchmark that imports the program."""

from __future__ import annotations

import fastdnn_tpu_torch as fdt

from .reference.net import FloatNet


def build_scorer(config: dict, net: FloatNet, device, engine: dict | None = None,
                 hidden_bits: int | None = None) -> "fdt.Scorer":
    """A Scorer on `device` for the configuration, from the float weights
    (handed over on the host, where the program quantizes them).  `engine`
    and `hidden_bits` override the configuration's; the controls use them
    to switch on the program's lower-precision paths."""
    host = lambda ts: tuple(t.cpu() for t in ts)
    ff = fdt.FeedForwardNet(host(net.weights), host(net.biases), net.shift.cpu(), net.scale.cpu())
    qnet = fdt.quantize_net(
        ff, cutoff=config["cutoff"],
        hidden_bits=config["hidden_bits"] if hidden_bits is None else hidden_bits,
    )
    knobs = dict(config.get("engine", {}), **(engine or {}))
    return fdt.Scorer(qnet, fdt.EngineConfig(**knobs), device=device)
