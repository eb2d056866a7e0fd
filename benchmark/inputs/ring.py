"""A ring of device-resident batches (traffic.batches), cycled by the
caller: `batches` batches of `frames` frames each, drawn in one call on the
device and zero in the columns that pad the features to `input_dim`."""

import torch

from benchmark.generate import features


def make(params: dict, seed: int, config: dict, device, traffic) -> None:
    shape = (params["batches"], params["frames"])
    batches = torch.zeros((*shape, config["input_dim"]), device=device)
    batches[:, :, : config["feature_dim"]] = features(shape, seed, config, device)
    traffic.batches = list(batches.unbind(0))
