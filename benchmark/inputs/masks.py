"""Each pool utterance's evolving decoder-style masks (traffic.masks), on
the host: a density from an even grid over [density_min, density_max],
shuffled by the seed, then `churn` of the senones turned over each frame
(generate.generate_masks).  Follows a pool."""

import numpy as np

from benchmark.generate import generate_masks, numpy_rng


def make(params: dict, seed: int, config: dict, device, traffic) -> None:
    count = len(traffic.utterances)
    grid = params["density_min"] + (params["density_max"] - params["density_min"]) * (
        (np.arange(count) + 0.5) / count
    )
    rng = numpy_rng(seed, "masks")
    traffic.masks = [
        generate_masks(rng, len(u), config["output_dim"], float(d), params["churn"])
        for u, d in zip(traffic.utterances, rng.permutation(grid))
    ]
