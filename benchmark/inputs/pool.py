"""A pool of host utterances (traffic.utterances), cycled by the caller:
`size` utterances whose lengths are the lognormal's quantiles
(generate.lengths, the same set for every seed, in the seed's order), their
features drawn in one call on the device and copied to the host in one
piece.  `kept` of them, drawn from the seed with the longest always among
them, keep their answers for the comparison (traffic.kept)."""

import numpy as np

from benchmark.generate import features, lengths, numpy_rng


def make(params: dict, seed: int, config: dict, device, traffic) -> None:
    lens = lengths(params["lengths"], params["size"], numpy_rng(seed, "pool"))
    feats = features((int(lens.sum()),), seed, config, device)
    traffic.utterances = np.split(feats.cpu().numpy(), np.cumsum(lens)[:-1])
    kept = numpy_rng(seed, "kept").choice(params["size"], size=params["kept"], replace=False)
    traffic.kept = frozenset(int(i) for i in kept) | {int(np.argmax(lens))}
