"""A ring of device-resident batches of utterance chunks (traffic.batches),
cycled by the caller: `batches` batches of `chunks` chunks each, a chunk
`frames` frames with the net's own left and right context (its net
module's `context`), extra left context 0, as Kaldi's chunked decoding cuts
them.  Each row is spliced as the net's input is: MFCCs of `mfcc_dim` at
t - 1, t and t + 1, then the chunk's i-vector of `ivector_dim`, laid into
every row of the chunk; both standard normal, drawn in one call each on the
device.  The caller reads traffic.chunk_frames, traffic.context and
traffic.subsampling."""

import torch

from benchmark import spec
from benchmark.generate import torch_generator


def make(params: dict, seed: int, config: dict, device, traffic) -> None:
    left, right = spec.net(config).context(config)
    rows = left + params["frames"] + right
    shape = (params["batches"], params["chunks"])
    gen = torch_generator(seed, "features", device)
    mfcc = torch.randn((*shape, rows + 2, config["mfcc_dim"]), generator=gen, device=device)
    ivector = torch.randn((*shape, 1, config["ivector_dim"]), generator=gen, device=device)
    spliced = [mfcc[:, :, i: i + rows] for i in range(3)] + [ivector.expand(*shape, rows, -1)]
    batches = torch.cat(spliced, dim=3)
    if batches.shape[3] != config["input_dim"]:
        raise ValueError(f"a spliced row has {batches.shape[3]} values; the net takes "
                         f"{config['input_dim']}")
    traffic.batches = list(batches.unbind(0))
    traffic.chunk_frames = params["frames"]
    traffic.context = (left, right)
    traffic.subsampling = config["frame_subsampling_factor"]
