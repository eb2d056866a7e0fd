"""Model and feature conversion CLI of the PyTorch/CUDA port, as
fastdnn_tpu/cli/convert.py:

    python -m fastdnn_tpu_torch.cli.convert model NNET.txt TRANSFORM.txt OUT.bin
        [--from-binary] [--align INPUT HIDDEN] [--extend HIDDEN OUT]
    python -m fastdnn_tpu_torch.cli.convert quantize MODEL.bin OUT.npz
        [--cutoff F] [--hidden-bits 8|4]
    python -m fastdnn_tpu_torch.cli.convert features FEATS.txt OUT.bin
        [--align-dim N] [--max-frames N] [--utterance ID]

  model:    Kaldi nnet1 text + feature transform -> reference binary model,
            optionally grown by circular cloning (--extend) and zero-padded
            (--align), in that order
  quantize: binary model -> `.npz` checkpoint (int8, or an int4 hidden trunk)
            that either package's scorer loads without a quantization pass
  features: Kaldi text features -> reference binary feature matrix

Everything here runs on the host (numpy and CPU tensors); the binary files
it writes are byte for byte the JAX package's, and its checkpoints hold
the same arrays, except the input bias with the feature transform fused
in, a dot product whose f32 summation order may differ in the last bits.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..formats.binary import read_model, write_features, write_model
from ..formats.kaldi_text import load_features_text, load_network_text
from ..models.feedforward import align, extend, from_raw, to_raw
from ..utils.align import aligned_size


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fastdnn-torch-convert")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("model", help="Kaldi text net -> binary model")
    m.add_argument("network", help="nnet1 text file or binary model (with --from-binary)")
    m.add_argument("transform", nargs="?", default=None, help="feature-transform text file")
    m.add_argument("out", help="output binary model path")
    m.add_argument("--from-binary", action="store_true", help="input is already a binary model")
    m.add_argument(
        "--align", nargs=2, type=int, metavar=("INPUT", "HIDDEN"), default=None,
        help="zero-pad input dim to xINPUT and hidden widths to xHIDDEN",
    )
    m.add_argument(
        "--extend", nargs=2, type=int, metavar=("HIDDEN", "OUT"), default=None,
        help="grow net by circular cloning to HIDDEN-wide layers / OUT outputs",
    )

    q = sub.add_parser("quantize", help="binary model -> .npz checkpoint (quantize once)")
    q.add_argument("model", help="reference-format binary model")
    q.add_argument("out", help="output checkpoint path (.npz)")
    q.add_argument("--cutoff", type=float, default=3.0)
    q.add_argument("--hidden-bits", type=int, default=8, choices=[8, 4],
                   help="4 = int4 hidden trunk (output layer stays int8)")

    f = sub.add_parser("features", help="Kaldi text features -> binary matrix")
    f.add_argument("input", help="Kaldi text feature file")
    f.add_argument("out", help="output binary path")
    f.add_argument("--align-dim", type=int, default=None, help="zero-pad dim to a multiple")
    f.add_argument("--max-frames", type=int, default=-1)
    f.add_argument("--utterance", default=None, help="utterance id (default: first)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "model":
        if args.from_binary:
            raw = read_model(args.network)
        else:
            if args.transform is None:
                print("error: transform file required for text input", file=sys.stderr)
                return 2
            raw = load_network_text(args.network, args.transform)
        net = from_raw(raw)
        print(f"Loaded      = {raw.topology()}")
        if args.extend:
            net = extend(net, *args.extend)
        if args.align:
            net = align(net, *args.align)
        out_raw = to_raw(net)
        write_model(out_raw, args.out)
        print(f"Saved       = {out_raw.topology()} -> {args.out}")
    elif args.cmd == "quantize":
        from ..quant.quantize import quantize_net
        from ..quant.serialize import save_qnet

        raw = read_model(args.model)
        qnet = quantize_net(from_raw(raw), cutoff=args.cutoff, hidden_bits=args.hidden_bits)
        save_qnet(qnet, args.out)
        params = sum(w.numel() for w in qnet.weights)
        print(f"Loaded      = {raw.topology()}")
        kind = "int4-trunk" if args.hidden_bits == 4 else "int8"
        print(f"Saved       = {kind} checkpoint ({params} quantized weights, "
              f"cutoff {args.cutoff}) -> {args.out}")
    else:
        feats = load_features_text(args.input)
        if args.utterance is not None:
            data = feats.get(args.utterance)
            if data is None:
                raise ValueError(
                    f"utterance {args.utterance!r} not found; available: {list(feats)}"
                )
        else:
            data = next(iter(feats.values()))
        if args.align_dim:
            target = aligned_size(data.shape[1], args.align_dim)
            data = np.pad(data, ((0, 0), (0, target - data.shape[1])))
        write_features(data, args.out, max_frames=args.max_frames)
        n = data.shape[0] if args.max_frames < 0 else min(args.max_frames, data.shape[0])
        print(f"Saved       = {n}x{data.shape[1]} -> {args.out}")
    return 0


def _cli(argv=None) -> int:
    """Entry point with one-line error reporting for expected failures
    (bad paths, dims or parameters)."""
    try:
        return main(argv)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(_cli())
