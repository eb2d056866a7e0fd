"""End-to-end pipeline of the PyTorch/CUDA port: every stage a reference
user would migrate, as the JAX package's examples/pipeline.py shows it.

    Kaldi artifacts -> parse -> align -> binary model -> quantize ->
    checkpoint -> score (full + lazy) -> serve over TCP -> client

The network is a synthetic Kaldi-text one (the reference's trained net is
not redistributable); the frames come from --features or are seeded
(examples/_common.py).

    python -m fastdnn_tpu_torch.examples.pipeline [--device cuda|cpu] [--features F]
"""

from __future__ import annotations

import argparse
import tempfile
import threading
from pathlib import Path

import numpy as np

from . import _common

#: streamed and served posteriors against direct scoring (CLAUDE.md's bound)
SERVE_ATOL = 3e-5


def synth_kaldi_text(rng, in_dim, hidden, out_dim):
    """A tiny nnet1-format text network + feature transform."""
    def mat(r, c):
        return "\n".join(" ".join(f"{v:.6f}" for v in row)
                         for row in rng.standard_normal((r, c)) * 0.1)

    parts, prev = [], in_dim
    for width in hidden + [out_dim]:
        parts.append(f"<AffineTransform> {width} {prev}")
        parts.append(mat(width, prev))
        parts.append(" ".join(f"{v:.6f}" for v in rng.standard_normal(width) * 0.1))
        parts.append("<Sigmoid>" if width != out_dim else "<Softmax>")
        prev = width
    net_text = "\n".join(parts) + "\n"
    shift = " ".join(f"{v:.6f}" for v in rng.standard_normal(in_dim))
    scale = " ".join(f"{v:.6f}" for v in rng.uniform(0.5, 1.5, in_dim))
    transform = f"[ {shift} ]\n[ {scale} ]\n"
    return net_text, transform


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m fastdnn_tpu_torch.examples.pipeline")
    _common.add_flags(p)
    args = p.parse_args(argv)
    device = _common.device_of(args)

    import fastdnn_tpu_torch as fdt
    from fastdnn_tpu_torch.cli.serve import ScoreClient, ScoreServer
    from fastdnn_tpu_torch.formats.kaldi_text import load_network_text

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="fastdnn_torch_demo_") as td:
        tmp = Path(td)
        # 1. Kaldi text -> parsed network (parser + feature transform)
        net_text, transform = synth_kaldi_text(rng, _common.FEATURE_DIM, [256, 256], 1000)
        (tmp / "nnet.txt").write_text(net_text)
        (tmp / "final.feature_transform").write_text(transform)
        raw = load_network_text(tmp / "nnet.txt", tmp / "final.feature_transform")
        print(f"1. parsed Kaldi text: {raw.topology()}")

        # 2. align + binary model round trip
        net = fdt.align(fdt.from_raw(raw), 4, 16)
        fdt.write_model(fdt.to_raw(net), tmp / "model.bin")
        net = fdt.from_raw(fdt.read_model(tmp / "model.bin"))
        print(f"2. aligned + binary round trip: input {net.input_dim}")

        # 3. quantize (transform fused) + durable checkpoint
        qnet = fdt.quantize_net(net, cutoff=3.0)
        fdt.save_qnet(qnet, tmp / "model.qnet.npz")
        qnet = fdt.load_qnet(tmp / "model.qnet.npz")
        print("3. int8 checkpoint round trip")

        # 4. score the frames, full + lazy
        scorer = fdt.Scorer(qnet, device=device)
        frames = _common.load_frames(args.features, tmp)
        post = scorer.score(frames)
        masks = (rng.random((len(frames), scorer.output_dim)) < 0.4).astype(np.uint8)
        lazy = scorer.score_masked(frames, masks)
        for what, p_ in (("full", post), ("lazy", lazy)):
            sums = p_.astype(np.float64).sum(1)
            _common.check(bool(np.isfinite(p_).all()) and np.abs(sums - 1).max() <= 1e-5,
                          f"{what} posteriors: finite rows summing to 1 +- 1e-5")
        print(f"4. scored {post.shape} on {device}; lazy rowsum "
              f"[{lazy.sum(1).min():.5f}, {lazy.sum(1).max():.5f}]")

        # 5. serve it: streaming engine + TCP protocol + concurrent client
        server = ScoreServer(("127.0.0.1", 0), fdt.StreamingScorer(scorer, max_wait_ms=2.0))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            client = ScoreClient(*server.server_address[:2])
            try:
                via_wire = client.score(frames[:32])
                d = float(np.abs(via_wire - post[:32]).max())
                _common.check(d <= SERVE_ATOL, f"served posteriors {d} from direct scoring")
                print(f"5. served over TCP: max |direct - wire| = {d:.2e}")
                print(f"   server stats: {client.stats()}")
            finally:
                client.close()
        finally:
            server.shutdown()
            server.server_close()
            server.stream.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
