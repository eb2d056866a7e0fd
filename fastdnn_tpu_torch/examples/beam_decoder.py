"""ASR-style decoding on the PyTorch/CUDA port: a real beam search driving
lazy masks, as the JAX package's examples/beam_decoder.py shows it.

A synthetic word lexicon (left-to-right senone chains) is decoded four
ways through one quantized engine:

  1. dense    full posteriors every frame (the oracle);
  2. lazy     frame-synchronous LazyContext scoring only the senones the
              live beam can consume (the reference's lazy API shape);
  3. rescore  the recorded mask trajectory scored in one call
              (Scorer.score_masked);
  4. cluster  the block-sparse deployment: the senone-clustering
              permutation derived from the beam's own masks, the model and
              lexicon permuted once, decoded through lazy_mode=
              "block_sparse" (K6 skips all-inactive tiles; on the CPU, whose
              plain backend has no such mode, the block-sparse route's plain
              version).

All four must give the same word sequence.

    python -m fastdnn_tpu_torch.examples.beam_decoder [--device cuda|cpu]
        [--features F] [--beam 64] [--words 50]
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import numpy as np

from . import _common


def block_sparse_scorer(qnet, device):
    """A Scorer whose masked calls skip all-inactive tiles: lazy_mode=
    "block_sparse" on the card; on the CPU the same route with the plain
    version of the block-sparse kernel (ops.matmul)."""
    from fastdnn_tpu_torch import EngineConfig, Scorer

    if device.type == "cuda":
        return Scorer(qnet, EngineConfig(lazy_mode="block_sparse"), device=device)

    class PlainBlockSparse(Scorer):
        def _run_masked(self, frames, masks):
            route = dataclasses.replace(self._route, block_sparse=True)
            return route.score_masked(self.net, frames, masks)

    return PlainBlockSparse(qnet, device=device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m fastdnn_tpu_torch.examples.beam_decoder")
    _common.add_flags(p)
    p.add_argument("--beam", type=int, default=64)
    p.add_argument("--words", type=int, default=50)
    args = p.parse_args(argv)
    device = _common.device_of(args)

    import fastdnn_tpu_torch as fdt
    from fastdnn_tpu_torch.decoder import BeamDecoder, Lexicon, random_lexicon
    from fastdnn_tpu_torch.engine.cluster import (
        inverse_permutation,
        mask_cluster_permutation,
        permute_output_layer,
    )

    with tempfile.TemporaryDirectory(prefix="fastdnn_torch_demo_") as td:
        frames = _common.load_frames(args.features, td)
    # weights drawn wider than random_net's default (1/sqrt(fan_in)), so
    # that a random net's argmax follows the frames, as a trained net's does
    net = fdt.align(fdt.random_net(np.random.default_rng(0), _common.FEATURE_DIM,
                                   [512] * 3, 1000, w_std=0.2), 4, 16)
    qnet = fdt.quantize_net(net)
    scorer = fdt.Scorer(qnet, device=device)

    # A lexicon the acoustics can traverse: the dense argmax senone track cut
    # into "true" words, plus random distractors, so that the search has
    # signal to follow and the beam churns at word boundaries.
    rng = np.random.default_rng(11)
    track = scorer.score(frames).argmax(1)
    dedup = track[np.insert(np.diff(track) != 0, 0, True)]
    true_words = [tuple(int(s) for s in dedup[i : i + 4])
                  for i in range(0, len(dedup) - 3, 4)][:20]
    distract = random_lexicon(rng, max(args.words - len(true_words), 1), scorer.output_dim)
    lex = Lexicon(tuple(true_words) + distract.words)
    dec = BeamDecoder(lex, scorer.output_dim, beam_width=args.beam)

    t0 = time.perf_counter()
    dense = dec.decode_dense(scorer, frames)
    t_dense = time.perf_counter() - t0
    t0 = time.perf_counter()
    lazy = dec.decode_lazy(scorer, frames)
    t_lazy = time.perf_counter() - t0
    t0 = time.perf_counter()
    rescore = dec.decode_rescore(scorer, frames, lazy.masks)
    t_rescore = time.perf_counter() - t0

    # clustered block-sparse: permute the model and the lexicon once
    perm = mask_cluster_permutation(lazy.masks)
    inv = inverse_permutation(perm)
    sc_bs = block_sparse_scorer(permute_output_layer(qnet, perm), device)
    lex_bs = Lexicon(tuple(tuple(int(inv[s]) for s in w) for w in lex.words))
    dec_bs = BeamDecoder(lex_bs, scorer.output_dim, beam_width=args.beam)
    t0 = time.perf_counter()
    cluster = dec_bs.decode_rescore(sc_bs, frames, lazy.masks[:, perm])
    t_cluster = time.perf_counter() - t0

    def skippable(masks, bm=64, bn=128):
        """Share of the block-sparse kernel's (64-frame x 128-senone) tiles
        that are all inactive."""
        f, n = masks.shape
        fi, nj = -(-f // bm), -(-n // bn)
        pad = np.zeros((fi * bm, nj * bn), masks.dtype)
        pad[:f, :n] = masks
        return 1.0 - pad.reshape(fi, bm, nj, bn).any(axis=(1, 3)).mean()

    print(f"frames: {frames.shape[0]}, lexicon: {len(lex.words)} words, beam {args.beam}, "
          f"device {device}")
    print(f"dense   decode: {len(dense.words):3d} words, {t_dense * 1e3:7.1f} ms")
    print(f"lazy    decode: {len(lazy.words):3d} words, {t_lazy * 1e3:7.1f} ms "
          f"(LazyContext, one launch per frame)")
    print(f"rescore decode: {len(rescore.words):3d} words, {t_rescore * 1e3:7.1f} ms "
          f"(whole mask matrix, one call)")
    print(f"cluster decode: {len(cluster.words):3d} words, {t_cluster * 1e3:7.1f} ms "
          f"(block-sparse route on the clustered-id model)")
    print(f"mask stats from the LIVE BEAM: density {lazy.avg_density:.3f}, "
          f"churn {lazy.avg_churn * scorer.output_dim:.1f} senone flips/frame")
    print(f"skippable (64x128) tiles: raw ids {skippable(lazy.masks):.1%} -> "
          f"clustered {skippable(lazy.masks[:, perm]):.1%}")
    agree = dense.words == lazy.words == rescore.words == cluster.words
    print(f"word sequences agree: {agree}")
    return 0 if agree else 1


if __name__ == "__main__":
    raise SystemExit(main())
