"""Senone-clustering permutation for the block-sparse lazy kernel: the
counterpart of fastdnn_tpu/engine/cluster.py.

The block-sparse masked output kernel (ops.kernels.
resident_softmax_block_sparse) skips a (64-frame x 128-senone) tile only
when every mask entry in it is zero.  Decoder masks are sparse but senone
ids are scattered, so random-id masks almost never clear a whole tile.  The
fix is a static relabeling: order senones so that ids active together sit
in the same tile.  `mask_cluster_permutation` sorts senones by the mean
frame index at which they fire in sample mask trajectories (never-active
senones go last).

Deployment: permute the model once at load time (`permute_output_layer`),
translate the decoder's senone ids once through the permutation, and feed
the decoder the permuted posteriors; no per-call posterior gathers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..quant.quantize import QuantizedNet


def mask_cluster_permutation(masks: np.ndarray) -> np.ndarray:
    """Permutation `perm` (new position -> old senone id) clustering
    co-active senones, from sample mask trajectories [frames, out]."""
    m = np.asarray(masks) != 0
    counts = m.sum(axis=0)
    t = np.arange(m.shape[0], dtype=np.float64)[:, None]
    mean_t = (m * t).sum(axis=0) / np.maximum(counts, 1)
    key = np.where(counts > 0, mean_t, np.inf)
    return np.argsort(key, kind="stable").astype(np.int32)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def permute_output_layer(qnet: QuantizedNet, perm: np.ndarray) -> QuantizedNet:
    """New QuantizedNet whose output-layer columns are reordered by `perm`
    (length = true output dim; padding columns stay in place).  Posteriors
    of the permuted net satisfy p_new[:, i] == p_old[:, perm[i]].

    `qnet` is in the JAX layout (output weight [K, N]), as quantize_net and
    the checkpoints give it: permute before a Scorer pads the net and, on
    the cuda backend, transposes its weights into the kernels' layout.
    """
    perm = np.asarray(perm)
    out = qnet.output_dim
    if perm.shape != (out,) or sorted(perm.tolist()) != list(range(out)):
        raise ValueError(f"perm must be a permutation of range({out})")
    n_pad = qnet.weights[-1].shape[1]
    idx = torch.as_tensor(
        np.concatenate([perm, np.arange(out, n_pad)]).astype(np.int64),
        device=qnet.weights[-1].device,
    )
    return dataclasses.replace(
        qnet,
        weights=qnet.weights[:-1] + (qnet.weights[-1].index_select(1, idx),),
        colsum128=qnet.colsum128[:-1] + (qnet.colsum128[-1].index_select(0, idx),),
        biases=qnet.biases[:-1] + (qnet.biases[-1].index_select(0, idx),),
    )
