"""Gathered (capacity-bounded) lazy output scoring, explicit opt-in
(config.lazy_mode="gathered"): the counterpart of fastdnn_tpu/engine/lazy.py.

The union of senones active in any frame of the batch becomes a
fixed-capacity index vector; the output layer runs only over those senones
and the results are scattered back into zero logits, so inactive senones
keep the reference's zero logit.  Posteriors equal the dense masked path's:
the gathered senones use the same integer math.

This is plain tensor code, as the JAX package's version is XLA with no
Pallas kernel: `index_select` and ops.matmul.int8_matmul (a library integer
product) are library calls.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import matmul as xops
from ..quant.quantize import QuantizedNet


def union_active_indices(masks: np.ndarray, capacity: int) -> Tuple[np.ndarray, int]:
    """Host-side: union of active senones across frames -> padded [capacity]
    int32 index vector (padded entries repeat index 0; they are masked out of
    the final logits anyway).  Returns (indices, true_count)."""
    union = np.flatnonzero(masks.any(axis=0))
    count = union.shape[0]
    if count > capacity:
        raise ValueError(f"active union {count} exceeds capacity {capacity}")
    idx = np.zeros(capacity, dtype=np.int32)
    idx[:count] = union
    return idx, count


def gathered_output_posteriors(
    net: QuantizedNet,
    acts_i8: torch.Tensor,
    masks: torch.Tensor,
    active_idx: torch.Tensor,
    *,
    out_dim: int,
    semantics: str = "reference",
    kernel_layout: bool = False,
) -> torch.Tensor:
    """Gathered output scoring -> f32 [B, out_dim].

    acts_i8:    [B, K] last-hidden activations (shifted int8)
    masks:      [B, out_dim] nonzero = active
    active_idx: [C] int union of active senone ids (capacity C)
    kernel_layout: the output weight is in the CUDA kernels' layout [N, K]
        (a Scorer on the cuda backend); otherwise the JAX layout [K, N].
    """
    idx = active_idx.long()
    w = net.weights[-1]
    if kernel_layout:
        # [N, K]: a senone is a row, so gathering senones selects rows
        w_g = w.index_select(0, idx).t()
    else:
        # [K, N]: a senone is a column
        w_g = w.index_select(1, idx)
    logits_c = xops.output_logits(
        acts_i8, w_g, net.colsum128[-1].index_select(0, idx), net.inv_scales[-1],
        net.biases[-1].index_select(0, idx),
    )  # [B, C]
    # scatter back into zero logits (the padded index 0 entries write the
    # same value as senone 0's own; inactive columns stay exactly 0.0)
    logits = torch.zeros((acts_i8.shape[0], out_dim), dtype=torch.float32, device=acts_i8.device)
    logits[:, idx] = logits_c
    return xops.masked_softmax(logits, masks != 0, semantics)
