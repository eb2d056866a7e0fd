"""Adapter from the engine's layer-step signatures to the CUDA kernels
(ops/kernels.py), as engine/pallas_backend.py is for the Pallas kernels.
The plain path (backend="torch") calls ops/matmul.py instead, with the same
signatures, so scorer.py stays backend-agnostic."""

from __future__ import annotations

import dataclasses

import torch

from ..ops import kernels
from ..ops import matmul as xops
from ..quant.quantize import QuantizedNet


def prepare(net: QuantizedNet, input_precision: str = "high") -> QuantizedNet:
    """The net with its int8 weights in the kernels' layout (transposed,
    [out, in], K contiguous: ops.kernels.kernel_layout; a packed int4
    layer [K/2, N] becomes [N, K/2]) and its input weight also as the input
    kernel's operand for `input_precision`
    (ops.kernels.input_layer_operand; input_w stays as it is).  Done once,
    when a Scorer loads the net; the layer steps below take weights so
    prepared.  The shape properties of the result (layer_dims,
    padded_output_dim) no longer read as for the JAX layout.  The output
    layer is checked here for lazy_output, which takes it once a frame
    (ops.kernels.check_lazy_output_layer)."""
    prepared = dataclasses.replace(
        net,
        weights=tuple(kernels.kernel_layout(w) for w in net.weights),
        input_operand=kernels.input_layer_operand(net.input_w, input_precision),
    )
    kernels.check_lazy_output_layer(prepared.weights[-1], prepared.colsum128[-1],
                                    prepared.biases[-1])
    return prepared


def input_layer_step(frames_f32: torch.Tensor, w_f32: torch.Tensor, b_f32: torch.Tensor,
                     operand: torch.Tensor, precision: str = "high"):
    """Float first layer -> shifted int8, in one launch: K9 for "high" and
    "highest", its bf16 variant for "default"; `operand` is the prepared
    net's input_operand, made for the same precision."""
    xops.check_input_precision(precision)
    if precision == "default":
        return kernels.input_layer_bf16(frames_f32, w_f32, operand, b_f32)
    return kernels.input_layer(frames_f32, w_f32, operand, b_f32)


def hidden_layer_step(acts_i8, w_t, colsum128_i32, inv_scale: float, bias_f32):
    return kernels.hidden_layer(acts_i8, w_t, colsum128_i32, inv_scale, bias_f32)


def hidden_layer_step_packed(acts_i8, w_t_packed, colsum128_i32, inv_scale: float, bias_f32):
    """One packed int4 hidden layer (weight [N, K/2] in the kernels'
    layout) in one K7 launch."""
    return kernels.hidden_layer_packed(acts_i8, w_t_packed, colsum128_i32, inv_scale, bias_f32)


def hidden_stack_step(acts_i8, hstack):
    """All hidden layers in one K3 launch; hstack as built by
    engine.scorer.build_hidden_stack."""
    w, colsum, inv_scales, bias = hstack
    return kernels.hidden_stack(acts_i8, w, colsum, inv_scales, bias)


def output_logits(acts_i8, w_t, colsum128_i32, inv_scale: float, bias_f32):
    """Output-layer logits f32 [B, N] in one K5 launch."""
    return kernels.output_logits(acts_i8, w_t, colsum128_i32, inv_scale, bias_f32)


def output_posteriors_resident(acts_i8, w_t, colsum128_i32, inv_scale: float, bias_f32,
                               masks=None, *, out_dim: int, semantics: str = "reference",
                               fast: bool = False):
    """Output layer + full (optionally masked) softmax in one K4 launch
    -> [B, out_dim], f32 or (fast) bf16."""
    return kernels.resident_softmax(
        acts_i8, w_t, colsum128_i32, inv_scale, bias_f32, masks, out_dim=out_dim,
        semantics=semantics, fast=fast,
    )


def output_posteriors_block_sparse(acts_i8, w_t, colsum128_i32, inv_scale: float, bias_f32,
                                   masks, *, out_dim: int, semantics: str = "reference",
                                   resident: bool = True):
    """Masked output + softmax skipping all-inactive tiles -> f32
    [B, out_dim] (no `fast` variant: the gain is skipped work): one K6
    launch, or with resident=False (an output layer too wide for K6) one
    skipping K8 launch and one normalize launch."""
    if resident:
        return kernels.resident_softmax_block_sparse(
            acts_i8, w_t, colsum128_i32, inv_scale, bias_f32, masks, out_dim=out_dim,
            semantics=semantics,
        )
    z, m, s = output_flash_stats_block_sparse(
        acts_i8, w_t, colsum128_i32, inv_scale, bias_f32, masks, valid_count=out_dim,
        semantics=semantics, capped_fill=False,
    )
    return kernels.normalize_stats(z, m, s, out_dim=out_dim)


def output_posteriors(acts_i8, w_t, colsum128_i32, inv_scale: float, bias_f32, masks=None, *,
                      out_dim: int, semantics: str = "reference", fast: bool = False):
    """Output layer + (optionally masked) softmax through the stats, for an
    output layer too wide for K4: one K8 launch, then one normalize launch,
    exp(z - m) / s -> [B, out_dim], f32 or (fast) bf16."""
    stats = kernels.flash_stats(acts_i8, w_t, colsum128_i32, inv_scale, bias_f32, masks,
                                valid_count=out_dim, semantics=semantics, fast=fast)
    return kernels.normalize_stats(*stats[:3], out_dim=out_dim,
                                   tile_max=stats[3] if fast else None)


def output_flash_stats(acts_i8, w_t, colsum128_i32, inv_scale: float, bias_f32, masks=None, *,
                       valid_count: int, semantics: str = "reference"):
    """Local logits and unnormalized softmax stats (z, m, s) in one K8
    launch: a tensor-parallel shard's half of the fused softmax
    (`valid_count` is the shard's real senone count)."""
    return kernels.flash_stats(acts_i8, w_t, colsum128_i32, inv_scale, bias_f32, masks,
                               valid_count=valid_count, semantics=semantics)


def output_flash_stats_block_sparse(acts_i8, w_t, colsum128_i32, inv_scale: float, bias_f32,
                                    masks, *, valid_count: int, semantics: str = "reference",
                                    capped_fill: bool = True):
    """output_flash_stats skipping all-inactive tiles, one K8 launch.  The
    tensor-parallel shards keep their full padded width, so skipped tiles
    store -1e30 beyond `valid_count` (capped_fill) by default."""
    return kernels.flash_stats_block_sparse(
        acts_i8, w_t, colsum128_i32, inv_scale, bias_f32, masks, valid_count=valid_count,
        semantics=semantics, capped_fill=capped_fill,
    )
