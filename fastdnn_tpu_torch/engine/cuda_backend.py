"""Adapter from the engine's layer-step signatures to the CUDA kernels
(ops/kernels.py), as engine/pallas_backend.py is for the Pallas kernels.
The plain path (backend="torch") calls ops/matmul.py instead, with the same
signatures, so scorer.py stays backend-agnostic."""

from __future__ import annotations

import dataclasses

import torch

from ..ops import kernels
from ..ops.matmul import matmul_f32
from ..quant.quantize import QuantizedNet


def prepare(net: QuantizedNet) -> QuantizedNet:
    """The net with its int8 weights in the kernels' layout (transposed,
    [out, in], K contiguous: ops.kernels.kernel_layout; a packed int4
    layer [K/2, N] becomes [N, K/2]).  Done once, when a
    Scorer loads the net; the layer steps below take weights so prepared.
    The shape properties of the result (layer_dims, padded_output_dim)
    no longer read as for the JAX layout."""
    return dataclasses.replace(
        net, weights=tuple(kernels.kernel_layout(w) for w in net.weights)
    )


def input_layer_step(frames_f32: torch.Tensor, w_f32: torch.Tensor, b_f32: torch.Tensor):
    """Float first layer (a library matmul, as XLA ran it for the JAX
    package) -> K1 epilogue -> shifted int8."""
    return kernels.bias_sigmoid_i8(matmul_f32(frames_f32, w_f32), b_f32)


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
                                   masks, *, out_dim: int, semantics: str = "reference"):
    """Masked output + softmax skipping all-inactive tiles, one K6 launch
    -> f32 [B, out_dim] (no `fast` variant: the gain is skipped work)."""
    return kernels.resident_softmax_block_sparse(
        acts_i8, w_t, colsum128_i32, inv_scale, bias_f32, masks, out_dim=out_dim,
        semantics=semantics,
    )
