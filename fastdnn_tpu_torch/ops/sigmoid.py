"""Quantized sigmoid: uint8 activations in [0, 255], in PyTorch.

The reference quantizes sigmoid outputs through a 1280-entry lookup table at
0.01 input resolution:

    k = round(x * 100)            (C round(): half away from zero)
    k <= -640 -> 0;  k >= 640 -> 255
    else      -> round(sigmoid(k / 100) * 255)

The closed forms below are that table, bit for bit (fastdnn_tpu/ops/
sigmoid.py explains the algebra).  Activations travel through the engine as
zero-point-shifted int8 (q - 128), so both product operands are int8.

These are the plain versions of the CUDA epilogue in csrc/common.cuh.  They
must round exactly as it does: `torch.round` rounds half to even and is
wrong here, so half-away rounding is `trunc(x * 100 + copysign(0.5, x))`;
every product and sum is a separate eager op, rounded on its own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ACTIVATION_SCALE, SIGMOID_HALF_LOOKUP_SIZE, SIGMOID_RESOLUTION

ZERO_POINT = 128  # uint8 activation zero point of the s8 x s8 product


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.trunc(x + torch.copysign(torch.full_like(x, 0.5), x))


def quantized_sigmoid_u8(x: torch.Tensor) -> torch.Tensor:
    """f32 -> quantized sigmoid counts in [0, 255], dtype uint8."""
    half = float(SIGMOID_HALF_LOOKUP_SIZE)
    kc = torch.clamp(_round_half_away(x * SIGMOID_RESOLUTION), -half, half)
    v = (ACTIVATION_SCALE / 2.0) + (ACTIVATION_SCALE / 2.0) * torch.tanh(
        kc * (0.5 / SIGMOID_RESOLUTION)
    )
    q = torch.floor(v + 0.5)  # v >= 0: half-up == half-away
    q = torch.where(kc == 513.0, 254.0, q)
    q = torch.where(kc == -513.0, 1.0, q)
    return q.to(torch.uint8)


def quantized_sigmoid_shifted_i8(x: torch.Tensor) -> torch.Tensor:
    """f32 -> (quantized sigmoid - 128) as int8, the engine's wire format."""
    k = _round_half_away(x * SIGMOID_RESOLUTION)
    s = torch.floor((ACTIVATION_SCALE / 2.0) * torch.tanh(k * (0.5 / SIGMOID_RESOLUTION)))
    s = torch.where(k == 513.0, 126.0, s)
    s = torch.where(k == -513.0, -127.0, s)
    return s.to(torch.int8)


def build_reference_lut() -> np.ndarray:
    """The reference's LUT, rebuilt in float64 like its C++ constructor.
    Test oracle only."""
    half = SIGMOID_HALF_LOOKUP_SIZE
    k = np.arange(-half, half, dtype=np.float64) / 100.0
    sig = 1.0 / (1.0 + np.exp(-k))
    return np.floor(sig * ACTIVATION_SCALE + 0.5).astype(np.uint8)


def reference_lut_lookup(x: np.ndarray) -> np.ndarray:
    """QuantizedSigmoid::get through the actual table.  Test oracle only."""
    lut = build_reference_lut()
    half = SIGMOID_HALF_LOOKUP_SIZE
    x = np.asarray(x, dtype=np.float32)
    k = (np.sign(x) * np.floor(np.abs(x) * 100.0 + 0.5)).astype(np.int64)
    out = np.zeros(x.shape, dtype=np.uint8)
    mid = (k > -half) & (k < half)
    out[mid] = lut[k[mid] + half]
    out[k >= half] = int(ACTIVATION_SCALE)
    return out
