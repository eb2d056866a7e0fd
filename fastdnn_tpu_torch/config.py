"""Engine configuration of the PyTorch/CUDA port.

The constants are the reference's (see fastdnn_tpu/config.py:23-31); the
`EngineConfig` keeps only the knobs the port's scoring path reads, with the
JAX package's names, defaults and meaning.  The TPU block sizes (the
block-sparse kernel skips at its own tile), `input_precision`, `interpret`
and the tuning fields of the JAX package have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

WEIGHT_SCALE = 127.0
ACTIVATION_SCALE = 255.0
SIGMOID_LOOKUP_SIZE = 1280
SIGMOID_HALF_LOOKUP_SIZE = SIGMOID_LOOKUP_SIZE // 2
SIGMOID_RESOLUTION = 100.0  # LUT index = round(x * 100)

DEFAULT_CUTOFF = 3.0
DEFAULT_INPUT_ALIGNMENT = 4
DEFAULT_HIDDEN_ALIGNMENT = 16


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs for the scoring engine."""

    #: clamp |w| above this before per-layer linear quantization
    cutoff: float = DEFAULT_CUTOFF
    #: "auto": hand-written CUDA kernels for tensors on a GPU, their plain
    #: PyTorch versions for tensors on the CPU; "cuda": the kernels, and a
    #: CPU device is an error; "torch": the plain versions on any device
    #: (the reference the kernels are checked against).
    backend: Literal["auto", "cuda", "torch"] = "auto"
    #: frame counts are padded up to a multiple of this, which is also a
    #: multiple of every kernel's frame tile
    frame_bucket: int = 128
    #: batches of at most this many frames run the whole hidden trunk as one
    #: kernel (ops.kernels.hidden_stack); larger ones run one kernel per
    #: layer.  0 disables the stack.
    stack_hidden_max_frames: int = 8192
    #: output layer and softmax in one kernel (ops.kernels.resident_softmax)
    #: instead of the logits kernel (ops.kernels.output_logits) followed by
    #: a library softmax.  The frame-by-frame LazyContext always takes the
    #: logits kernel.
    fused_softmax: bool = True
    #: emit the fused path's posteriors as bfloat16 (host results are
    #: widened back to f32); off by default for bit-parity.
    fast_posteriors: bool = False
    #: store an int4 hidden trunk two nibbles per byte
    #: (quant.quantize.pack_int4_trunk, after padding) and run it one
    #: packed-layer kernel per layer (ops.kernels.hidden_layer_packed):
    #: half the weight bytes, bitwise the same activations.  Without it
    #: the int4 values ride as int8 through the int8 kernels.  The packed
    #: trunk never takes the hidden-stack kernel.  No effect on int8 nets.
    int4_packed: bool = False

    # Lazy / masked output -------------------------------------------------
    #: "reference" reproduces the reference softmax-over-zeros semantics for
    #: inactive senones (inactive logit 0, still in the denominator);
    #: "active_only" renormalizes over active senones (inactive posteriors
    #: 0, a frame with no active senone an all-zero row).
    lazy_semantics: Literal["reference", "active_only"] = "reference"
    #: masked-output strategy: "dense" runs the full output product and
    #: masks the logits; "gathered" computes only the union of active senone
    #: columns (engine.lazy); "block_sparse" skips all-inactive (64-frame x
    #: 128-senone) tiles inside the masked kernel
    #: (ops.kernels.resident_softmax_block_sparse; cuda backend with
    #: fused_softmax only).  "auto" resolves to dense, as in the JAX package.
    lazy_mode: Literal["auto", "dense", "gathered", "block_sparse"] = "auto"
    #: capacity (fraction of output nodes) of the gathered lazy product;
    #: unions above it raise (explicit "gathered" mode only).
    lazy_capacity: float = 0.6

    def resolve_backend(self, device) -> str:
        """The backend for weights on `device` ("cuda" or "torch")."""
        on_gpu = device.type == "cuda"
        if self.backend == "cuda" and not on_gpu:
            raise ValueError(f"backend='cuda' needs a CUDA device, got {device}")
        if self.backend == "torch":
            return "torch"
        return "cuda" if on_gpu else "torch"
