"""Engine configuration of the PyTorch/CUDA port.

The constants are the reference's (see fastdnn_tpu/config.py:23-31); the
`EngineConfig` keeps only the knobs the port's scoring path reads, with the
JAX package's names, defaults and meaning: the registry switches
`autotuned` and `tuned_batch` among them (tuning.py; the registry fills in
`stack_hidden_max_frames`), and `input_precision`, which picks the input
layer's product (K9's 3xTF32 for "high" and "highest", its 1-pass bf16
variant for "default").  The TPU block sizes (the block-sparse kernel
skips at its own tile) and `interpret` have no counterpart here.
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

#: the values of EngineConfig.input_precision
INPUT_PRECISIONS = ("highest", "high", "default")


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
    #: the float input layer's product, the JAX package's knob of that name
    #: (the only product that is not int8).  "high" (the default) and
    #: "highest" run K9 (ops.kernels.input_layer), whose 3xTF32 product is
    #: within the spread of any f32 summation order, so the TPU's 6-pass
    #: "highest" could not be told apart from it at the sigmoid's counts;
    #: "default" runs its 1-pass bf16 variant
    #: (ops.kernels.input_layer_bf16): both operands rounded to bf16, f32
    #: sums, which can flip a few sigmoid counts.  Not a registry knob: it
    #: changes results, not a schedule.  Any other value raises when a
    #: Scorer is built.
    input_precision: Literal["highest", "high", "default"] = "high"
    #: frame counts are padded up to a multiple of this, which is also a
    #: multiple of every kernel's frame tile
    frame_bucket: int = 128
    #: consult the measured launch-knob registry (fastdnn_tpu_torch/tuned.json,
    #: written by cli/autotune --commit) at Scorer construction: knobs left
    #: at their defaults (tuning.TUNED_KEYS) are replaced by the recorded
    #: best for this (net topology, device kind); explicitly set knobs always
    #: win.  See tuning.py for the lookup policy.
    autotuned: bool = True
    #: typical per-call frame count, used ONLY as the registry-lookup hint:
    #: with several batches recorded for a (net, device kind), the entry
    #: with the nearest batch wins.  None = the largest-batch entry (the
    #: throughput regime the engine optimizes for); latency deployments
    #: scoring small fixed batches should set their batch here.
    tuned_batch: "int | None" = None
    #: batches of at most this many frames run the whole hidden trunk as one
    #: kernel (ops.kernels.hidden_stack); larger ones run one kernel per
    #: layer.  0 disables the stack.  A schedule only: either route gives
    #: bitwise the same activations, so the registry may set it (tuning.py).
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
