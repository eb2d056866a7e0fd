"""fastdnn_tpu_torch — the PyTorch/CUDA port of fastdnn_tpu.

The int8 (and int4-trunk) acoustic scorer on an NVIDIA H100: the JAX package's modules,
names and data layouts in PyTorch, with its Pallas kernels rewritten by hand
in CUDA C++ for Hopper (csrc/, built by nvcc at first use).  The JAX
package stays the reference the port is tested against.

Quick start::

    import fastdnn_tpu_torch as fdt

    net = fdt.load_model("model.bin")              # reference binary format
    # or fdt.load_model_text("nnet.txt", "final.feature_transform")
    qnet = fdt.quantize_net(net, cutoff=3.0)       # int8, transform fused
    # hidden_bits=4: int4 trunk; EngineConfig(int4_packed=True) packs it
    scorer = fdt.Scorer(qnet, device="cuda")       # "cpu": plain versions
    posteriors = scorer.score(frames)              # [n, senones] numpy
    lazy = scorer.score_masked(frames, masks)      # masks [n, senones], nonzero = active
"""

from .config import EngineConfig
from .decoder import BeamDecoder, Lexicon, random_lexicon
from .engine.scorer import (
    LazyContext,
    Scorer,
    build_hidden_stack,
    hidden_forward,
    score_fn,
    score_masked_fn,
)
from .formats import kaldi_text
from .formats.binary import (
    RawNetwork,
    read_features,
    read_model,
    write_features,
    write_features_text,
    write_model,
)
from .models.feedforward import (
    FeedForwardNet,
    align,
    apply_transform,
    extend,
    forward,
    from_raw,
    fuse_transform,
    random_net,
    to_raw,
)
from .quant.quantize import (
    QuantizedNet,
    pack_int4_trunk,
    pad_qnet,
    quantize_layer,
    quantize_net,
)
from .quant.serialize import load_qnet, load_quantized, qnet_from_arrays, save_qnet

__version__ = "0.1.0"


def load_model(path) -> FeedForwardNet:
    """Load a reference-format binary model into a float net."""
    return from_raw(read_model(path))


def load_model_text(network_path, transform_path) -> FeedForwardNet:
    """Load a Kaldi nnet1 text model and its feature-transform file."""
    return from_raw(kaldi_text.load_network_text(network_path, transform_path))


__all__ = [
    "BeamDecoder",
    "EngineConfig",
    "FeedForwardNet",
    "LazyContext",
    "Lexicon",
    "QuantizedNet",
    "RawNetwork",
    "Scorer",
    "align",
    "apply_transform",
    "build_hidden_stack",
    "extend",
    "forward",
    "from_raw",
    "fuse_transform",
    "hidden_forward",
    "kaldi_text",
    "load_model",
    "load_model_text",
    "load_qnet",
    "load_quantized",
    "pack_int4_trunk",
    "pad_qnet",
    "qnet_from_arrays",
    "quantize_layer",
    "quantize_net",
    "random_lexicon",
    "random_net",
    "read_features",
    "read_model",
    "save_qnet",
    "score_fn",
    "score_masked_fn",
    "to_raw",
    "write_features",
    "write_features_text",
    "write_model",
]
