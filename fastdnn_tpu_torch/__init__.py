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

A TDNN-F chain net (TdnnfNet, e.g. random_tdnnf_net) quantizes the same way
and scores chunks with their context: scorer.score(chunks [C, L + T + R,
in]) -> [C, T / 3, out] (scorer.context = (L, R)).
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
from .engine.stream import StreamingScorer
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
    LowRank,
    align,
    apply_transform,
    extend,
    forward,
    from_raw,
    fuse_transform,
    random_lowrank_net,
    random_net,
    restructure,
    to_raw,
)
from .models.tdnnf import BatchNorm, TdnnfLayer, TdnnfNet, random_tdnnf_net
from .quant.quantize import (
    QuantizedNet,
    QuantizedTdnnf,
    pack_int4_trunk,
    pad_qnet,
    quantize_layer,
    quantize_net,
    quantize_tdnnf,
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
    "BatchNorm",
    "BeamDecoder",
    "EngineConfig",
    "FeedForwardNet",
    "LazyContext",
    "LowRank",
    "Lexicon",
    "QuantizedNet",
    "QuantizedTdnnf",
    "RawNetwork",
    "Scorer",
    "StreamingScorer",
    "TdnnfLayer",
    "TdnnfNet",
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
    "quantize_tdnnf",
    "random_lexicon",
    "random_lowrank_net",
    "random_net",
    "random_tdnnf_net",
    "read_features",
    "read_model",
    "restructure",
    "save_qnet",
    "score_fn",
    "score_masked_fn",
    "to_raw",
    "write_features",
    "write_features_text",
    "write_model",
]
