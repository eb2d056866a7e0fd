"""QuantizedNet checkpoints: the `.npz` format of fastdnn_tpu/quant/serialize.py.

The keys and their meaning are the JAX package's (format version 1), so a
checkpoint written by either package loads in the other, and
`qnet_from_arrays` carries a JAX net across as the very arrays
`fastdnn_tpu.save_qnet` writes: both packages then compute with identical
parameters.  Only int8 layers are ported; a checkpoint with an int4 trunk
is refused.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .quantize import QuantizedNet

FORMAT_VERSION = 1


def qnet_arrays(qnet: QuantizedNet) -> dict:
    """The arrays `save_qnet` writes, by key."""
    n = len(qnet.weights)
    arrays = {
        "format_version": np.int32(FORMAT_VERSION),
        "n_quantized_layers": np.int32(n),
        # -1 encodes "width is the true senone count" (no padding)
        "true_output_dim": np.int32(
            -1 if qnet.true_output_dim is None else qnet.true_output_dim
        ),
        "input_w": qnet.input_w.cpu().numpy(),
        "input_b": qnet.input_b.cpu().numpy(),
    }
    for i in range(n):
        arrays[f"w_{i}"] = qnet.weights[i].cpu().numpy()
        arrays[f"bits_{i}"] = np.int32(8)
        arrays[f"colsum_{i}"] = qnet.colsum128[i].cpu().numpy()
        arrays[f"b_{i}"] = qnet.biases[i].cpu().numpy()
        arrays[f"inv_scale_{i}"] = qnet.inv_scales[i].cpu().numpy()
        arrays[f"mult_{i}"] = qnet.multipliers[i].cpu().numpy()
    return arrays


def qnet_from_arrays(arrays: Mapping[str, np.ndarray]) -> QuantizedNet:
    """A QuantizedNet from exactly the arrays `save_qnet` writes (either
    package's), e.g. `{k: np.asarray(v) for k, v in np.load(path).items()}`."""
    version = int(arrays["format_version"])
    if version != FORMAT_VERSION:
        raise ValueError(f"unsupported qnet format version {version}")
    n = int(arrays["n_quantized_layers"])
    for i in range(n):
        if f"bits_{i}" in arrays and int(arrays[f"bits_{i}"]) != 8:
            raise ValueError(
                f"layer {i} is stored with {int(arrays[f'bits_{i}'])} bits; the "
                "port reads int8 checkpoints only"
            )
    true_out = None
    if "true_output_dim" in arrays and int(arrays["true_output_dim"]) >= 0:
        true_out = int(arrays["true_output_dim"])

    def t(key, dtype):
        return torch.as_tensor(np.array(arrays[key], dtype=dtype))

    return QuantizedNet(
        input_w=t("input_w", np.float32),
        input_b=t("input_b", np.float32),
        weights=tuple(t(f"w_{i}", np.int8) for i in range(n)),
        colsum128=tuple(t(f"colsum_{i}", np.int32) for i in range(n)),
        biases=tuple(t(f"b_{i}", np.float32) for i in range(n)),
        inv_scales=tuple(t(f"inv_scale_{i}", np.float32) for i in range(n)),
        multipliers=tuple(t(f"mult_{i}", np.float32) for i in range(n)),
        true_output_dim=true_out,
    )


def save_qnet(qnet: QuantizedNet, path) -> None:
    """Persist a QuantizedNet to `path` (.npz)."""
    with open(path, "wb") as f:
        np.savez(f, **qnet_arrays(qnet))


def load_qnet(path) -> QuantizedNet:
    """Load a QuantizedNet saved by either package's `save_qnet`."""
    with np.load(path) as z:
        return qnet_from_arrays({k: z[k] for k in z.files})


def load_quantized(path, cutoff: float = 3.0):
    """Load either model artifact the CLI accepts: a `.npz` checkpoint
    (used as stored) or a reference-format binary float model (quantized
    with `cutoff`).  Returns (qnet, topology string for the banner)."""
    if str(path).endswith(".npz"):
        if cutoff != 3.0:
            import warnings

            warnings.warn(
                f"cutoff={cutoff} has no effect on a pre-quantized .npz checkpoint; "
                "re-quantize from the float binary model to change it",
                stacklevel=2,
            )
        qnet = load_qnet(path)
        dims = "-".join(str(d) for d in [qnet.input_dim] + qnet.layer_dims())
        return qnet, f"{dims} (int8 checkpoint)"
    from ..formats.binary import read_model
    from ..models.feedforward import from_raw
    from .quantize import quantize_net

    raw = read_model(path)
    return quantize_net(from_raw(raw), cutoff=cutoff), raw.topology()
