"""QuantizedNet checkpoints: the `.npz` format of fastdnn_tpu/quant/serialize.py.

The keys and their meaning are the JAX package's (format version 1), so a
checkpoint written by either package loads in the other, and
`qnet_from_arrays` carries a JAX net across as the very arrays
`fastdnn_tpu.save_qnet` writes: both packages then compute with identical
parameters.  int4 layers are stored as int8 values with a `bits_i = 4`
marker (an absent marker means int8); packed nets are never saved, since
packing is a runtime storage choice (EngineConfig.int4_packed).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .quantize import QuantizedNet

FORMAT_VERSION = 1


def qnet_arrays(qnet: QuantizedNet) -> dict:
    """The arrays `save_qnet` writes, by key."""
    if qnet.packed_int4:
        raise ValueError(
            "save the unpacked net: packed-nibble weights would persist as "
            "plain int8 and load with the wrong meaning (packing is a "
            "runtime storage choice, EngineConfig.int4_packed)"
        )
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
        arrays[f"bits_{i}"] = np.int32(qnet.hidden_bits if i < n - 1 else 8)
        arrays[f"colsum_{i}"] = qnet.colsum128[i].cpu().numpy()
        arrays[f"b_{i}"] = qnet.biases[i].cpu().numpy()
        arrays[f"inv_scale_{i}"] = qnet.inv_scales[i].cpu().numpy()
        arrays[f"mult_{i}"] = qnet.multipliers[i].cpu().numpy()
    return arrays


def _hidden_bits(arrays: Mapping[str, np.ndarray], n: int) -> int:
    """The hidden layers' common bit width from the `bits_i` markers; the
    output layer must be int8 (neither package writes anything else)."""
    bits = [int(arrays[f"bits_{i}"]) if f"bits_{i}" in arrays else 8 for i in range(n)]
    if any(b not in (8, 4) for b in bits) or bits[-1] != 8 or len(set(bits[:-1])) > 1:
        raise ValueError(
            f"unsupported bits markers {bits}: expected int8 or int4 hidden "
            "layers of one width and an int8 output layer"
        )
    return bits[0] if n > 1 else 8


def qnet_from_arrays(arrays: Mapping[str, np.ndarray]) -> QuantizedNet:
    """A QuantizedNet from exactly the arrays `save_qnet` writes (either
    package's), e.g. `{k: np.asarray(v) for k, v in np.load(path).items()}`."""
    version = int(arrays["format_version"])
    if version != FORMAT_VERSION:
        raise ValueError(f"unsupported qnet format version {version}")
    n = int(arrays["n_quantized_layers"])
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
        hidden_bits=_hidden_bits(arrays, n),
    )


def save_qnet(qnet: QuantizedNet, path) -> None:
    """Persist a QuantizedNet to `path` (.npz)."""
    arrays = qnet_arrays(qnet)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_qnet(path) -> QuantizedNet:
    """Load a QuantizedNet saved by either package's `save_qnet`."""
    with np.load(path) as z:
        return qnet_from_arrays({k: z[k] for k in z.files})


def load_quantized(path, cutoff: float = 3.0, hidden_bits: "int | None" = None):
    """Load either model artifact the CLIs accept: a `.npz` checkpoint
    (used as stored) or a reference-format binary float model (quantized
    with `cutoff`, int4 hidden trunk with hidden_bits=4).

    hidden_bits=None means "whatever the artifact stores" for a checkpoint
    and int8 for a float model; an explicit 4 or 8 must match a
    checkpoint's stored bits, or the load raises.  Returns (qnet, topology
    string for the banner)."""
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
        kind = "int4-trunk" if qnet.hidden_bits == 4 else "int8"
        if hidden_bits is not None and hidden_bits != qnet.hidden_bits:
            raise ValueError(
                f"hidden_bits={hidden_bits} requested but {path} is a pre-quantized "
                f"{kind} checkpoint (stored bits markers say {qnet.hidden_bits}); "
                "re-quantize from the float binary model to change the trunk width"
            )
        return qnet, f"{dims} ({kind} checkpoint)"
    from ..formats.binary import read_model
    from ..models.feedforward import from_raw
    from .quantize import quantize_net

    raw = read_model(path)
    return quantize_net(from_raw(raw), cutoff=cutoff, hidden_bits=hidden_bits or 8), raw.topology()
