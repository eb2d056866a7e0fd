"""Reference-compatible binary model / feature-matrix I/O (numpy).

The same formats as fastdnn_tpu/formats/binary.py: streams of big-endian
4-byte ints and floats, as Java's DataOutputStream writes them.

Model stream:
    int32 layer_count
    repeat layer_count times:
        int32 input_dim
        int32 output_dim
        f32 weights[output_dim][input_dim]   (row-major, node-major)
        f32 bias[output_dim]
    f32 shift[first_layer_input_dim]
    f32 scale[first_layer_input_dim]

Feature-matrix stream:
    int32 frame_count
    int32 dim
    f32 data[frame_count][dim]

Readers trust the header frame count (the reference writer emits one extra
trailing frame, which its own readers ignore too).

`read_model` and `read_features` parse a big-endian file given by path with
the native reader (formats/native.py, built from native/fastdnn_io.cc at
first use) unless FASTDNN_NATIVE=0, as the JAX package does; file objects
and little-endian files take the numpy parsers below.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass
from typing import BinaryIO, List, Union

import numpy as np

PathOrFile = Union[str, os.PathLike, BinaryIO]

_BE_I4 = np.dtype(">i4")
_BE_F4 = np.dtype(">f4")


@dataclass
class RawLayer:
    """One affine layer exactly as stored: weights [out, in] + bias [out]."""

    weights: np.ndarray  # float32 [output_dim, input_dim]
    bias: np.ndarray  # float32 [output_dim]

    @property
    def input_dim(self) -> int:
        return self.weights.shape[1]

    @property
    def output_dim(self) -> int:
        return self.weights.shape[0]


@dataclass
class RawNetwork:
    """A parsed model file: affine layers + input shift/scale vectors."""

    layers: List[RawLayer]
    shift: np.ndarray  # float32 [input_dim]
    scale: np.ndarray  # float32 [input_dim]

    @property
    def input_dim(self) -> int:
        return self.layers[0].input_dim

    @property
    def output_dim(self) -> int:
        return self.layers[-1].output_dim

    def topology(self) -> str:
        """Human-readable topology, e.g. '432-5x2048-8000'."""
        return (
            f"{self.input_dim}-{len(self.layers) - 2}x"
            f"{self.layers[0].output_dim}-{self.output_dim}"
        )


def _slurp(f: PathOrFile) -> bytes:
    if hasattr(f, "read"):
        return f.read()
    with open(f, "rb") as fh:
        return fh.read()


def _emit(data: bytes, f: PathOrFile) -> None:
    if hasattr(f, "write"):
        f.write(data)
    else:
        with open(f, "wb") as fh:
            fh.write(data)


def _native_path(f: PathOrFile, little_endian: bool) -> bool:
    """True when the native reader takes this input: a big-endian file by
    path, with FASTDNN_NATIVE not 0."""
    if hasattr(f, "read") or little_endian:
        return False
    from . import native

    return native.enabled()


def read_model(f: PathOrFile, *, little_endian: bool = False) -> RawNetwork:
    """Parse a reference-format binary model file."""
    if _native_path(f, little_endian):
        from . import native

        return native.read_model(f)
    buf = _slurp(f)
    i4 = np.dtype("<i4") if little_endian else _BE_I4
    f4 = np.dtype("<f4") if little_endian else _BE_F4
    pos = 0

    def ints(count: int) -> np.ndarray:
        nonlocal pos
        if pos + 4 * count > len(buf):
            raise ValueError(f"model file truncated at byte {pos}")
        v = np.frombuffer(buf, i4, count=count, offset=pos)
        pos += 4 * count
        return v

    def floats(count: int) -> np.ndarray:
        nonlocal pos
        if pos + 4 * count > len(buf):
            raise ValueError(f"model file truncated at byte {pos}")
        v = np.frombuffer(buf, f4, count=count, offset=pos).astype(np.float32)
        pos += 4 * count
        return v

    layer_count = int(ints(1)[0])
    if not 0 < layer_count < 10_000:
        raise ValueError(f"implausible layer count {layer_count}")
    layers: List[RawLayer] = []
    for _ in range(layer_count):
        input_dim, output_dim = (int(v) for v in ints(2))
        if input_dim <= 0 or output_dim <= 0:
            raise ValueError(f"bad layer dims {input_dim}x{output_dim}")
        w = floats(input_dim * output_dim).reshape(output_dim, input_dim)
        layers.append(RawLayer(w, floats(output_dim)))
    input_dim = layers[0].input_dim
    shift = floats(input_dim)
    scale = floats(input_dim)
    return RawNetwork(layers, shift, scale)


def write_model(net: RawNetwork, f: PathOrFile, *, little_endian: bool = False) -> None:
    """Write a RawNetwork in the reference binary model format."""
    i4 = np.dtype("<i4") if little_endian else _BE_I4
    f4 = np.dtype("<f4") if little_endian else _BE_F4
    out = io.BytesIO()
    out.write(np.array([len(net.layers)], i4).tobytes())
    for layer in net.layers:
        out.write(np.array([layer.input_dim, layer.output_dim], i4).tobytes())
        out.write(np.ascontiguousarray(layer.weights, dtype=np.float32).astype(f4).tobytes())
        out.write(np.ascontiguousarray(layer.bias, dtype=np.float32).astype(f4).tobytes())
    out.write(np.ascontiguousarray(net.shift, dtype=np.float32).astype(f4).tobytes())
    out.write(np.ascontiguousarray(net.scale, dtype=np.float32).astype(f4).tobytes())
    _emit(out.getvalue(), f)


def read_features(f: PathOrFile, *, little_endian: bool = False) -> np.ndarray:
    """Read a binary feature matrix -> float32 [frames, dim]."""
    if _native_path(f, little_endian):
        from . import native

        return native.read_features(f)
    buf = _slurp(f)
    i4, f4 = ("<i4", "<f4") if little_endian else (_BE_I4, _BE_F4)
    if len(buf) < 8:
        raise ValueError("feature file shorter than its 8-byte header")
    frames, dim = (int(v) for v in np.frombuffer(buf[:8], i4))
    if frames < 0 or dim <= 0:
        raise ValueError(f"bad feature header: {frames}x{dim}")
    need = 8 + 4 * frames * dim
    if len(buf) < need:
        raise ValueError(f"feature file truncated: need {need} bytes, have {len(buf)}")
    return np.frombuffer(buf[8:need], f4).astype(np.float32).reshape(frames, dim)


def write_features(
    data: np.ndarray, f: PathOrFile, max_frames: int = -1, *, little_endian: bool = False
) -> None:
    """Write a float32 [frames, dim] matrix in the reference binary format;
    `max_frames` caps the written frame count."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    if data.ndim != 2:
        raise ValueError("features must be 2-D [frames, dim]")
    frames = data.shape[0] if max_frames < 0 else min(max_frames, data.shape[0])
    i4, f4 = ("<i4", "<f4") if little_endian else (_BE_I4, _BE_F4)
    out = io.BytesIO()
    out.write(np.array([frames, data.shape[1]], i4).tobytes())
    out.write(data[:frames].astype(f4).tobytes())
    _emit(out.getvalue(), f)


def write_features_text(data: np.ndarray, f: PathOrFile) -> None:
    """Plain text dump: one frame per line, space-separated floats."""
    lines = "\n".join(" ".join(repr(float(v)) for v in row) for row in np.asarray(data))
    if hasattr(f, "write"):
        f.write(lines)  # text-mode file objects (sys.stdout, StringIO)
    else:
        with open(f, "w") as fh:
            fh.write(lines)
