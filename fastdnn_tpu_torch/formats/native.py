"""ctypes bindings to the native IO library (native/fastdnn_io.cc), the
counterpart of fastdnn_tpu/formats/native.py.

The C++ reader parses the reference's big-endian model and feature files
(a byte swap over the whole file, where numpy converts through a copy) and
Kaldi text features.  formats/binary.py's `read_model` and `read_features`
call it for path arguments.

The port builds the library itself from the repository's source, at first
use: one `g++ -O3 -std=c++17 -fPIC -shared` into
`fastdnn_tpu_torch/_build/` (not committed), named by a hash of the source,
the flags, the compiler's version and the platform, so neither a stale
build nor one from another machine is ever loaded.  It never loads the JAX
package's build.  A failed build or load raises with the compiler's
output.  Where no compiler is found and the library is not loaded
already (`available`), formats/binary.py takes its numpy parsers and logs
one warning per process, as the JAX package does when its library is
missing; FASTDNN_NATIVE=0 (the JAX package's switch) asks for them
outright.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from .binary import RawLayer, RawNetwork

SOURCE = Path(__file__).resolve().parents[2] / "native" / "fastdnn_io.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib = None
_warned = False  # the missing compiler is logged once per process


def enabled() -> bool:
    """False when FASTDNN_NATIVE=0 asks for the numpy parsers."""
    return os.environ.get("FASTDNN_NATIVE", "1") != "0"


def available() -> bool:
    """True when the reader can be had: loaded already, or a compiler to
    build it.  Without either it logs one warning per process and returns
    False, and the caller takes the numpy parsers."""
    global _warned
    if _lib is not None:
        return True
    try:
        compiler()
    except RuntimeError as e:
        if not _warned:
            _warned = True
            logging.getLogger(__name__).warning("%s; using the numpy parsers", e)
        return False
    return True


def compiler() -> str:
    """$CXX, else g++ on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found: the native reader cannot be built; set FASTDNN_NATIVE=0 "
            "for the numpy parsers"
        )
    return cxx


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    if not SOURCE.is_file():
        raise RuntimeError(
            f"native reader source {SOURCE} not found; set FASTDNN_NATIVE=0 for the "
            "numpy parsers"
        )
    version = subprocess.run([compiler(), "--version"], capture_output=True, text=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for part in (version, platform.platform()):
        h.update(part.encode())
    h.update(SOURCE.read_bytes())
    return Path(build_dir) / f"libfastdnn_io_{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library unless one for this exact source, compiler and
    platform exists."""
    out = library_path(build_dir)
    if out.exists():
        return out
    cxx = compiler()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = Path(tmp) / out.name
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(lib), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native reader failed ({cxx}, rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The library, built on first call (into BUILD_DIR unless `build_dir`
    is given); later calls return the same one."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build(build_dir or BUILD_DIR))))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.fd_read_model.restype = ctypes.c_void_p
    lib.fd_read_model.argtypes = [ctypes.c_char_p]
    lib.fd_model_layer_count.restype = ctypes.c_int32
    lib.fd_model_layer_count.argtypes = [ctypes.c_void_p]
    for fn in ("fd_model_input_dim", "fd_model_output_dim"):
        getattr(lib, fn).restype = ctypes.c_int32
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for fn in ("fd_model_weights", "fd_model_bias"):
        getattr(lib, fn).restype = f32p
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for fn in ("fd_model_shift", "fd_model_scale"):
        getattr(lib, fn).restype = f32p
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.fd_model_free.restype = None
    lib.fd_model_free.argtypes = [ctypes.c_void_p]
    lib.fd_read_features.restype = ctypes.c_int32
    lib.fd_read_features.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(f32p),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.fd_write_features.restype = ctypes.c_int32
    lib.fd_write_features.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int32, ctypes.c_int32]
    lib.fd_buffer_free.restype = None
    lib.fd_buffer_free.argtypes = [f32p]
    lib.fd_read_features_text.restype = ctypes.c_void_p
    lib.fd_read_features_text.argtypes = [ctypes.c_char_p]
    lib.fd_ftext_count.restype = ctypes.c_int32
    lib.fd_ftext_count.argtypes = [ctypes.c_void_p]
    lib.fd_ftext_id.restype = ctypes.c_char_p
    lib.fd_ftext_id.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for fn in ("fd_ftext_frames", "fd_ftext_dim"):
        getattr(lib, fn).restype = ctypes.c_int32
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.fd_ftext_data.restype = f32p
    lib.fd_ftext_data.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.fd_ftext_free.restype = None
    lib.fd_ftext_free.argtypes = [ctypes.c_void_p]
    return lib


def _existing(path, what: str) -> bytes:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{what} not found: {path}")
    return os.fsencode(path)


def read_model(path) -> RawNetwork:
    """A reference-format (big-endian) model file."""
    lib = load()
    handle = lib.fd_read_model(_existing(path, "model file"))
    if not handle:
        raise ValueError(f"model file {path} is truncated or malformed")
    try:
        layers: List[RawLayer] = []
        for i in range(lib.fd_model_layer_count(handle)):
            in_dim = lib.fd_model_input_dim(handle, i)
            out_dim = lib.fd_model_output_dim(handle, i)
            w = np.ctypeslib.as_array(lib.fd_model_weights(handle, i), shape=(out_dim, in_dim))
            b = np.ctypeslib.as_array(lib.fd_model_bias(handle, i), shape=(out_dim,))
            layers.append(RawLayer(w.copy(), b.copy()))
        in0 = layers[0].input_dim
        shift = np.ctypeslib.as_array(lib.fd_model_shift(handle), shape=(in0,)).copy()
        scale = np.ctypeslib.as_array(lib.fd_model_scale(handle), shape=(in0,)).copy()
        return RawNetwork(layers, shift, scale)
    finally:
        lib.fd_model_free(handle)


_FEATURE_ERRORS = {
    1: "unreadable or shorter than its 8-byte header",
    2: "has a bad header or is truncated",
    3: "does not fit in memory",
}


def read_features(path) -> np.ndarray:
    """A reference-format (big-endian) feature matrix -> f32 [frames, dim]."""
    lib = load()
    data = ctypes.POINTER(ctypes.c_float)()
    frames, dim = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.fd_read_features(_existing(path, "feature file"), ctypes.byref(data),
                              ctypes.byref(frames), ctypes.byref(dim))
    if rc != 0:
        raise ValueError(f"feature file {path} {_FEATURE_ERRORS.get(rc, f'(code {rc})')}")
    try:
        if frames.value == 0:
            return np.zeros((0, dim.value), np.float32)
        return np.ctypeslib.as_array(data, shape=(frames.value, dim.value)).copy()
    finally:
        lib.fd_buffer_free(data)


def read_features_text(path) -> dict:
    """Kaldi text features -> {utterance id: f32 [frames, dim]}."""
    lib = load()
    handle = lib.fd_read_features_text(_existing(path, "text feature file"))
    if not handle:
        raise ValueError(f"failed to parse text feature file {path}")
    try:
        out = {}
        for i in range(lib.fd_ftext_count(handle)):
            n, d = lib.fd_ftext_frames(handle, i), lib.fd_ftext_dim(handle, i)
            mat = np.ctypeslib.as_array(lib.fd_ftext_data(handle, i), shape=(n, d)).copy()
            out[lib.fd_ftext_id(handle, i).decode()] = mat
        return out
    finally:
        lib.fd_ftext_free(handle)


def write_features(data: np.ndarray, path) -> None:
    """A feature matrix in the reference (big-endian) format."""
    lib = load()
    arr = np.ascontiguousarray(data, dtype=np.float32)
    if arr.ndim != 2:
        raise ValueError("features must be 2-D [frames, dim]")
    rc = lib.fd_write_features(os.fsencode(path),
                               arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               arr.shape[0], arr.shape[1])
    if rc != 0:
        raise ValueError(f"failed to write feature file {path} (code {rc})")
