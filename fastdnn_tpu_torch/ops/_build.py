"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

The sources are compiled by `nvcc` straight into one shared library with a
plain C interface, loaded with ctypes, so no PyTorch header is compiled.
The library lands in `fastdnn_tpu_torch/_build/` (not committed), named by
a hash of the sources and the flags, so a stale build is never loaded.
Nothing here runs at import time: a machine without nvcc can import the
package and use the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

#: sm_90a: the Hopper target with wgmma/setmaxnreg.  -fmad=false: no FMA
#: contraction anywhere (the epilogue must round like the XLA oracle).
#: No --use_fast_math: tanhf and expf stay the accurate libdevice versions,
#: and division and square root stay IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-Xptxas", "-v",
    "-shared",
    "-Xcompiler", "-fPIC",
)

# Pointers and the stream are c_void_p (ctypes would cut a Python int to
# 32 bits otherwise).  Every launching entry takes the CUDA device index
# before the stream: the library links its own CUDA runtime, whose current
# device is not PyTorch's.
_P = ctypes.c_void_p
_SIGNATURES = {
    "fdn_bias_sigmoid_i8": (
        ctypes.c_int, [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
    ),
    "fdn_hidden_layer": (
        ctypes.c_int,
        [_P, _P, _P, _P, ctypes.c_float, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, _P],
    ),
    "fdn_hidden_stack": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    ),
    "fdn_hidden_stack_smem_bytes": (ctypes.c_longlong, [ctypes.c_int]),
    "fdn_resident_softmax": (
        ctypes.c_int,
        [_P, _P, _P, _P, ctypes.c_float, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, _P],
    ),
    "fdn_resident_softmax_smem_bytes": (ctypes.c_longlong, [ctypes.c_int]),
}

_lock = threading.Lock()
_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels cannot be built; use backend='torch' or CPU tensors for the "
        "plain versions"
    )


def nvcc_command(nvcc: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, sources())]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return BUILD_DIR / f"libfastdnn_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists.
    The compiler's report (registers, shared memory, spills) is kept beside
    the library as a .log file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            nvcc_command(find_nvcc(), Path(tmp)), capture_output=True, text=True
        )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The built kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib
