"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled by its own `nvcc` process, all started together,
and the objects are linked into one shared library with a plain C
interface, loaded with ctypes, so no PyTorch header is compiled.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-Xptxas", "-v",
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
        [_P, _P, _P, _P, ctypes.c_float, _P, *[ctypes.c_int] * 5, _P],
    ),
    "fdn_hidden_layer_smem_bytes": (ctypes.c_longlong, []),
    "fdn_input_layer": (ctypes.c_int, [_P, _P, _P, _P, *[ctypes.c_int] * 4, _P]),
    "fdn_input_layer_smem_bytes": (ctypes.c_longlong, []),
    "fdn_hidden_layer_packed": (
        ctypes.c_int,
        [_P, _P, _P, _P, ctypes.c_float, _P, *[ctypes.c_int] * 5, _P],
    ),
    "fdn_hidden_layer_packed_smem_bytes": (ctypes.c_longlong, []),
    "fdn_hidden_stack_wgmma": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _P, *[ctypes.c_int] * 5, _P],
    ),
    "fdn_hidden_stack_wgmma_smem_bytes": (ctypes.c_longlong, [ctypes.c_int]),
    "fdn_hidden_stack_wgmma_max_clusters": (ctypes.c_int, [ctypes.c_int] * 3),
    "fdn_resident_softmax_block_sparse": (
        ctypes.c_int,
        [_P, _P, _P, _P, ctypes.c_float, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    ),
    "fdn_resident_softmax_block_sparse_smem_bytes": (ctypes.c_longlong, [ctypes.c_int]),
    "fdn_resident_softmax_wgmma": (
        ctypes.c_int,
        [_P, _P, _P, _P, ctypes.c_float, _P, ctypes.c_int, _P, _P, *[ctypes.c_int] * 6, _P],
    ),
    "fdn_resident_softmax_wgmma_smem_bytes": (ctypes.c_longlong, [ctypes.c_int]),
    "fdn_resident_softmax_wgmma_max_clusters": (ctypes.c_int, [ctypes.c_int] * 2),
    "fdn_output_logits": (
        ctypes.c_int,
        [_P, _P, _P, _P, ctypes.c_float, _P, *[ctypes.c_int] * 5, _P],
    ),
    "fdn_output_logits_smem_bytes": (ctypes.c_longlong, []),
    "fdn_flash_stats": (
        ctypes.c_int,
        [_P, _P, _P, _P, ctypes.c_float, _P, *[ctypes.c_int] * 5, _P, _P, _P, _P,
         *[ctypes.c_int] * 4, _P],
    ),
    "fdn_flash_stats_smem_bytes": (ctypes.c_longlong, [ctypes.c_int]),
    "fdn_normalize_stats": (ctypes.c_int, [_P, _P, _P, _P, _P, *[ctypes.c_int] * 4, _P]),
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


def nvcc_command(nvcc: str, source: Path, obj: Path) -> list[str]:
    """Compile one source into an object file."""
    return [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(source)]


def link_command(nvcc: str, objects: list[Path], out: Path) -> list[str]:
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out), *map(str, objects)]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return BUILD_DIR / f"libfastdnn_kernels_{h.hexdigest()[:16]}.so"


def _run_all(commands: list[list[str]]) -> list[tuple[int, str]]:
    """Run the commands concurrently -> (return code, stdout + stderr) each."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in commands
    ]
    outputs = [p.communicate()[0] for p in procs]
    return [(p.returncode, text) for p, text in zip(procs, outputs)]


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists:
    one nvcc per source, all at once, then one link.  The compiler's report
    (registers, shared memory, spills) is kept beside the library as a .log
    file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        results = _run_all(
            [nvcc_command(nvcc, src, obj) for src, obj in zip(sources(), objects)]
        )
        lib = Path(tmp) / out.name
        if all(rc == 0 for rc, _ in results):
            results += _run_all([link_command(nvcc, objects, lib)])
        log = "".join(text for _, text in results)
        out.with_suffix(".log").write_text(log)
        failed = [rc for rc, _ in results if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
        os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing
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
