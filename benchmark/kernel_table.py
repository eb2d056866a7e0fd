"""Which layer each device operation of a trace belongs to.

`kernel_of` and `by_kernel` are a frozen copy of the program's
cli/profile.py (the port's kernel names as the profiler's demangled
symbols show them), kept here so that a later change to the program cannot
move the yardstick.  LAYER_OF maps those names onto the benchmark's layers
(PERF.md, "Layers").  A device operation that is not one of the port's
kernels is a copy (the profiler's Memcpy / Memset rows) or a PyTorch op.

A kernel the built-in rules do not name is named by a data file,
kernels/<name>.json: {"symbol": "<a substring of the demangled symbol>",
"layer": "<the benchmark's layer>"}.  A new kernel is a new file; nothing
here changes.  A file may not take a built-in name, and no symbol may
match two files, nor a built-in rule and a file.
"""

from __future__ import annotations

import functools
import json
import re
from pathlib import Path
from typing import Optional

#: the kernel files' directory
KERNELS = Path(__file__).resolve().parent / "kernels"

#: the port's kernel names -> the benchmark's layer
LAYER_OF = {
    "input_layer": "input_layer",
    "input_layer_bf16": "input_layer",
    "bias_sigmoid_i8": "input_layer",
    "hidden_stack": "trunk",
    "hidden_layer": "trunk",
    "hidden_layer_packed": "trunk",
    "resident_softmax": "output_dense",
    "resident_softmax_block_sparse": "output_dense",
    "flash_stats": "output_dense",
    "flash_stats_block_sparse": "output_dense",
    "normalize_stats": "output_dense",
    "output_logits": "output_lazy",
}


def _template_flag(symbol: str, kernel: str, index: int) -> bool:
    """The `index`-th template argument of `kernel` in a demangled symbol,
    read as a bool."""
    m = re.search(re.escape(kernel) + r"<([^>]*)>", symbol)
    if m is None:
        return False
    args = [a.strip() for a in m.group(1).split(",")]
    return index < len(args) and args[index] in ("true", "1", "(bool)1")


@functools.lru_cache(maxsize=None)
def kernel_files(directory: Path) -> tuple:
    """The kernel files of `directory`, in name order: ((name, symbol,
    layer), ...).  Read once a directory."""
    files = []
    for path in sorted(Path(directory).glob("*.json")):
        if path.stem in LAYER_OF:
            raise ValueError(f"{path.name}: {path.stem!r} is a built-in kernel name")
        entry = json.loads(path.read_text())
        files.append((path.stem, entry["symbol"], entry["layer"]))
    return tuple(files)


def kernel_of(symbol: str) -> Optional[str]:
    """The port's name of a CUDA kernel as the profiler names it (its
    demangled symbol), or None for a kernel that is not the port's.
    K2 and K5 share one streamed-layer kernel (their epilogues tell them
    apart), K4 and K6 the resident softmax kernel (its SPARSE flag), K8 and
    its skipping variant the stats kernel (SKIP).  A symbol that no
    built-in rule names is looked up in the kernel files; one that a
    built-in rule and a file both match is an error, since its time would
    silently go to the built-in kernel's layer."""
    name = _built_in(symbol)
    found = [file for file, sub, _ in kernel_files(KERNELS) if sub in symbol]
    if name is not None and found:
        raise ValueError(f"{symbol!r} is named {name!r} by a built-in rule and matched by "
                         f"the kernel file of {', '.join(found)}")
    if len(found) > 1:
        raise ValueError(f"{symbol!r} is matched by the kernel files of {', '.join(found)}")
    if name is not None:
        return name
    return found[0] if found else None


def layer_of(name: str) -> str:
    """The benchmark's layer of a kernel that kernel_of named."""
    if name in LAYER_OF:
        return LAYER_OF[name]
    return {n: layer for n, _, layer in kernel_files(KERNELS)}[name]


def _built_in(symbol: str) -> Optional[str]:
    if "streamed_layer_kernel" in symbol:
        if "LogitsEpilogue" in symbol:
            return "output_logits"
        return "hidden_layer" if "SigmoidEpilogue" in symbol else None
    if "resident_softmax_wgmma_kernel" in symbol:
        sparse = _template_flag(symbol, "resident_softmax_wgmma_kernel", 1)
        return "resident_softmax_block_sparse" if sparse else "resident_softmax"
    if "flash_stats_kernel" in symbol:
        skip = _template_flag(symbol, "flash_stats_kernel", 2)
        return "flash_stats_block_sparse" if skip else "flash_stats"
    for name, kernel in (("input_layer", "input_layer_kernel"),
                         ("input_layer_bf16", "input_layer_bf16_kernel"),
                         ("bias_sigmoid_i8", "bias_sigmoid_kernel"),
                         ("hidden_stack", "hidden_stack_wgmma_kernel"),
                         ("hidden_layer_packed", "hidden_layer_packed_kernel"),
                         ("normalize_stats", "normalize_stats_kernel")):
        if kernel in symbol:
            return name
    return None


def by_kernel(device_rows) -> tuple[dict, dict]:
    """Profiler rows (symbol, time) -> ({port kernel name: time}, {other
    kernel's symbol: time})."""
    ours: dict = {}
    other: dict = {}
    for symbol, ms in device_rows:
        name = kernel_of(symbol)
        if name is None:
            other[symbol] = other.get(symbol, 0.0) + ms
        else:
            ours[name] = ours.get(name, 0.0) + ms
    return ours, other


def is_copy(symbol: str) -> bool:
    return symbol.startswith(("Memcpy", "Memset"))


def op_name(symbol: str) -> str:
    """A short name for a device operation: the port's kernel name, the
    copy's kind, or the PyTorch kernel's symbol cut to 96 characters."""
    name = kernel_of(symbol)
    if name is not None:
        return name
    return symbol if is_copy(symbol) else symbol[:96]
